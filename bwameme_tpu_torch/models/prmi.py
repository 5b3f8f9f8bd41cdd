"""P-RMI: partitioned learned index over the suffix-array key space.

Replaces the reference's offline Rust trainer (reference: RMI/src/main.rs,
RMI/rmi_lib/) and its 3-layer ``pwl{B},linear,linear_spline`` model
(reference: build_rmis_dna.sh:119, src/LearnedIndex_seeding.cpp:74-210) with a
TPU-friendly design:

* layer 0: radix partition by the top ``bits`` key bits (same as the
  reference's ``pwl`` layer, rmi_lib/src/models/piecewiselinear.rs:23-28).
* layer 1: per-leaf monotone linear model over the *recentred* key
  (``key - leaf_base``), fitted by least squares. Recentring keeps the
  per-leaf prediction in small-magnitude float32 range so the TPU VPU can
  evaluate it exactly enough — the analog of the reference's float64
  {alpha,beta} records but without needing f64 emulation on device.
* guaranteed integer error bounds: the device search window
  ``[pred-err_lo, pred+err_hi]`` provably contains the lower-bound insertion
  index of *any* query key mapping to the leaf (monotone model + clamping to
  the leaf's index range + endpoint residuals + safety margin), replacing the
  reference's unbounded linear-walk fallback
  (src/LearnedIndex_seeding.cpp:2262-2350) with a fixed-iteration,
  TPU-schedulable search.

Training is a fully vectorized segment-reduction — runs in numpy/JAX in
seconds even for a human-genome SA (the reference's Rust trainer takes ~15
min single-threaded, README.md:75-77).
"""

from __future__ import annotations

import numpy as np


def train_prmi(idx, bits: int, margin: int = 2) -> None:
    """Fit the P-RMI over idx.key_hi/key_lo (sorted); fills idx.rmi_* fields."""
    from bwameme_tpu_torch.align.native import train_prmi_native

    nat = train_prmi_native(idx.key_hi, idx.key_lo, bits, margin)
    if nat is not None:
        # two-pass C++ trainer (same least-squares + guaranteed-window
        # semantics; f32 residuals round exactly like this module's numpy)
        leaf_start, alpha, beta, err_lo, err_hi = nat
        idx.rmi_bits = bits
        idx.rmi_alpha = alpha
        idx.rmi_beta = beta
        idx.rmi_err_lo = err_lo
        idx.rmi_err_hi = err_hi
        idx.rmi_leaf_start = leaf_start
        return
    key_hi = idx.key_hi
    key_lo = idx.key_lo
    n = len(key_hi)
    n_leaves = 1 << bits
    shift = np.uint32(32 - bits)
    leaf_of = (key_hi >> shift).astype(np.int64)

    # leaf boundaries in the sorted key array
    leaf_start = np.searchsorted(leaf_of, np.arange(n_leaves + 1), side="left")
    leaf_start = leaf_start.astype(np.int64)
    cnt = np.diff(leaf_start)

    # recentred keys: rel = (key_hi & mask)*2^32 + key_lo, computed exactly in f64
    mask = np.uint32((1 << (32 - bits)) - 1) if bits < 32 else np.uint32(0)
    rel = (key_hi & mask).astype(np.float64) * 4294967296.0 + key_lo.astype(np.float64)
    y = np.arange(n, dtype=np.float64) - leaf_start[leaf_of].astype(np.float64)

    # per-leaf least squares via segment sums
    ends = leaf_start[1:]
    starts = leaf_start[:-1]
    def segsum(v):
        c = np.concatenate([[0.0], np.cumsum(v)])
        return c[ends] - c[starts]

    s1 = cnt.astype(np.float64)
    sx = segsum(rel)
    sy = segsum(y)
    sxx = segsum(rel * rel)
    sxy = segsum(rel * y)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        var = sxx - sx * sx / np.maximum(s1, 1)
        cov = sxy - sx * sy / np.maximum(s1, 1)
        beta = np.where(var > 0, cov / np.maximum(var, 1e-300), 0.0)
        beta = np.maximum(beta, 0.0)  # monotone model: required for bound proof
        # degenerate leaves (keys equal to f64 resolution): an overflowed
        # slope would poison alpha with inf/NaN; a flat model is exact there
        beta = np.where(np.isfinite(beta), beta, 0.0)
        alpha = np.where(s1 > 0, (sy - beta * sx) / np.maximum(s1, 1), 0.0)
        alpha = np.where(np.isfinite(alpha), alpha, 0.0)

    alpha32 = alpha.astype(np.float32)
    beta32 = beta.astype(np.float32)
    _finalize_model(idx, bits, leaf_start, alpha32, beta32, margin)


def _finalize_model(idx, bits: int, leaf_start: np.ndarray,
                    alpha32: np.ndarray, beta32: np.ndarray,
                    margin: int) -> None:
    """Compute guaranteed per-leaf error bounds for the given f32 leaf
    models — evaluated with the exact f32 arithmetic the device uses — and
    install the model on idx. Shared by the trainer and the reference
    _PARAMETERS importer."""
    key_hi = idx.key_hi
    key_lo = idx.key_lo
    n = len(key_hi)
    n_leaves = 1 << bits
    shift = np.uint32(32 - bits)
    mask = np.uint32((1 << (32 - bits)) - 1) if bits < 32 else np.uint32(0)
    leaf_of = (key_hi >> shift).astype(np.int64)
    cnt = np.diff(leaf_start)

    # residual bounds, evaluated with the same f32 arithmetic the device uses
    rel32 = (key_hi & mask).astype(np.float32) * np.float32(4294967296.0) + key_lo.astype(np.float32)
    predf = alpha32[leaf_of] + beta32[leaf_of] * rel32
    cnt_f = cnt.astype(np.float32)
    predf = np.clip(predf, 0.0, cnt_f[leaf_of])
    pred_i = leaf_start[leaf_of] + predf.astype(np.int64)

    i_arr = np.arange(n, dtype=np.int64)
    over = pred_i - i_arr   # how far prediction overshoots the true index
    under = i_arr - pred_i

    # segment maxima: leaf_of is sorted (keys are sorted), so the nonempty
    # leaves' segments tile the array — maximum.reduceat over their starts
    # (np.maximum.at is ~50x slower)
    err_lo = np.zeros(n_leaves, dtype=np.int64)
    err_hi = np.zeros(n_leaves, dtype=np.int64)
    ne = np.flatnonzero(cnt > 0)
    if len(ne):
        err_lo[ne] = np.maximum.reduceat(over, leaf_start[ne])
        err_hi[ne] = np.maximum.reduceat(under, leaf_start[ne])
    err_lo = np.maximum(err_lo, 0) + margin
    err_hi = np.maximum(err_hi, 0) + 1 + margin

    idx.rmi_bits = bits
    idx.rmi_alpha = alpha32
    idx.rmi_beta = beta32
    idx.rmi_err_lo = err_lo.astype(np.int32)
    idx.rmi_err_hi = err_hi.astype(np.int32)
    idx.rmi_leaf_start = leaf_start.astype(np.int64)


def write_rmi_parameters(idx, prefix: str, margin: int = 2) -> None:
    """Emit the Rust trainer's parameter files so the REFERENCE binary's
    `mem -7` path can consume our index (reference: learned_index_load,
    src/LearnedIndex_seeding.cpp:74-210; record layout codegen.rs:664-716).

    ``{prefix}.suffixarray_uint64_L2_PARAMETERS``: 2^bits records of
    24 bytes {f64 alpha, f64 beta, u64 err}, root selected by the top
    `bits` key bits (bit_shift = 64 - log2(num_models)). err encodes the
    window: bit63=0 (no partial-block escape — our model is exactly one
    linear per root leaf), bits62-32 = lower error, bits31-0 = upper error
    (decode at LearnedIndex_seeding.cpp:2145-2146). L1 is empty (no escape
    blocks); L0 is vestigial (never read by learned_index_load).

    alpha/beta are our recentred-f32 leaf models mapped to the absolute
    key domain; the error bounds are RE-VERIFIED under the reference's
    arithmetic (f64 fma over the raw key, FCLAMP truncation) over every
    training key, so the emitted windows are guaranteed for the consumer,
    not just translated.
    """
    bits = idx.rmi_bits
    n_leaves = 1 << bits
    ls = idx.rmi_leaf_start.astype(np.int64)
    cnt = np.diff(ls)
    n = int(idx.n_sa)

    leaf = np.arange(n_leaves, dtype=np.uint64)
    leaf_base = leaf.astype(np.float64) * float(1 << (64 - bits))
    beta_ref = idx.rmi_beta.astype(np.float64)
    alpha_ref = (idx.rmi_alpha.astype(np.float64) + ls[:-1]
                 - beta_ref * leaf_base)
    # empty leaves: constant prediction at the leaf's insertion point
    empty = cnt == 0
    alpha_ref[empty] = ls[:-1][empty].astype(np.float64)
    beta_ref[empty] = 0.0

    # reference-arithmetic residuals over all training keys:
    # fpred = fma(beta, (double)key, alpha); FCLAMP to [0, SA_NUM-1]
    key_hi = idx.key_hi
    key_lo = idx.key_lo
    keys_f = key_hi.astype(np.float64) * 4294967296.0 + key_lo.astype(np.float64)
    shift = np.uint32(32 - bits)
    leaf_of = (key_hi >> shift).astype(np.int64)
    pred = alpha_ref[leaf_of] + beta_ref[leaf_of] * keys_f
    pred_i = np.clip(pred, 0.0, float(n - 1)).astype(np.int64)
    i_arr = np.arange(n, dtype=np.int64)
    err_lo = np.zeros(n_leaves, dtype=np.int64)
    err_hi = np.zeros(n_leaves, dtype=np.int64)
    ne = np.flatnonzero(cnt > 0)
    if len(ne):
        err_lo[ne] = np.maximum.reduceat(pred_i - i_arr, ls[:-1][ne])
        err_hi[ne] = np.maximum.reduceat(i_arr - pred_i, ls[:-1][ne])
    # margin+1 absorbs fma-vs-two-roundings ULP drift and monotone
    # interpolation of unseen query keys between training keys
    err_lo = np.minimum(np.maximum(err_lo, 0) + margin + 1, 0x3FFFFFFF)
    err_hi = np.minimum(np.maximum(err_hi, 0) + margin + 1, 0x7FFFFFFF)
    enc = (err_lo.astype(np.uint64) << np.uint64(32)) | err_hi.astype(np.uint64)

    rec = np.empty((n_leaves, 3), dtype=np.uint64)
    rec[:, 0] = alpha_ref.view(np.uint64)
    rec[:, 1] = beta_ref.view(np.uint64)
    rec[:, 2] = enc
    base = prefix + ".suffixarray_uint64"
    rec.tofile(base + "_L2_PARAMETERS")
    open(base + "_L1_PARAMETERS", "wb").close()
    np.zeros(2, dtype=np.float64).tofile(base + "_L0_PARAMETERS")


def read_rmi_parameters(prefix: str) -> dict:
    """Parse ``_L{1,2}_PARAMETERS`` (see write_rmi_parameters). Returns
    {bits, alpha, beta, err (u64), l1_alpha, l1_beta, l1_err}."""
    base = prefix + ".suffixarray_uint64"
    l2 = np.fromfile(base + "_L2_PARAMETERS", dtype=np.uint64).reshape(-1, 3)
    num_model = len(l2)
    bits = int(num_model).bit_length() - 1
    assert (1 << bits) == num_model, f"L2 size {num_model} not a power of 2"
    try:
        l1 = np.fromfile(base + "_L1_PARAMETERS", dtype=np.uint64).reshape(-1, 3)
    except FileNotFoundError:
        l1 = np.empty((0, 3), dtype=np.uint64)
    return {
        "bits": bits,
        "alpha": l2[:, 0].copy().view(np.float64),
        "beta": l2[:, 1].copy().view(np.float64),
        "err": l2[:, 2].copy(),
        "l1_alpha": l1[:, 0].copy().view(np.float64),
        "l1_beta": l1[:, 1].copy().view(np.float64),
        "l1_err": l1[:, 2].copy(),
    }


def apply_rmi_parameters(idx, params: dict, margin: int = 2) -> None:
    """Install a reference-trained P-RMI (read_rmi_parameters) on idx —
    the no-retrain import path.

    Root linear models are converted exactly into our recentred-f32 layout
    (an affine change of origin per leaf). Leaves whose err word has bit63
    set escape to a partial second-layer block in the reference
    (LearnedIndex_seeding.cpp:186-210) — a piecewise shape our one-linear-
    per-leaf device layout cannot hold, so ONLY those leaves are refit by
    least squares over their keys. Error windows are then re-verified for
    every leaf under our device arithmetic (mandatory for the device
    search guarantee regardless of model provenance)."""
    bits = params["bits"]
    assert bits <= 32, f"root bits {bits} > 32 unsupported"
    key_hi = idx.key_hi
    key_lo = idx.key_lo
    n = len(key_hi)
    n_leaves = 1 << bits
    shift = np.uint32(32 - bits)
    leaf_of = (key_hi >> shift).astype(np.int64)
    leaf_start = np.searchsorted(
        leaf_of, np.arange(n_leaves + 1)).astype(np.int64)

    leaf = np.arange(n_leaves, dtype=np.uint64)
    leaf_base = leaf.astype(np.float64) * float(1 << (64 - bits))
    alpha_ref = params["alpha"]
    beta_ref = np.maximum(params["beta"], 0.0)  # monotone guarantee
    alpha32 = (alpha_ref + beta_ref * leaf_base
               - leaf_start[:-1]).astype(np.float32)
    beta32 = beta_ref.astype(np.float32)

    escape = np.flatnonzero((params["err"] >> np.uint64(63)) != 0)
    if len(escape) and n:
        mask = np.uint32((1 << (32 - bits)) - 1) if bits < 32 else np.uint32(0)
        for lf in escape:
            s, e = int(leaf_start[lf]), int(leaf_start[lf + 1])
            if e <= s:
                continue
            rel = ((key_hi[s:e] & mask).astype(np.float64) * 4294967296.0
                   + key_lo[s:e].astype(np.float64))
            y = np.arange(e - s, dtype=np.float64)
            var = rel.var()
            b = float((np.cov(rel, y, bias=True)[0, 1] / var)
                      if var > 0 else 0.0)
            b = max(b, 0.0)
            alpha32[lf] = np.float32(y.mean() - b * rel.mean())
            beta32[lf] = np.float32(b)

    _finalize_model(idx, bits, leaf_start, alpha32, beta32, margin)


def predict_np(idx, key_hi: np.ndarray, key_lo: np.ndarray):
    """Host-side reference of the device prediction: returns (lo, hi_excl)
    window guaranteed to contain lower_bound(key)."""
    bits = idx.rmi_bits
    shift = np.uint32(32 - bits)
    mask = np.uint32((1 << (32 - bits)) - 1) if bits < 32 else np.uint32(0)
    leaf = (key_hi >> shift).astype(np.int64)
    rel32 = (key_hi & mask).astype(np.float32) * np.float32(4294967296.0) + key_lo.astype(np.float32)
    ls = idx.rmi_leaf_start
    cnt = (ls[leaf + 1] - ls[leaf]).astype(np.float32)
    predf = np.clip(idx.rmi_alpha[leaf] + idx.rmi_beta[leaf] * rel32, 0.0, cnt)
    pred = ls[leaf] + predf.astype(np.int64)
    lo = np.maximum(pred - idx.rmi_err_lo[leaf], 0)
    hi = np.minimum(pred + idx.rmi_err_hi[leaf], idx.n_sa)
    return lo, hi
