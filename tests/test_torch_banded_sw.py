"""The port's banded SW (bwameme_tpu_torch.ops.banded_sw) against the JAX
package on the same numpy-seeded inputs, with tolerance zero: every output
is int32 DP state, and the f32 band clamp is reproduced exactly.

On the CPU the port runs its plain PyTorch version (sw_core_torch); the
CUDA kernel is held to that version on the card by chip_smoke.py. The JAX
side runs its XLA kernel and its Pallas kernel in interpret mode, as the
JAX package's own CPU tests do.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bwameme_tpu.align.sw_scalar import sw_extend
from bwameme_tpu.index.packing import pack_words
from bwameme_tpu.ops import banded_sw as jbsw
from bwameme_tpu.ops.banded_sw_pallas import banded_sw_extend_batch_pallas
from bwameme_tpu.utils.config import MemOptions
from bwameme_tpu_torch.ops import banded_sw as tbsw
from bwameme_tpu_torch.ops import banded_sw_cuda, build

KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version works on small tensors: one intra-op thread is as
    fast, and does not oversubscribe cores that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, B, Q, T, qlen_lo=10, tlen_lo=10, ws_lo=3, ws_hi=60,
           edges=False, alphabet=5):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alphabet, (B, Q)).astype(np.int32)  # 5: N codes too
    t = rng.integers(0, alphabet, (B, T)).astype(np.int32)
    for b in range(0, B, 2):  # realistic extensions: noisy copies
        n = min(Q, T)
        t[b, :n] = q[b, :n]
        for _ in range(rng.integers(0, 8)):
            t[b, rng.integers(0, n)] = rng.integers(0, 4)
    qlen = rng.integers(qlen_lo, Q + 1, B).astype(np.int32)
    tlen = rng.integers(tlen_lo, T + 1, B).astype(np.int32)
    h0 = rng.integers(1, min(80, 2 * Q), B).astype(np.int32)
    ws = rng.integers(ws_lo, ws_hi, B).astype(np.int32)
    if edges:  # empty query, empty and one-row targets, h0 of 0, all-N
        qlen[0] = 0
        tlen[1] = 0
        tlen[2] = 1
        qlen[3] = 1
        h0[4] = 0
        q[5] = 4
    return q, t, qlen, tlen, h0, ws


def _port(arrays, mat, gaps, end_bonus, zdrop):
    ts = [torch.from_numpy(a) for a in arrays]
    out = tbsw.banded_sw_extend_batch(*ts, torch.from_numpy(mat), *gaps,
                                      end_bonus, zdrop)
    return {k: out[k].numpy() for k in KEYS}


def _jax(fn, arrays, mat, gaps, end_bonus, zdrop, **kw):
    out = fn(*[jnp.asarray(a) for a in arrays], jnp.asarray(mat), *gaps,
             end_bonus, zdrop, **kw)
    return {k: np.asarray(out[k]) for k in KEYS}


def _assert_equal(a, b):
    for k in KEYS:
        assert np.array_equal(a[k], b[k]), k


CASES = [
    # the cases of tests/test_banded_sw_pallas.py
    dict(seed=1, B=16, Q=100, T=200, zdrop=100),
    dict(seed=2, B=24, Q=64, T=128, zdrop=0),     # z-drop disabled
    dict(seed=3, B=9, Q=128, T=256, zdrop=25),    # aggressive z-drop
    # edges: empty and one-row targets, empty queries, band width 1
    dict(seed=4, B=20, Q=40, T=60, zdrop=100, tlen_lo=0, qlen_lo=0,
         edges=True),
    dict(seed=5, B=12, Q=30, T=2, zdrop=0, tlen_lo=0, edges=True),
    dict(seed=6, B=12, Q=50, T=80, zdrop=100, ws_lo=1, ws_hi=2),
    # non-unit gap extension: the f32 band clamp divides inexactly
    dict(seed=7, B=16, Q=90, T=150, zdrop=60, gaps=(5, 3, 7, 3)),
    # main-path shapes: 151 bp reads, band w and 2w
    dict(seed=8, B=8, Q=151, T=300, zdrop=100, ws_lo=100, ws_hi=101),
    # few letters, unit gap costs and a small z-drop: rows whose maximum
    # ties between cells, where the tie rule (largest j) decides the z-drop
    dict(seed=10, B=256, Q=12, T=16, zdrop=5, alphabet=3, ws_lo=1, ws_hi=8,
         qlen_lo=2, tlen_lo=2, ab=(1, 1), gaps=(1, 1, 1, 1)),
]


@pytest.mark.parametrize("case", CASES, ids=[f"case{c['seed']}"
                                             for c in CASES])
def test_sw_core_matches_xla_and_pallas(case):
    c = dict(case)
    a, b = c.pop("ab", (1, 4))
    opt = MemOptions(a=a, b=b)
    gaps = c.pop("gaps", (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins))
    zdrop = c.pop("zdrop")
    arrays = _pairs(c.pop("seed"), c.pop("B"), c.pop("Q"), c.pop("T"), **c)
    mat = opt.mat.astype(np.int32)
    port = _port(arrays, mat, gaps, 5, zdrop)
    _assert_equal(port, _jax(jbsw.banded_sw_extend_batch, arrays, mat, gaps,
                             5, zdrop))
    _assert_equal(port, _jax(banded_sw_extend_batch_pallas, arrays, mat,
                             gaps, 5, zdrop, interpret=True))


def test_sw_core_matches_scalar_contract():
    opt = MemOptions()
    mat = opt.mat.astype(np.int32)
    arrays = _pairs(11, 24, 80, 160, qlen_lo=1, tlen_lo=1)
    port = _port(arrays, mat, (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins),
                 opt.pen_clip5, opt.zdrop)
    q, t, qlen, tlen, h0, ws = arrays
    for b in range(len(qlen)):
        r = sw_extend(q[b, : qlen[b]], t[b, : tlen[b]], mat, opt.o_del,
                      opt.e_del, opt.o_ins, opt.e_ins, int(ws[b]),
                      opt.pen_clip5, opt.zdrop, int(h0[b]))
        assert [getattr(r, k) for k in KEYS] == [int(port[k][b])
                                                 for k in KEYS], b


def _coord_inputs(seed, n_jobs, n_pad):
    """A random text (as MemeIndex.text32 packs it), a read-code matrix
    with N codes, left/right job arrays and a per-alnreg h0 table; pad lanes
    carry the sentinel reg = Gp with zero lengths, as the JAX flat path
    pads them."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    text32 = np.concatenate([pack_words(text, pad_code=3),
                             np.full(12, 0xFFFFFFFF, np.uint32)])
    R, L = 32, 151
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.02] = 4
    G = n_jobs
    Gp = G + 4
    h0 = np.zeros(Gp, np.int32)
    h0[:G] = rng.integers(19, 60, G)
    P = n_jobs + n_pad
    jobs = np.zeros((7, P), np.int32)
    jobs[0] = Gp
    jobs[0, :n_jobs] = rng.permutation(G)  # one job per alnreg and side
    jobs[1, :n_jobs] = rng.integers(0, R, n_jobs)
    qs = rng.integers(0, L, n_jobs)
    jobs[2, :n_jobs] = qs
    jobs[3, :n_jobs] = rng.integers(0, L - qs + 1)
    jobs[4, :n_jobs] = rng.integers(0, len(text) - 400, n_jobs)
    jobs[5, :n_jobs] = rng.integers(0, 300, n_jobs)
    jobs[6, :n_jobs] = rng.choice([100, 200], n_jobs)
    return text32, codes, h0, jobs


@pytest.mark.parametrize("reverse", [True, False], ids=["left", "right"])
def test_extend_side_round_matches_jax(reverse):
    opt = MemOptions()
    text32, codes, h0, jobs = _coord_inputs(21 + reverse, 48, 16)
    N, Q, T = jobs.shape[1], 160, 304
    mat = opt.mat.astype(np.int32)
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    jx = np.asarray(jbsw.extend_side_round(
        jnp.asarray(text32), jnp.asarray(codes), jnp.asarray(mat),
        jnp.asarray(h0), jnp.asarray(jobs), *gaps, opt.pen_clip5, opt.zdrop,
        reverse=reverse, N=N, Q=Q, T=T))
    score_reg = torch.from_numpy(h0.copy())
    port = tbsw.extend_side_round(
        torch.from_numpy(text32.view(np.int32)), torch.from_numpy(codes),
        torch.from_numpy(mat), score_reg, torch.from_numpy(jobs), *gaps,
        opt.pen_clip5, opt.zdrop, reverse=reverse, write_scores=True)
    assert np.array_equal(port.numpy(), jx)
    # the left launch's score scatter, against the JAX package's
    want = np.asarray(jbsw.scatter_scores(jnp.asarray(h0),
                                          jnp.asarray(jobs[0]), jx[0]))
    assert np.array_equal(score_reg.numpy(), want)


@pytest.mark.parametrize("reverse", [True, False], ids=["left", "right"])
def test_decode_text_and_gather_query_match_jax(reverse):
    text32, codes, _h0, jobs = _coord_inputs(31, 40, 0)
    reg, row, qs, ql, ts, tl, _ws = jobs
    t32 = torch.from_numpy(text32.view(np.int32))
    got = tbsw.decode_text(t32, torch.from_numpy(ts), torch.from_numpy(tl),
                           reverse, 320)
    want = jbsw._decode_text(jnp.asarray(text32), jnp.asarray(ts),
                             jnp.asarray(tl), reverse, 320)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = tbsw.gather_query(torch.from_numpy(codes), torch.from_numpy(row),
                            torch.from_numpy(qs), torch.from_numpy(ql),
                            reverse, 160)
    want = jbsw._gather_query(jnp.asarray(codes), jnp.asarray(row),
                              jnp.asarray(qs), jnp.asarray(ql), reverse, 160)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_retry_select_matches_jax():
    rng = np.random.default_rng(41)
    n = 64
    r1 = {k: rng.integers(0, 120, n).astype(np.int32) for k in KEYS}
    r2 = {k: rng.integers(0, 120, n).astype(np.int32) for k in KEYS}
    prev = np.where(rng.random(n) < 0.5, r1["score"], -1).astype(np.int32)
    want = jbsw._retry_select({k: jnp.asarray(v) for k, v in r1.items()},
                              {k: jnp.asarray(v) for k, v in r2.items()},
                              jnp.int32(100), jnp.int32(200),
                              jnp.asarray(prev))
    got = tbsw.retry_select({k: torch.from_numpy(v) for k, v in r1.items()},
                            {k: torch.from_numpy(v) for k, v in r2.items()},
                            100, 200, torch.from_numpy(prev))
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel takes CUDA tensors only: a CPU tensor never reaches a
    launch (the dispatcher sends it to the plain version instead)."""
    x = torch.zeros((2, 4), dtype=torch.int32)
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        banded_sw_cuda.banded_sw_pairs(x, x, v, v, v, v,
                                       torch.zeros((5, 5), dtype=torch.int32),
                                       6, 1, 6, 1, 5, 100)
    with pytest.raises(ValueError, match="CUDA tensors"):
        banded_sw_cuda.banded_sw_coord(v, x.to(torch.uint8),
                                       torch.zeros((7, 2), dtype=torch.int32),
                                       v, torch.zeros((5, 5), dtype=torch.int32),
                                       6, 1, 6, 1, 5, 100, True, True)
    launches = banded_sw_cuda.stats.launches
    assert launches["banded_sw_pairs"] == launches["banded_sw_coord"] == 0


def test_build_command_targets_hopper_without_fast_math():
    for name, (source, _) in build.LIBRARIES.items():   # one nvcc each
        cmd = build.nvcc_command("nvcc", name, "lib.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
        src = build.source_path(source)
        assert cmd[-1] == src and src.endswith(".cu")
        assert src.startswith(build.PKG_DIR) and os.path.isfile(src)
    # the P-RMI prediction must not contract its multiply and add, in the
    # library of every mode's variants
    for m in (1, 2, 3, 4):
        cmd = build.nvcc_command("nvcc", f"seed_smem_m{m}", "lib.so")
        assert "-fmad=false" in cmd and f"-DSEED_MODE={m}" in cmd
