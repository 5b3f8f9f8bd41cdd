"""Batched full (unbanded) Smith-Waterman for paired-end mate rescue:
dispatch and plain version.

The port of bwameme_tpu/ops/sw_full.py (the kswv analog, reference:
src/kswv.cpp, src/ksw.cpp:113-349). Each public function takes tensors on
one device: CUDA tensors go to the hand-written kernel (ops/sw_full_cuda.py,
csrc/sw_full.cu), CPU tensors to the plain PyTorch version below, and any
other device raises. There is no fallback from the kernel to the plain
version.

``full_sw_batch`` is a line-for-line port of the JAX ``full_sw_batch``: the
whole batch advances one target row a step, and the in-row F chain is the
closed form of Farrar's lazy-F fixpoint, a ``torch.cummax`` over
t_ins + j*e_ins. Per job it returns the kswr_t contract {score, te, qe,
score2, te2}; ``sw_full_torch`` adds the reverse pass over the reversed
prefixes [0, qe] / [0, te] of the jobs with score > 0 for {tb, qb} (the
KSW_XSTART semantics of ksw_align2). The kernel takes its lengths at run
time, so the JAX package's shape buckets (its 64-row pad and power-of-two Q
and T) are not carried over.

Two forms of the same function: the pair form ships the query and target
codes (``sw_full``, ``align_batch``); the coordinate form reads the target
from the packed text already on the device by (start, length), so only the
mates' codes and the coordinates travel (``sw_full_coord``,
``align_coord``: the mate-rescue path).
"""

from __future__ import annotations

import numpy as np
import torch

from bwameme_tpu_torch.ops import sw_full_cuda
from bwameme_tpu_torch.ops.banded_sw import decode_text
from bwameme_tpu_torch.ops.sw_full_cuda import RESULT_ORDER
from bwameme_tpu_torch.utils.timer import tstage

NEG_BIG = -(1 << 28)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"full SW runs on CUDA or the CPU, not {x.device}")
    return False


def full_sw_batch(q_codes, t_codes, qlen, tlen, mat, min_sc,
                  o_del: int, e_del: int, o_ins: int, e_ins: int):
    """Plain forward pass (bwameme_tpu/ops/sw_full.py:full_sw_batch) on any
    device: q (B,Q) and t (B,T) int32 codes, (B,) int32 qlen, tlen and
    min_sc (the score2 threshold), mat (5,5) int32. Returns a dict of (B,)
    int32 score, te, qe, score2, te2."""
    dev = q_codes.device
    i32 = torch.int32
    B, Q = q_codes.shape
    T = t_codes.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    mat = mat.to(i32)
    jj = torch.arange(Q, dtype=i32, device=dev).expand(B, Q)
    qmask = jj < qlen[:, None]
    qp = mat[:, q_codes.clamp(0, 4).long()].permute(1, 0, 2)  # (B, 5, Q)
    t_codes = t_codes.clamp(0, 4).long()

    hprev = torch.zeros((B, Q), dtype=i32, device=dev)  # H(i-1, j)
    e = torch.zeros((B, Q), dtype=i32, device=dev)      # E(i, j)
    gmax = torch.zeros(B, dtype=i32, device=dev)
    te = torch.full((B,), -1, dtype=i32, device=dev)
    qe = te.clone()
    rowmax = torch.zeros((B, T), dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    neg_col = torch.full((B, 1), NEG_BIG, dtype=i32, device=dev)

    for i in range(T):
        active = i < tlen
        tci = t_codes[:, i]
        scores = torch.gather(qp, 1, tci[:, None, None].expand(B, 1, Q))[:, 0]
        hdiag = torch.cat([zero_col, hprev[:, :-1]], 1)
        M = hdiag + scores
        hpre = torch.where(qmask, torch.maximum(M, e).clamp(min=0), 0)
        # F fixpoint: f_{j+1} = max(f_j - e_ins, max(hpre_j - oe_ins, 0))
        t_ins = (hpre - oe_ins).clamp(min=0)
        u = torch.where(qmask, t_ins + jj * e_ins, NEG_BIG)
        cm = torch.cummax(u, dim=1).values
        cm_prev = torch.cat([neg_col, cm[:, :-1]], 1)
        f = torch.where(jj == 0, 0, (cm_prev - (jj - 1) * e_ins).clamp(min=0))
        H = torch.where(qmask, torch.maximum(hpre, f), 0)
        e_next = torch.maximum((e - e_del).clamp(min=0),
                               (H - oe_del).clamp(min=0))
        rmax = H.max(dim=1).values
        # qe: the smallest column attaining the row max (only taken on a new
        # gmax)
        is_rm = qmask & (H == rmax[:, None])
        first_col = torch.where(is_rm, jj, Q + 1).min(dim=1).values
        improved = active & (rmax > gmax)
        rowmax[:, i] = torch.where(active, rmax, 0)
        hprev = torch.where(active[:, None], H, hprev)
        e = torch.where(active[:, None], e_next, e)
        gmax = torch.where(improved, rmax, gmax)
        te = torch.where(improved, i, te)
        qe = torch.where(improved, first_col, qe)

    # score2/te2: best row max >= min_sc outside te +/- ceil(gmax/max_match)
    mx = int(mat.max())
    rad = torch.div(gmax + mx - 1, max(mx, 1), rounding_mode="floor")
    ii = torch.arange(T, dtype=i32, device=dev).expand(B, T)
    outside = (ii < (te - rad)[:, None]) | (ii > (te + rad)[:, None])
    valid = outside & (ii < tlen[:, None]) & (rowmax >= min_sc[:, None])
    cand = torch.where(valid, rowmax, 0)
    if T:
        score2 = cand.max(dim=1).values
        te2 = torch.where(score2 > 0, cand.argmax(dim=1).to(i32), -1)
    else:
        score2 = torch.zeros(B, dtype=i32, device=dev)
        te2 = torch.full((B,), -1, dtype=i32, device=dev)
    return dict(score=gmax, te=te, qe=qe, score2=score2, te2=te2)


def _reversed_prefix(x, n):
    """x[b, n_b - 1 - j] for j < n_b, else 0."""
    W = x.shape[1]
    jj = torch.arange(W, device=x.device)
    idx = (n.long()[:, None] - 1 - jj).clamp(min=0)
    return torch.where(jj < n[:, None], torch.gather(x, 1, idx), 0)


def sw_full_torch(q_codes, t_codes, qlen, tlen, mat, min_sc, o_del: int,
                  e_del: int, o_ins: int, e_ins: int,
                  with_start: bool = True):
    """Plain version of the kernel's pair form on any device: the forward
    pass and, with_start, the reverse pass. qlen and tlen are clamped to
    [0, Q] and [0, T]. Returns (7, B) int32, rows RESULT_ORDER; tb = qb = -1
    for jobs with score <= 0 or without with_start."""
    Q, T = q_codes.shape[1], t_codes.shape[1]
    qlen = qlen.to(torch.int32).clamp(0, Q)
    tlen = tlen.to(torch.int32).clamp(0, T)
    gaps = (o_del, e_del, o_ins, e_ins)
    fwd = full_sw_batch(q_codes, t_codes, qlen, tlen, mat, min_sc, *gaps)
    tb = torch.full_like(fwd["te"], -1)
    qb = tb.clone()
    if with_start and len(qlen):
        ok = fwd["score"] > 0
        nq = torch.where(ok, fwd["qe"] + 1, 0)
        nt = torch.where(ok, fwd["te"] + 1, 0)
        # the reversed prefixes, as wide as the longest of them
        Qr, Tr = max(int(nq.max()), 1), max(int(nt.max()), 1)
        rev = full_sw_batch(_reversed_prefix(q_codes[:, :Qr], nq),
                            _reversed_prefix(t_codes[:, :Tr], nt), nq, nt,
                            mat, min_sc, *gaps)
        tb = torch.where(ok, fwd["te"] - rev["te"], -1)
        qb = torch.where(ok, fwd["qe"] - rev["qe"], -1)
    return torch.stack([fwd["score"], fwd["te"], fwd["qe"], fwd["score2"],
                        fwd["te2"], tb, qb])


def sw_full_coord_torch(text32, q_codes, jobs, mat, min_sc, o_del: int,
                        e_del: int, o_ins: int, e_ins: int, T: int,
                        with_start: bool = True):
    """Plain version of the kernel's coordinate form: decode_text of each
    job's target, then sw_full_torch."""
    qlen, tstart, tlen = jobs.unbind(0)
    tlen = tlen.clamp(0, T)
    t = decode_text(text32, tstart, tlen, False, T)
    return sw_full_torch(q_codes.to(torch.int32), t, qlen, tlen, mat, min_sc,
                         o_del, e_del, o_ins, e_ins, with_start)


def sw_full(q_codes, t_codes, qlen, tlen, mat, min_sc, o_del: int,
            e_del: int, o_ins: int, e_ins: int, with_start: bool = True):
    """Pair form: q (B,Q) and t (B,T) int32 codes 0-4, (B,) int32 qlen, tlen
    and min_sc, mat (5,5) int32. Returns (7, B) int32, rows RESULT_ORDER."""
    fn = sw_full_cuda.sw_full_pairs if _on_cuda(q_codes) else sw_full_torch
    return fn(q_codes, t_codes, qlen, tlen, mat, min_sc, o_del, e_del, o_ins,
              e_ins, with_start)


def sw_full_coord(text32, q_codes, jobs, mat, min_sc, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, T: int, with_start: bool = True):
    """Coordinate form: text32 the int32 view of the packed text words (both
    strands), q (N,Q) uint8 codes, jobs (3,N) int32 rows qlen, tstart, tlen
    (the target is text[tstart : tstart + tlen], tlen clamped to [0, T]),
    (N,) int32 min_sc, mat (5,5) int32. Returns (7, N) int32, rows
    RESULT_ORDER."""
    fn = (sw_full_cuda.sw_full_coord if _on_cuda(jobs)
          else sw_full_coord_torch)
    return fn(text32, q_codes, jobs, mat, min_sc, o_del, e_del, o_ins, e_ins,
              T, with_start)


def _as_dicts(out) -> list[dict]:
    with tstage("pair.fetch"):
        rows = out.cpu().numpy()
    return [dict(zip(RESULT_ORDER, map(int, col))) for col in rows.T]


def _query_matrix(queries) -> tuple[np.ndarray, np.ndarray]:
    Q = max(1, max(len(x) for x in queries))
    q = np.zeros((len(queries), Q), np.uint8)
    for b, x in enumerate(queries):
        q[b, : len(x)] = np.minimum(x, 4)
    return q, np.array([len(x) for x in queries], np.int32)


def align_batch(pairs, mat, o_del, e_del, o_ins, e_ins, min_sc=0,
                with_start=True, device="cuda") -> list[dict]:
    """Host wrapper of the pair form: list of (query, target) code arrays ->
    list of dicts {score, te, qe, score2, te2, tb, qb} (ksw_align2
    contract), computed on ``device``."""
    B = len(pairs)
    if B == 0:
        return []
    q, qlen = _query_matrix([p[0] for p in pairs])
    tq, tlen = _query_matrix([p[1] for p in pairs])
    dev = torch.device(device)
    ts = [torch.from_numpy(a).to(dev) for a in (
        q.astype(np.int32), tq.astype(np.int32), qlen, tlen,
        np.full(B, min_sc, np.int32), np.asarray(mat, np.int32))]
    q_t, t_t, ql_t, tl_t, ms_t, mat_t = ts
    return _as_dicts(sw_full(q_t, t_t, ql_t, tl_t, mat_t, ms_t, o_del, e_del,
                             o_ins, e_ins, with_start))


def align_coord(text32, queries, tstarts, tlens, mat, o_del, e_del, o_ins,
                e_ins, min_sc=0, with_start=True) -> list[dict]:
    """Host wrapper of the coordinate form on text32's device: the job b is
    queries[b] against text[tstarts[b] : tstarts[b] + tlens[b]]. Returns
    what align_batch returns."""
    N = len(queries)
    if N == 0:
        return []
    dev = text32.device
    q, qlen = _query_matrix(queries)
    tlen = np.asarray(tlens, np.int32)
    jobs = np.stack([qlen, np.asarray(tstarts, np.int32), tlen])
    q_t, jobs_t, ms_t, mat_t = (torch.from_numpy(a).to(dev) for a in (
        q, jobs, np.full(N, min_sc, np.int32), np.asarray(mat, np.int32)))
    T = max(1, int(tlen.max()))
    return _as_dicts(sw_full_coord(text32, q_t, jobs_t, mat_t, ms_t, o_del,
                                   e_del, o_ins, e_ins, T, with_start))
