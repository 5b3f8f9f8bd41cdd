"""Scalar reference implementations of the Smith-Waterman kernels.

These are the numerical contracts (bwa-mem 0.7.17 semantics) that the batched
TPU kernels in ops/ must reproduce bit-for-bit:

* ``sw_extend``  — seed extension with initial score h0, banding, z-dropoff
  and adaptive begin/end pruning. Contract of BandedPairWiseSW::scalarBandedSWA
  (reference: src/bandedSWA.cpp:116-238), itself bwa's ksw_extend2.
* ``sw_global``  — banded global alignment producing a CIGAR. Contract of
  ksw_global2 (reference: src/ksw.cpp), used for final CIGAR generation via
  bwa_gen_cigar2 (reference: src/bwa.cpp).
* ``sw_align``   — local alignment with XSTART semantics returning
  {score, qb, qe, tb, te, score2, te2}. Contract of ksw_align2
  (reference: src/ksw.cpp), used by mem_seed_sw chain-seed rescoring and
  paired-end mate rescue (kswv batch analog).

Implemented in plain numpy loops — correctness oracle and host fallback, not
a performance path.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ExtendResult:
    score: int
    qle: int
    tle: int
    gtle: int
    gscore: int
    max_off: int


def sw_extend(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    w: int, end_bonus: int, zdrop: int, h0: int,
) -> ExtendResult:
    qlen, tlen = len(query), len(target)
    m = mat.shape[0]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins

    # query profile
    qp = mat[:, query].astype(np.int64)  # [m, qlen]

    eh_h = np.zeros(qlen + 1, dtype=np.int64)
    eh_e = np.zeros(qlen + 1, dtype=np.int64)
    eh_h[0] = h0
    if qlen >= 1:
        eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and eh_h[j - 1] > e_ins:
            eh_h[j] = eh_h[j - 1] - e_ins
            j += 1

    # band clamp from maximum possible gap lengths
    mx = int(mat.max())
    max_ins = int((qlen * mx + end_bonus - o_ins) / e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int((qlen * mx + end_bonus - o_del) / e_del + 1.0)
    max_del = max(max_del, 1)
    w = min(w, max_del)

    mx_sc = h0
    max_i = max_j = -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        f = 0
        mrow = 0
        mj = -1
        q = qp[target[i]]
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            # eh_h[j] = H(i-1,j-1), eh_e[j] = E(i,j), f = F(i,j), h1 = H(i,j-1)
            M = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1
            M = M + q[j] if M else 0
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            if mrow <= h:
                mrow = h
                mj = j
            t = M - oe_del
            t = t if t > 0 else 0
            e -= e_del
            e = e if e > t else t
            eh_e[j] = e
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= e_ins
            f = f if f > t else t
        eh_h[end] = h1
        eh_e[end] = 0
        if end == qlen:
            if gscore <= h1:
                max_ie = i
                gscore = h1
        if mrow == 0:
            break
        if mrow > mx_sc:
            mx_sc, max_i, max_j = mrow, i, mj
            off = abs(mj - i)
            if off > max_off:
                max_off = off
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if mx_sc - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if mx_sc - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # adaptive pruning of the band (exact reference behavior)
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen

    return ExtendResult(
        score=int(mx_sc), qle=max_j + 1, tle=max_i + 1,
        gtle=max_ie + 1, gscore=int(gscore), max_off=int(max_off),
    )


def sw_global(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    w: int,
) -> tuple[int, list[tuple[int, int]]]:
    """Banded global alignment with CIGAR traceback (ksw_global2 semantics).

    Returns (score, cigar) with cigar ops (op, len), op 0/1/2 = M/I/D
    (I = insertion to the reference's query, consuming query bases).
    """
    qlen, tlen = len(query), len(target)
    if qlen == 0 or tlen == 0:
        return 0, []
    NEG_INF = -0x40000000
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    n_col = min(qlen, 2 * w + 1)

    # eh layout as in the reference: eh_h[j] = H(i-1,j-1), eh_e[j] = E(i,j)
    eh_h = np.full(qlen + 1, NEG_INF, dtype=np.int64)
    eh_e = np.full(qlen + 1, NEG_INF, dtype=np.int64)
    eh_h[0] = 0
    for j in range(1, min(qlen, w) + 1):
        eh_h[j] = -(o_ins + e_ins * j)
    # direction matrix: bits0-1 = H source (0 diag / 1 E / 2 F),
    # bit2 = E extended, bit5 = F extended (d |= 2<<4)
    z = np.zeros((tlen, n_col), dtype=np.uint8)
    for i in range(tlen):
        f = NEG_INF
        beg = max(0, i - w)
        end = min(qlen, i + w + 1)
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG_INF
        q = mat[target[i]]
        zi = z[i]
        for j in range(beg, end):
            # eh_h[j] = H(i-1,j-1), eh_e[j] = E(i,j), f = F(i,j), h1 = H(i,j-1)
            m = int(eh_h[j])
            e = int(eh_e[j])
            eh_h[j] = h1
            m += int(q[query[j]])
            d = 0 if m >= e else 1
            h = m if m >= e else e
            if h < f:
                d = 2
                h = f
            h1 = h
            t = m - oe_del
            e -= e_del
            if e > t:
                d |= 1 << 2
            else:
                e = t
            eh_e[j] = e
            t = m - oe_ins
            f -= e_ins
            if f > t:
                d |= 2 << 4
            else:
                f = t
            zi[j - beg] = d
        eh_h[end] = h1
        eh_e[end] = NEG_INF
    score = int(eh_h[qlen])

    # backtrack (reference state machine: which = z >> (which<<1) & 3)
    cigar: list[tuple[int, int]] = []

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))

    which = 0
    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    while i >= 0 and k >= 0:
        beg = max(0, i - w)
        which = (int(z[i][k - beg]) >> (which << 1)) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)
            i -= 1
        else:
            push(1, 1)
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return score, cigar


@dataclasses.dataclass
class AlignResult:
    score: int
    te: int
    qe: int
    score2: int
    te2: int
    tb: int
    qb: int


def sw_align(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    xtra_start: bool = True,
    min_sc: int | None = None,
) -> AlignResult:
    """Local SW with best/2nd-best scores and, with xtra_start, the start
    coordinates of the best alignment (ksw_align2 XSTART|XSUBO semantics,
    reference: src/ksw.cpp:236-383).

    Recurrences follow ksw: H = max(H_diag+S, E, F, 0); gap chains branch off
    H with 0-saturation. (We use the exact F fixpoint rather than the striped
    lazy-F approximation of E; identical except exotic I-adjacent-D cases.)
    score2/te2 = best row maximum outside te ± ceil(score/max_match), only
    counting rows whose max >= min_sc (the XSUBO threshold).
    """
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    min_sc = min_sc if min_sc is not None else 0
    h_prev = np.zeros(qlen + 1, dtype=np.int64)
    e_col = np.zeros(qlen + 1, dtype=np.int64)
    gmax, te = 0, -1
    hmax_row = np.zeros(qlen + 1, dtype=np.int64)
    row_best = np.zeros(max(tlen, 1), dtype=np.int64)
    for i in range(tlen):
        f = 0
        h_cur = np.zeros(qlen + 1, dtype=np.int64)
        q = mat[target[i]]
        for j in range(1, qlen + 1):
            M = h_prev[j - 1] + int(q[query[j - 1]])
            e = e_col[j]
            h = max(M, e, f)
            h_cur[j] = h
            e_col[j] = max(max(e - e_del, 0), max(h - oe_del, 0))
            f = max(max(f - e_ins, 0), max(h - oe_ins, 0))
        row_best[i] = h_cur.max()
        if row_best[i] > gmax:
            gmax = int(row_best[i])
            te = i
            hmax_row = h_cur.copy()
        h_prev = h_cur
    # qe: smallest column attaining the max in the te row
    bqe = -1
    if te >= 0:
        bqe = int(np.flatnonzero(hmax_row == gmax)[0]) - 1
    # second best outside the te window
    score2, te2 = 0, -1
    if te >= 0 and tlen:
        mx = int(mat.max())
        rad = (gmax + mx - 1) // mx
        for i in range(tlen):
            if (i < te - rad or i > te + rad) and row_best[i] >= min_sc and row_best[i] > score2:
                score2, te2 = int(row_best[i]), i
    if gmax == 0 or not xtra_start:
        return AlignResult(int(gmax), te, bqe, score2, te2, -1, -1)
    # find start by the reverse pass on the prefixes
    rev = sw_align(query[: bqe + 1][::-1], target[: te + 1][::-1], mat,
                   o_del, e_del, o_ins, e_ins, xtra_start=False)
    tb = te - rev.te
    qb = bqe - rev.qe
    return AlignResult(int(gmax), te, bqe, score2, te2, tb, qb)
