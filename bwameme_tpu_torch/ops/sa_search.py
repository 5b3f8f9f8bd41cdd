"""Suffix-array search primitives of learned-index seeding: plain PyTorch.

Port of the mode-4 path of bwameme_tpu/ops/sa_search.py (``make_search_fns``)
as functions batched over queries. They are the plain versions of the
``__device__`` functions in csrc/seed_smem.cu: the CPU tests hold them
against the JAX package, and on the card the kernels are held against them.
The public functions at the end take the same arguments, in the same order,
as the functions ``make_search_fns`` returns.

* Patterns are 2-bit packed reads in uint32 words, 16 bases a word, most
  significant bits first, so unsigned word order is lexicographic base order.
  torch has no uint32 arithmetic: every packed word is widened to a
  non-negative int64 here (never compared as a signed int32), and ranks,
  positions and lengths are int64 too.
* ``prmi_window`` predicts a [lo, hi) window that is guaranteed to hold the
  lower bound; its one f32 step multiplies and adds with separate roundings,
  as the error windows of models/prmi.py assume.
* A compare reads one 16-byte rank row (text position + first 48 bases) and
  goes to the packed text only for ties of 48 bases or more.
* Loops end when no lane is active; a finished lane keeps its values, so the
  results equal the reference's fixed-round, lane-masked forms.
"""

from __future__ import annotations

import torch

from bwameme_tpu_torch.index.device import DeviceIndex, words_u32

FULL = 0xFFFFFFFF
I64 = torch.int64


def _combine(w0, w1, sh):
    """(w0 << sh) | (w1 >> (32 - sh)) on uint32 values held in int64; sh in
    0..30 (sh == 0 gives w0: w1 >> 32 is 0)."""
    return ((w0 << sh) & FULL) | (w1 >> (32 - sh))


def _high_mask(nbits):
    """Mask with the top ``nbits`` (clipped to 0..32) of 32 bits set."""
    nb = nbits.clamp(0, 32)
    return FULL ^ (FULL >> nb)


def keep_masks(l_bases):
    """(keep_hi, keep_lo): masks selecting the first l_bases of a 32-base
    (khi, klo) pattern."""
    b = (l_bases * 2).clamp(0, 64)
    return _high_mask(b), _high_mask(b - 32)


def _lcp_bases32(x):
    """Number of leading equal 2-bit bases encoded by a 32-bit xor (0..16)."""
    # frexp's exponent of a double is exact: msb = exponent - 1
    msb = torch.frexp(x.to(torch.float64)).exponent.to(I64) - 1
    return torch.where(x == 0, 16, (31 - msb) >> 1)


def prmi_window(di: DeviceIndex, khi, klo):
    """[lo, hi) rank window of a 32-base key from the P-RMI leaf model."""
    shift = 32 - di.bits
    n_leaf = di.params.shape[0]
    leaf = (khi >> shift).clamp(max=n_leaf - 1)
    rel = ((khi & ((1 << shift) - 1)).to(torch.float32) * 4294967296.0
           + klo.to(torch.float32))
    rec = di.params[leaf]                       # (L, 6) int32 storage
    ab = rec[:, 2:4].contiguous().view(torch.float32)
    alpha, beta = ab[:, 0], ab[:, 1]
    recw = words_u32(rec)
    ls, le, elo, ehi = recw[:, 0], recw[:, 1], recw[:, 4], recw[:, 5]
    # err_lo / err_hi are int32 in the reference
    elo = torch.where(elo >= 2**31, elo - 2**32, elo)
    ehi = torch.where(ehi >= 2**31, ehi - 2**32, ehi)
    cnt = (le - ls).to(torch.float32)
    prod = beta * rel                           # rounded before the add
    predf = torch.minimum(torch.clamp_min(alpha + prod, 0.0), cnt)
    pred = ls + predf.to(I64)
    return (pred - elo).clamp_min(0), (pred + ehi).clamp_max(di.n_sa)


def text64_at(di: DeviceIndex, pos):
    """64 text bases at position pos as 4 packed words; all ones past the
    end of the text (the guard words are all T as well)."""
    last = di.text32.shape[0] - 1
    base = pos >> 4
    w = [words_u32(di.text32[(base + j).clamp(0, last)]) for j in range(5)]
    sh = (pos & 15) * 2
    in_range = pos < di.n_sa
    return [torch.where(in_range, _combine(w[j], w[j + 1], sh), FULL)
            for j in range(4)]


def ctx_words(qbuf32) -> int:
    """Pattern words a ctx needs for a query buffer: 3 ride the rank row,
    then 4 for each 64-base text segment up to the buffer's read length."""
    bases = (qbuf32.shape[1] - 3) * 16
    return 3 + 4 * max(0, -(-(bases - 48) // 64))


def make_ctx_rk(qbuf32, row, pivot):
    """The pattern's 16-base words from base ``pivot`` of query row ``row``,
    never reading past the row's last word."""
    n_words = ctx_words(qbuf32)
    W = qbuf32.shape[1]
    flat = qbuf32.reshape(-1)
    base0 = row * W + (pivot >> 4).clamp(max=W - 1)
    last = (row + 1) * W - 1
    cols = [words_u32(flat[torch.minimum(base0 + k, last)])
            for k in range(n_words + 1)]
    sh = (pivot & 15) * 2
    return tuple(_combine(cols[k], cols[k + 1], sh) for k in range(n_words))


def _multiword_cmp(swords, kwords, total: int):
    """(less, lcp_bases) of suffix words against pattern words; lcp == total
    when all are equal."""
    lcp = torch.full_like(swords[0], total)
    less = torch.zeros_like(swords[0], dtype=torch.bool)
    found = torch.zeros_like(less)
    for i, (sw, kw) in enumerate(zip(swords, kwords)):
        x = sw ^ kw
        new = (x != 0) & ~found
        lcp = torch.where(new, 16 * i + _lcp_bases32(x), lcp)
        less = torch.where(new, sw < kw, less)
        found = found | (x != 0)
    return less, lcp


def cmp_ctx_rk(di: DeviceIndex, aw, v, sa_idx):
    """(less, lcp) of suffix rank sa_idx against the ctx pattern[:v]. A rank
    below 0 is less with lcp 0; one at n_sa or above is not less, lcp 0."""
    idx = sa_idx.clamp(0, di.n_sa - 1)
    r0 = words_u32(di.rk[idx])
    sa_pos = r0[:, 0]
    less, l48 = _multiword_cmp([r0[:, 1], r0[:, 2], r0[:, 3]], aw[:3], 48)
    vc = v.clamp(0, 48)
    diffb = l48 < vc
    lcp = torch.minimum(l48, vc)
    less = less & diffb
    resolved = diffb | (v <= 48)
    n_deep = (len(aw) - 3) // 4
    for k in range(n_deep):
        if bool(resolved.all()):
            break
        off = 48 + 64 * k
        dr = text64_at(di, sa_pos + off)
        lk, l64 = _multiword_cmp(dr, aw[3 + 4 * k: 7 + 4 * k], 64)
        rem = v - off
        vck = rem.clamp(0, 64)
        diffk = l64 < vck
        less = torch.where(resolved, less, lk & diffk)
        lcp = torch.where(resolved, lcp, off + torch.minimum(l64, vck))
        resolved = resolved | diffk | (rem <= 64)
    oob = (sa_idx < 0) | (sa_idx >= di.n_sa)
    lcp = torch.where(oob, 0, lcp)
    less = (less & ~oob) | (sa_idx < 0)
    return less, lcp


def lower_bound_ctx(di: DeviceIndex, ctx, v, wlo, whi, strict_greater=False):
    """First rank in [wlo, whi] whose suffix is >= pattern[:v] (> where
    strict_greater, a bool or a per-lane bool tensor)."""
    lo, hi = wlo.clone(), whi.clone()
    while bool((lo < hi).any()):
        mid = (lo + hi) >> 1
        less, lcp = cmp_ctx_rk(di, ctx, v, mid)
        pred = less | ((lcp >= v) & strict_greater)
        active = lo < hi
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def find_longest_ctx(di: DeviceIndex, ctx, v):
    """(mlen, ip): the longest match of pattern[:v] over the whole suffix
    array and its insertion point. The key is padded with ones past v."""
    keep_hi, keep_lo = keep_masks(v)
    khi_p = (ctx[0] & keep_hi) | (FULL ^ keep_hi)
    klo_p = (ctx[1] & keep_lo) | (FULL ^ keep_lo)
    wlo, whi = prmi_window(di, khi_p, klo_p)
    ip = lower_bound_ctx(di, ctx, v, wlo, whi)
    _, l0 = cmp_ctx_rk(di, ctx, v, ip - 1)
    _, l1 = cmp_ctx_rk(di, ctx, v, ip)
    return torch.maximum(l0, l1), ip


def interval_at_ctx(di: DeviceIndex, ctx, l):
    """(lb, count) of the suffix-array interval of pattern[:l]: the key is
    padded with zeros for the lower and with ones for the upper bound."""
    keep_hi, keep_lo = keep_masks(l)
    khi_a, klo_a = ctx[0] & keep_hi, ctx[1] & keep_lo
    khi_t, klo_t = khi_a | (FULL ^ keep_hi), klo_a | (FULL ^ keep_lo)
    lb = lower_bound_ctx(di, ctx, l, *prmi_window(di, khi_a, klo_a))
    ub = lower_bound_ctx(di, ctx, l, *prmi_window(di, khi_t, klo_t),
                         strict_greater=True)
    return lb, ub - lb


def sa_query_min1_ctx(di: DeviceIndex, ctx, v):
    mlen, _ = find_longest_ctx(di, ctx, v.clamp_min(1))
    mlen = torch.where(v <= 0, 0, mlen)
    lb, cnt = interval_at_ctx(di, ctx, mlen.clamp_min(1))
    lb = torch.where(mlen == 0, 0, lb)
    cnt = torch.where(mlen == 0, di.n_sa, cnt)
    return mlen, lb, cnt


def sa_query_ctx(di: DeviceIndex, ctx, v, min_intv):
    mlen, _ = find_longest_ctx(di, ctx, v.clamp_min(1))
    mlen = torch.where(v <= 0, 0, mlen)
    lb = torch.zeros_like(mlen)
    cnt = torch.zeros_like(mlen)
    done = torch.zeros_like(mlen, dtype=torch.bool)
    while not bool(done.all()):
        l_eff = mlen.clamp_min(1)
        lb2, cnt2 = interval_at_ctx(di, ctx, l_eff)
        lb2 = torch.where(mlen == 0, 0, lb2)
        cnt2 = torch.where(mlen == 0, di.n_sa, cnt2)
        sat = (cnt2 >= min_intv) | (mlen == 0)
        _, l0 = cmp_ctx_rk(di, ctx, l_eff, lb2 - 1)
        _, l1 = cmp_ctx_rk(di, ctx, l_eff, lb2 + cnt2)
        mlen = torch.where(done | sat, mlen, torch.maximum(l0, l1))
        lb = torch.where(done, lb, lb2)
        cnt = torch.where(done, cnt, cnt2)
        done = done | sat
    return mlen, lb, cnt


# ------------------------------------------------------------------ public
# The functions make_search_fns returns, index first, then the same arrays.


def rmi_window(di: DeviceIndex, khi, klo):
    return prmi_window(di, khi, klo)


def suffix_cmp(di: DeviceIndex, qbuf32, row, pivot, v, sa_idx):
    """(less, lcp) of suffix rank sa_idx against pattern[:v]."""
    return cmp_ctx_rk(di, make_ctx_rk(qbuf32, row, pivot), v, sa_idx)


def lcp_at(di: DeviceIndex, qbuf32, row, pivot, cap, sa_idx):
    """LCP of suffix rank sa_idx with pattern[:cap]."""
    return suffix_cmp(di, qbuf32, row, pivot, cap, sa_idx)[1]


def find_longest(di: DeviceIndex, qbuf32, row, pivot, v):
    return find_longest_ctx(di, make_ctx_rk(qbuf32, row, pivot), v)


def interval_at(di: DeviceIndex, qbuf32, row, pivot, l):
    return interval_at_ctx(di, make_ctx_rk(qbuf32, row, pivot), l)


def sa_query_min1(di: DeviceIndex, qbuf32, row, pivot, v):
    """sa_query at min_intv == 1: (mlen, lb, cnt) of the longest match of
    pattern[:v]; v <= 0 gives (0, 0, n_sa)."""
    return sa_query_min1_ctx(di, make_ctx_rk(qbuf32, row, pivot), v)


def sa_query(di: DeviceIndex, qbuf32, row, pivot, v, min_intv):
    """The widening fixed point: the longest l whose interval holds at least
    min_intv suffixes, as (l, lb, cnt); v <= 0 gives (0, 0, n_sa)."""
    return sa_query_ctx(di, make_ctx_rk(qbuf32, row, pivot), v, min_intv)
