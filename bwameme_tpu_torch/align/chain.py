"""Seed chaining and chain filtering.

Replicates the reference's B-tree insertion chaining and filters:
* mem_chain_Learned (reference: src/bwamem.cpp:1122-1228): SMEMs in
  (start,end)-sorted order, hits subsampled by stride to max_occ, each hit
  merged into the chain with the largest anchor pos <= rbeg via
  test_and_merge (src/bwamem.cpp:450-492), else a new chain; output in
  ascending anchor order (B-tree traversal).
* mem_chain_flt (src/bwamem.cpp:599-718): weight computation, overlap-based
  kept/shadow marking.
* mem_flt_chained_seeds (src/bwamem.cpp:565-597) with mem_seed_sw
  (src/bwamem.cpp:494-521): SW re-scoring of seeds in long chains.

Host implementation (python) — per-read work is tiny (tens of seeds); the
batched device path feeds these directly from the seeding engine's output.
"""

from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

from bwameme_tpu_torch.align.sw_scalar import sw_align
from bwameme_tpu_torch.seeding.host_engine import Smem

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


@dataclasses.dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int
    aln: int = -1


@dataclasses.dataclass
class Chain:
    pos: int
    seeds: list[Seed]
    rid: int
    is_alt: bool = False
    w: int = 0
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0


def cal_max_gap(opt, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w << 1)


def test_and_merge(opt, l_pac: int, c: Chain, s: Seed, seed_rid: int) -> bool:
    """reference: src/bwamem.cpp:450-492."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (
        s.qbeg >= c.seeds[0].qbeg and s.qbeg + s.len <= qend
        and s.rbeg >= c.seeds[0].rbeg and s.rbeg + s.len <= rend
    ):
        return True  # contained seed; do nothing
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and s.rbeg >= l_pac:
        return False  # different strand
    x = s.qbeg - last.qbeg
    y = s.rbeg - last.rbeg
    if (
        y >= 0 and x - y <= opt.w and y - x <= opt.w
        and x - last.len < opt.max_chain_gap and y - last.len < opt.max_chain_gap
    ):
        c.seeds.append(s)
        return True
    return False


def chain_seeds(opt, bns, l_query: int, smems: list[Smem], sa: np.ndarray) -> list[Chain]:
    """SMEMs (sorted by (start,end)) -> chains, reference order semantics."""
    if l_query < opt.min_seed_len:
        return []
    l_pac = bns.l_pac
    # frac_rep (reference: src/bwamem.cpp:1143-1151)
    l_rep = 0
    b = e = 0
    for p in smems:
        if p.hitcount <= opt.max_occ:
            continue
        sb, se = p.start, p.end
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b

    chains: list[Chain] = []   # kept sorted by pos
    keys: list[int] = []
    for p in smems:
        slen = p.end - p.start
        step = p.hitcount // opt.max_occ if p.hitcount > opt.max_occ else 1
        count = 0
        k = 0
        while k < p.hitcount and count < opt.max_occ:
            rbeg = int(sa[p.sa_lo + k])
            s = Seed(rbeg=rbeg, qbeg=p.start, len=slen, score=slen)
            rid = bns.intv2rid(rbeg, rbeg + slen)
            if rid >= 0:
                to_add = True
                if chains:
                    i = bisect.bisect_right(keys, rbeg) - 1
                    if i >= 0 and test_and_merge(opt, l_pac, chains[i], s, rid):
                        to_add = False
                if to_add:
                    c = Chain(pos=rbeg, seeds=[s], rid=rid,
                              is_alt=bool(getattr(bns.contigs[rid], "is_alt", False)))
                    j = bisect.bisect_right(keys, rbeg)
                    chains.insert(j, c)
                    keys.insert(j, rbeg)
            k += step
            count += 1
    for c in chains:
        c.frac_rep = l_rep / l_query
    return chains


def chain_and_filter_raw(opt, bns, queries: list[np.ndarray],
                         smems_per_read, sa: np.ndarray):
    """Native batched chaining, returning the FLAT arrays
    (chain_off, pos, rid, is_alt, w, kept, frac_rep, seed_off, seed_rbeg,
    seed_qbeg, seed_len, n_chains) — or None when the native kernel is
    unavailable/overflowed (callers use chain_and_filter_batch)."""
    from bwameme_tpu_torch.align import native
    from bwameme_tpu_torch.seeding.host_engine import FlatSmems

    R = len(queries)
    is_flat = isinstance(smems_per_read, FlatSmems)
    if is_flat:
        total = len(smems_per_read.start)
    else:
        counts = [len(s) for s in smems_per_read]
        total = sum(counts)
    out = None
    if native.available() and total:
        if is_flat:
            f = smems_per_read
            smem_off = np.ascontiguousarray(f.off, np.int32)
            st = np.ascontiguousarray(f.start, np.int32)
            en = np.ascontiguousarray(f.end, np.int32)
            lo = np.ascontiguousarray(f.sa_lo, np.int64)
            cn = np.ascontiguousarray(f.hitcount, np.int64)
        else:
            smem_off = np.zeros(R + 1, np.int32)
            np.cumsum(counts, out=smem_off[1:])
            st = np.empty(total, np.int32)
            en = np.empty(total, np.int32)
            lo = np.empty(total, np.int64)
            cn = np.empty(total, np.int64)
            k = 0
            for smems in smems_per_read:
                for s in smems:
                    st[k], en[k], lo[k], cn[k] = (s.start, s.end, s.sa_lo,
                                                  s.hitcount)
                    k += 1
        lq = np.asarray([len(q) for q in queries], np.int32)
        ctg_off = np.ascontiguousarray(
            [c.offset for c in bns.contigs], dtype=np.int64)
        ctg_alt = np.ascontiguousarray(
            [1 if getattr(c, "is_alt", False) else 0 for c in bns.contigs],
            dtype=np.uint8)
        sa64 = np.ascontiguousarray(sa, dtype=np.int64)
        out = native.chain_and_filter_native(
            opt, bns, lq, smem_off, st, en, lo, cn, sa64, ctg_off, ctg_alt)
    return out


def chain_and_filter_batch(opt, bns, queries: list[np.ndarray],
                           smems_per_read, sa: np.ndarray) -> list[list[Chain]]:
    """chain_seeds + filter_chains for a whole batch, through the native C++
    kernel (native/hostkernels.cpp:chain_and_filter_c) when available; the
    Python implementations above remain the documented contract and the
    fallback. Equivalent to the per-read sequence
    ``filter_chains(opt, chain_seeds(opt, bns, len(q), smems, sa))``."""
    from bwameme_tpu_torch.seeding.host_engine import FlatSmems

    R = len(queries)
    is_flat = isinstance(smems_per_read, FlatSmems)
    out = chain_and_filter_raw(opt, bns, queries, smems_per_read, sa)
    if out is None:
        lists = (smems_per_read.to_lists() if is_flat else smems_per_read)
        return [
            filter_chains(opt, chain_seeds(opt, bns, len(q), smems, sa))
            for q, smems in zip(queries, lists)
        ]
    (chain_off, chain_pos, chain_rid, chain_is_alt, chain_w, chain_kept,
     chain_frac_rep, seed_off, seed_rbeg, seed_qbeg, seed_len, _n) = out
    result: list[list[Chain]] = []
    for r in range(R):
        lst = []
        for ci in range(int(chain_off[r]), int(chain_off[r + 1])):
            s0, s1 = int(seed_off[ci]), int(seed_off[ci + 1])
            seeds = [
                Seed(rbeg=int(seed_rbeg[j]), qbeg=int(seed_qbeg[j]),
                     len=int(seed_len[j]), score=int(seed_len[j]))
                for j in range(s0, s1)
            ]
            lst.append(Chain(
                pos=int(chain_pos[ci]), seeds=seeds, rid=int(chain_rid[ci]),
                is_alt=bool(chain_is_alt[ci]), w=int(chain_w[ci]),
                kept=int(chain_kept[ci]),
                frac_rep=float(chain_frac_rep[ci]),
            ))
        result.append(lst)
    return result


def chain_weight(c: Chain) -> int:
    """reference: src/bwamem.cpp:523-541."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    return min(w, tmp)


def chn_beg(c: Chain) -> int:
    return c.seeds[0].qbeg


def chn_end(c: Chain) -> int:
    s = c.seeds[-1]
    return s.qbeg + s.len


def ks_introsort(a: list, lt) -> None:
    """Exact port of the reference's ks_introsort (src/ksort.h:185-235):
    median-of-3 quicksort partitioning (small segments left unsorted) plus
    a final insertion pass, with a combsort depth bomb. The algorithm is
    NOT stable — and the order of EQUAL elements is part of the output
    contract wherever the reference sorts with a non-unique key (the chain
    filter sorts by weight alone: equal-weight chains at different loci
    end up in partition-swap order, which decides which shadowed chain the
    `first` mechanism resurrects and therefore which secondary alignment
    is emitted). A stable sort here produces different — equally valid but
    not bit-identical — SAM on repeat ties."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return

    def insertsort(lo, hi):
        for i in range(lo + 1, hi):
            j = i
            while j > lo and lt(a[j], a[j - 1]):
                a[j], a[j - 1] = a[j - 1], a[j]
                j -= 1

    def combsort(lo, m):
        shrink = 1.2473309501039786540366528676643
        gap = m
        while True:
            if gap > 2:
                gap = int(gap / shrink)
                if gap in (9, 10):
                    gap = 11
            do_swap = False
            for i in range(lo, lo + m - gap):
                j = i + gap
                if lt(a[j], a[i]):
                    a[i], a[j] = a[j], a[i]
                    do_swap = True
            if not (do_swap or gap > 2):
                break
        if gap != 1:
            insertsort(lo, lo + m)

    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                combsort(s, t - s + 1)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                insertsort(0, n)
                return
            s, t, d = stack.pop()


def filter_chains(opt, chains: list[Chain]) -> list[Chain]:
    """mem_chain_flt for a single read (reference: src/bwamem.cpp:599-718)."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    # ks_introsort(mem_flt): (a).w > (b).w — tie order matters (see above)
    ks_introsort(a, lambda x, y: x.w > y.w)
    kept_idx = [0]
    a[0].kept = 3
    for i in range(1, len(a)):
        large_ovlp = False
        stop = False
        for j in kept_idx:
            b_max = max(chn_beg(a[j]), chn_beg(a[i]))
            e_min = min(chn_end(a[j]), chn_end(a[i]))
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = chn_end(a[i]) - chn_beg(a[i])
                lj = chn_end(a[j]) - chn_beg(a[j])
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (a[i].w < a[j].w * opt.drop_ratio
                            and a[j].w - a[i].w >= opt.min_seed_len << 1):
                        stop = True
                        break
        if not stop:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap on extended shadowed chains
    k = 0
    cut = len(a)
    for i, c in enumerate(a):
        if c.kept in (0, 3):
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i
            break
    for i in range(cut, len(a)):
        if a[i].kept < 3:
            a[i].kept = 0
    return [c for c in a if c.kept != 0]


def clamp_to_contig(bns, beg: int, mid: int, end: int) -> tuple[int, int, int]:
    """Clamp [beg,end) to the contig containing mid, on mid's strand
    (reference: src/bntseq.cpp bns_fetch_seq/bns_fetch_seq_v2)."""
    pos_f, is_rev = bns.depos(mid)
    rid = bns.pos2rid(pos_f)
    far_beg = bns.contigs[rid].offset
    far_end = far_beg + bns.contigs[rid].length
    if is_rev:
        far_beg, far_end = (
            (bns.l_pac << 1) - far_end,
            (bns.l_pac << 1) - far_beg,
        )
    return max(beg, far_beg), min(end, far_end), rid


def mem_seed_sw(opt, bns, text: np.ndarray, l_query: int, query: np.ndarray, s: Seed) -> int:
    """SW around a seed to re-score it (reference: src/bwamem.cpp:494-521)."""
    if s.len >= MEM_SHORT_LEN:
        return -1
    l_pac = bns.l_pac
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rb, re, _ = clamp_to_contig(bns, rb, mid, re)
    rseq = text[rb:re]
    res = sw_align(query[qb:qe], rseq, opt.mat, opt.o_del, opt.e_del,
                   opt.o_ins, opt.e_ins, xtra_start=False)
    return res.score


def filter_chained_seeds(opt, bns, text: np.ndarray, query: np.ndarray,
                         l_query: int, chains: list[Chain]) -> None:
    """mem_flt_chained_seeds (reference: src/bwamem.cpp:565-597)."""
    for c in chains:
        min_l = (MEM_HSP_COEF * opt.min_chain_weight
                 if opt.min_chain_weight else MEM_MINSC_COEF * math.log(l_query))
        min_hsp_score = int(opt.a * min_l + 0.499)
        if min_l > MEM_SEEDSW_COEF * l_query:
            continue
        kept = []
        for s in c.seeds:
            s.score = mem_seed_sw(opt, bns, text, l_query, query, s)
            if s.score < 0 or s.score >= min_hsp_score:
                if s.score < 0:
                    s.score = s.len * opt.a
                kept.append(s)
        c.seeds = kept
