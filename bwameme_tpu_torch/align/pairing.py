"""Paired-end layer: insert-size estimation, mate rescue, pair selection.

The port's copy of bwameme_tpu/align/pairing.py over the port's AlnReg; the
batched mate rescue (sam_pe_batch_rescue) runs the coordinate form of the
port's full-SW kernel against the packed text on the device.

Replicates src/bwamem_pair.cpp (file:line cites):
* mem_infer_dir / cal_sub         :58-79
* mem_pestat                      :81-149  (per-orientation percentile stats)
* mem_matesw                      :281-370 (SW mate rescue)
* mem_pair                        :372-436 (best-pair by score + insert-size
                                   log-likelihood, hash tie-break)
* mem_sam_pe                      :441-658 (full PE finalization)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from bwameme_tpu_torch.align.extend import AlnReg
from bwameme_tpu_torch.align.finalize import (
    aln2sam, hash_64, approx_mapq, mark_primary, reg2aln, reorder_primary5,
    sort_dedup_patch,
)
from bwameme_tpu_torch.align.sw_scalar import sw_align
from bwameme_tpu_torch.utils.config import (
    MEM_F_ALL, MEM_F_NOPAIRING, MEM_F_NO_RESCUE, MEM_F_PRIMARY5,
)

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


@dataclasses.dataclass
class PeStat:
    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """Orientation (FF=0, FR=1, RF=2, RR=3) + distance."""
    r1 = b1 >= l_pac
    r2 = b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def cal_sub(opt, regs: list[AlnReg]) -> int:
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def pestat_isize(opt, l_pac: int,
                 regs_pairs: list[list[AlnReg]]) -> list[list[int]]:
    """First half of mem_pestat: the per-orientation insert-size
    observations of a chunk (reference: src/bwamem_pair.cpp:88-115).
    Split out so a multi-process run can allgather each process's local
    observations over DCN and feed the union to pestat_from_isize —
    the stats are then chunk-global exactly as in the single-process
    reference (parallel/multihost.py)."""
    isize: list[list[int]] = [[], [], [], []]
    n = len(regs_pairs)
    for i in range(n >> 1):
        r0 = regs_pairs[i << 1]
        r1 = regs_pairs[i << 1 | 1]
        if not r0 or not r1:
            continue
        if cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    return isize


def pestat_from_isize(isize: list[list[int]]) -> list[PeStat]:
    """Second half of mem_pestat: percentile/σ stats per orientation
    (reference: src/bwamem_pair.cpp:116-149). Order-insensitive in the
    observations (sorts internally), so gathered multi-process lists give
    bit-identical stats to the single-process run."""
    pes = [PeStat() for _ in range(4)]
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        sel = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(sel) / len(sel)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in sel) / len(sel))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        r.low = max(r.low, 1)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


def pestat(opt, l_pac: int, regs_pairs: list[list[AlnReg]]) -> list[PeStat]:
    """Insert-size stats over a chunk; regs_pairs = per-read reg lists,
    interleaved R1,R2 (reference: mem_pestat)."""
    return pestat_from_isize(pestat_isize(opt, l_pac, regs_pairs))


def matesw(opt, bns, text: np.ndarray, pes: list[PeStat], a: AlnReg,
           mate_codes: np.ndarray, ma: list[AlnReg]) -> int:
    """SW rescue of the mate around alignment `a`
    (reference: mem_matesw)."""
    from bwameme_tpu_torch.align.chain import clamp_to_contig

    l_pac = bns.l_pac
    l_ms = len(mate_codes)
    skip = [p.failed for p in pes]
    for m in ma:
        r, dist = infer_dir(l_pac, a.rb, m.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(mate_codes < 4, 3 - mate_codes, mate_codes)[::-1]
        else:
            seq = mate_codes
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        if rb < re:
            rb, re, rid = clamp_to_contig(bns, rb, (rb + re) >> 1, re)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            ref = text[rb:re]
            aln = sw_align(np.minimum(seq, 4), ref, opt.mat, opt.o_del,
                           opt.e_del, opt.o_ins, opt.e_ins, xtra_start=True,
                           min_sc=opt.min_seed_len * opt.a)
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = AlnReg()
                b.rid = a.rid
                b.is_alt = a.is_alt
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = (l_pac << 1) - (rb + aln.te + 1) if is_rev else rb + aln.tb
                b.re = (l_pac << 1) - (rb + aln.tb) if is_rev else rb + aln.te + 1
                b.score = aln.score
                b.truesc = aln.score
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping score-descending order
                pos = len(ma)
                for i in range(len(ma)):
                    if ma[i].score < b.score:
                        pos = i
                        break
                ma.insert(pos, b)
            n += 1
        if n:
            ma[:] = sort_dedup_patch(opt, bns, None, None, ma)
    return n


def matesw_prepare(opt, bns, text, pes: list[PeStat], a: AlnReg,
                   mate_codes: np.ndarray, ma: list[AlnReg]):
    """Collect the SW problems mem_matesw would solve for anchor `a`
    (reference: mem_matesw_batch_pre, src/bwamem_pair.cpp:1060-1222).
    Returns a list of (seq, ref, meta) jobs; no device work."""
    from bwameme_tpu_torch.align.chain import clamp_to_contig

    l_pac = bns.l_pac
    l_ms = len(mate_codes)
    skip = [p.failed for p in pes]
    for m in ma:
        r, dist = infer_dir(l_pac, a.rb, m.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return []
    jobs = []
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(mate_codes < 4, 3 - mate_codes, mate_codes)[::-1]
        else:
            seq = mate_codes
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        if rb < re:
            rb, re, rid = clamp_to_contig(bns, rb, (rb + re) >> 1, re)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            ref = text[rb:re]
            jobs.append((np.minimum(seq, 4), ref,
                         dict(is_rev=is_rev, rb=rb, l_ms=l_ms, rid=a.rid,
                              is_alt=a.is_alt)))
    return jobs


def matesw_apply(opt, bns, meta, aln: dict, ma: list[AlnReg]) -> int:
    """Fold one batched-SW result back into the mate's region list
    (reference: mem_matesw_batch_post, src/bwamem_pair.cpp:1225-1487)."""
    l_pac = bns.l_pac
    is_rev, rb, l_ms = meta["is_rev"], meta["rb"], meta["l_ms"]
    if not (aln["score"] >= opt.min_seed_len and aln["qb"] >= 0):
        return 1
    b = AlnReg()
    b.rid = meta["rid"]
    b.is_alt = meta["is_alt"]
    b.qb = l_ms - (aln["qe"] + 1) if is_rev else aln["qb"]
    b.qe = l_ms - aln["qb"] if is_rev else aln["qe"] + 1
    b.rb = (l_pac << 1) - (rb + aln["te"] + 1) if is_rev else rb + aln["tb"]
    b.re = (l_pac << 1) - (rb + aln["tb"]) if is_rev else rb + aln["te"] + 1
    b.score = aln["score"]
    b.truesc = aln["score"]
    b.csub = aln["score2"]
    b.secondary = -1
    b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
    pos = len(ma)
    for i in range(len(ma)):
        if ma[i].score < b.score:
            pos = i
            break
    ma.insert(pos, b)
    return 1


def sam_pe_batch_rescue(opt, bns, text, pes: list[PeStat],
                        recs_pairs, regs_pairs, text32) -> None:
    """Chunk-wide batched mate rescue: collect every mem_matesw SW problem
    across all pairs, run ONE batched kswv-analog dispatch
    (ops/sw_full.align_coord: the targets read from text32, the packed text
    on the device that decides where the SW runs), fold results back, dedup
    touched lists (reference: mem_sam_pe_batch_pre/_batch/_post,
    src/bwamem_pair.cpp:660-858)."""
    from bwameme_tpu_torch.ops.sw_full import align_coord

    if opt.flag & MEM_F_NO_RESCUE:
        return
    jobs = []
    owners = []  # (target_list, meta)
    for (recs, a) in zip(recs_pairs, regs_pairs):
        for i in range(2):
            if not a[i]:
                continue
            best = a[i][0].score
            b = [r for r in a[i] if r.score >= best - opt.pen_unpaired]
            for j, br in enumerate(b):
                if j >= opt.max_matesw:
                    break
                for seq, ref, meta in matesw_prepare(
                        opt, bns, text, pes, br, recs[1 - i].codes, a[1 - i]):
                    jobs.append((seq, ref))
                    owners.append((a[1 - i], meta))
    if not jobs:
        return
    results = align_coord(text32, [seq for seq, _ in jobs],
                          [meta["rb"] for _, meta in owners],
                          [len(ref) for _, ref in jobs], opt.mat, opt.o_del,
                          opt.e_del, opt.o_ins, opt.e_ins,
                          min_sc=opt.min_seed_len * opt.a)
    touched = set()
    for (ma, meta), aln in zip(owners, results):
        matesw_apply(opt, bns, meta, aln, ma)
        touched.add(id(ma))
    for (recs, a) in zip(recs_pairs, regs_pairs):
        for i in range(2):
            if id(a[i]) in touched:
                a[i][:] = sort_dedup_patch(opt, bns, None, None, a[i])


def mem_pair(opt, bns, pes: list[PeStat], a: list[list[AlnReg]], pair_id: int,
             n_pri: list[int]):
    """Best proper pair selection (reference: mem_pair). Returns
    (score, sub, n_sub, z[2]) with score==0 when no pair found."""
    l_pac = bns.l_pac
    v = []
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            x_pos = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            key_x = (e.rid << 32) | int(x_pos - bns.contigs[e.rid].offset)
            key_y = (e.score << 32) | (i << 2) | (int(e.rb >= l_pac) << 1) | r
            v.append((key_x, key_y))
    v.sort()
    y = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in range(2):
            dirn = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dirn].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dirn].high:
                    break
                if dist < pes[dirn].low:
                    continue
                ns = (dist - pes[dirn].avg) / pes[dirn].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                        + 0.721 * math.log(2.0 * math.erfc(abs(ns) * (1 / math.sqrt(2))))
                        * opt.a + 0.499)
                q = max(q, 0)
                yv = (k << 32) | i
                u.append(((q << 32) | (hash_64((yv ^ (pair_id << 8)) & ((1 << 64) - 1)) & 0xFFFFFFFF), yv))
        y[v[i][1] & 3] = i
    z = [-1, -1]
    if not u:
        return 0, 0, 0, z
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xFFFFFFFF
    z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
    z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
    ret = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = sum(1 for e in u[:-1] if sub - (e[0] >> 32) <= tmp)
    return ret, sub, n_sub, z


def sam_pe(opt, bns, text: np.ndarray, pes: list[PeStat], pair_id: int,
           recs, regs2: list[list[AlnReg]], rg_id=None,
           skip_rescue: bool = False) -> tuple[str, str]:
    """Full PE finalization for one read pair (reference: mem_sam_pe).
    skip_rescue=True when mate rescue already ran batched across the chunk
    (sam_pe_batch_rescue)."""
    from bwameme_tpu_torch.align.finalize import reg2sam

    a = regs2
    n_aa = [[], []]
    if not skip_rescue and not (opt.flag & MEM_F_NO_RESCUE):
        for i in range(2):
            b = [r for r in a[i] if a[i] and r.score >= a[i][0].score - opt.pen_unpaired] if a[i] else []
            for j, br in enumerate(b):
                if j >= opt.max_matesw:
                    break
                matesw(opt, bns, text, pes, br, recs[1 - i].codes, a[1 - i])

    n_pri = [0, 0]
    for i in range(2):
        a[i] = mark_primary(opt, a[i], (pair_id << 1) | i)
        n_pri[i] = sum(1 for r in a[i] if not r.is_alt)
        if opt.flag & MEM_F_PRIMARY5:
            reorder_primary5(opt.T, a[i])

    extra_flag = 1
    lines = [None, None]
    if not (opt.flag & MEM_F_NOPAIRING) and n_pri[0] and n_pri[1]:
        o, subo, n_sub, z = mem_pair(opt, bns, pes, a, pair_id, n_pri)
        if o > 0:
            is_multi = [False, False]
            for i in range(2):
                for j in range(1, n_pri[i]):
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        is_multi[i] = True
                        break
            if not (is_multi[0] or is_multi[1]):
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                subo = max(subo, score_un)
                q_pe = raw_mapq(o - subo, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
                q_pe = min(max(q_pe, 0), 60)
                q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep + a[1][0].frac_rep)) + 0.499)
                q_se = [0, 0]
                if o > score_un:  # paired alignment preferred
                    c = [a[0][z[0]], a[1][z[1]]]
                    for i in range(2):
                        if c[i].secondary >= 0:
                            c[i].sub = a[i][c[i].secondary].score
                            c[i].secondary = -2
                        q_se[i] = approx_mapq(opt, c[i])
                    for i in range(2):
                        q_se[i] = q_se[i] if q_se[i] > q_pe else min(q_pe, q_se[i] + 40)
                        q_se[i] = min(q_se[i], raw_mapq(c[i].score - c[i].csub, opt.a))
                    extra_flag |= 2
                else:
                    z = [0, 0]
                    q_se = [approx_mapq(opt, a[0][0]), approx_mapq(opt, a[1][0])]
                for i in range(2):
                    k = a[i][z[i]].secondary_all
                    if 0 <= k < n_pri[i]:
                        for j in range(len(a[i])):
                            if a[i][j].secondary_all == k or j == k:
                                a[i][j].secondary_all = z[i]
                        a[i][z[i]].secondary_all = -1
                XA = [None, None]
                if not (opt.flag & MEM_F_ALL):
                    from bwameme_tpu_torch.align.alt import gen_alt

                    for i in range(2):
                        XA[i] = gen_alt(opt, bns, text, a[i],
                                        len(recs[i].codes), recs[i].codes)
                h = [None, None]
                aa = [[], []]
                for i in range(2):
                    h[i] = reg2aln(opt, bns, text, len(recs[i].codes),
                                   recs[i].codes, a[i][z[i]])
                    h[i].mapq = q_se[i]
                    h[i].flag |= (0x40 << i) | extra_flag
                    h[i].XA = XA[i][z[i]] if XA[i] else None
                    aa[i].append(h[i])
                    if n_pri[i] < len(a[i]):
                        p = a[i][n_pri[i]]
                        if p.score >= opt.T and p.secondary < 0 and p.is_alt:
                            g = reg2aln(opt, bns, text, len(recs[i].codes),
                                        recs[i].codes, p)
                            g.flag |= 0x800 | (0x40 << i) | extra_flag
                            g.XA = XA[i][n_pri[i]] if XA[i] else None
                            aa[i].append(g)
                l0 = [aln2sam(opt, bns, recs[0], len(aa[0]), aa[0], i2, h[1], rg_id)
                      for i2 in range(len(aa[0]))]
                l1 = [aln2sam(opt, bns, recs[1], len(aa[1]), aa[1], i2, h[0], rg_id)
                      for i2 in range(len(aa[1]))]
                return "\n".join(l0) + "\n", "\n".join(l1) + "\n"

    # no_pairing path
    h = [None, None]
    for i in range(2):
        which = -1
        if a[i]:
            if a[i][0].score >= opt.T:
                which = 0
            elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                which = n_pri[i]
        src = a[i][which] if which >= 0 else None
        h[i] = reg2aln(opt, bns, text, len(recs[i].codes), recs[i].codes, src)
    if (not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid
            and h[0].rid >= 0 and a[0] and a[1]):
        d, dist = infer_dir(bns.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    s0 = reg2sam(opt, bns, text, recs[0], recs[0].codes, a[0],
                 extra_flag=0x41 | extra_flag, m=h[1], rg_id=rg_id)
    s1 = reg2sam(opt, bns, text, recs[1], recs[1].codes, a[1],
                 extra_flag=0x81 | extra_flag, m=h[0], rg_id=rg_id)
    return s0, s1
