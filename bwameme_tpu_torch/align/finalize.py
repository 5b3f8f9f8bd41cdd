"""Post-extension finalization: dedup/merge, primary marking, mapq, CIGAR,
SAM record emission.

The port's copy of bwameme_tpu/align/finalize.py over the port's AlnReg.

Replicates (reference file:line):
* mem_sort_dedup_patch         src/bwamem.cpp:312-440 + mem_patch_reg :194-247
* mem_mark_primary_se(+_core)  src/bwamem.cpp:1974-2047
* mem_approx_mapq_se           src/bwamem.cpp:2052-2077
* mem_reorder_primary5         src/bwamem.cpp:2078-2101
* mem_reg2aln (CIGAR/NM/MD)    src/bwamem.cpp:2314-2391 + bwa_gen_cigar2
                               (src/bwa.cpp) + infer_bw :2393-2400
* mem_reg2sam / mem_aln2sam    src/bwamem.cpp:2103-2313
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from bwameme_tpu_torch.align.extend import AlnReg
from bwameme_tpu_torch.align.sw_scalar import sw_global
from bwameme_tpu_torch.utils.config import (
    MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI, MEM_F_PRIMARY5,
    MEM_F_SOFTCLIP,
)

PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
INT_MAX = 2**31 - 1

_FWD_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
_REV_BASES = np.frombuffer(b"TGCAN", dtype=np.uint8)


def hash_64(key: int) -> int:
    """Thomas Wang 64-bit mix (reference: src/utils.h:117-129)."""
    mask = (1 << 64) - 1
    key = (key + (~(key << 32) & mask)) & mask
    key ^= key >> 22
    key = (key + (~(key << 13) & mask)) & mask
    key ^= key >> 8
    key = (key + (key << 3)) & mask
    key ^= key >> 15
    key = (key + (~(key << 27) & mask)) & mask
    key ^= key >> 31
    return key


# ---------------------------------------------------------------- dedup/patch

def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar(opt, bns, text: np.ndarray, w: int, query_seg: np.ndarray,
              rb: int, re: int):
    """bwa_gen_cigar2 semantics. Returns (score, cigar[(op,len)], NM, MD)."""
    l_pac = bns.l_pac
    l_query = len(query_seg)
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return 0, None, -1, None
    rseq = text[rb:re].copy()
    q = query_seg.copy()
    if rb >= l_pac:  # reverse both to left-align indels
        q = q[::-1].copy()
        rseq = rseq[::-1].copy()
    rlen = len(rseq)
    if l_query == re - rb and w == 0:
        cigar = [(0, l_query)]
        score = int(opt.mat[rseq[:l_query], q[:l_query]].sum(dtype=np.int64))
    else:
        # int(mat[0,0]): the scoring matrix is int8 and NumPy-2 promotion
        # would wrap ((l_query+1)>>1)*int8 for reads >~250bp
        a = int(opt.mat[0, 0])
        max_ins = int((((l_query + 1) >> 1) * a - opt.o_ins) / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * a - opt.o_del) / opt.e_del + 1.0)
        max_gap = max(max_ins, max_del, 1)
        ww = (max_gap + abs(rlen - l_query) + 1) >> 1
        ww = min(ww, w)
        min_w = abs(rlen - l_query) + 3
        ww = max(ww, min_w)
        from bwameme_tpu_torch.align.native import sw_global_native

        res = sw_global_native(q, rseq, opt.mat, opt.o_del, opt.e_del,
                               opt.o_ins, opt.e_ins, ww)
        if res is not None:
            score, cigar = res
        else:
            score, cigar = sw_global(q, rseq, opt.mat, opt.o_del, opt.e_del,
                                     opt.o_ins, opt.e_ins, ww)
    # NM / MD
    int2base = "ACGTN" if rb < l_pac else "TGCAN"
    md = []
    x = y = u = 0
    n_mm = n_gap = 0
    for k, (op, ln) in enumerate(cigar):
        if op == 0:
            mm = np.flatnonzero(q[x: x + ln] != rseq[y: y + ln])
            prev = -1
            for i in mm:
                md.append(str(u + int(i) - prev - 1))
                md.append(int2base[min(int(rseq[y + int(i)]), 4)])
                u = 0
                prev = int(i)
            u += ln - 1 - prev
            n_mm += len(mm)
            x += ln
            y += ln
        elif op == 2:
            if 0 < k < len(cigar) - 1:
                md.append(str(u))
                md.append("^" + "".join(int2base[min(int(rseq[y + i]), 4)] for i in range(ln)))
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:
            x += ln
            n_gap += ln
    md.append(str(u))
    return score, cigar, n_mm + n_gap, "".join(md)


def mem_patch_reg(opt, bns, text: np.ndarray, query: np.ndarray,
                  a: AlnReg, b: AlnReg):
    """reference: src/bwamem.cpp:194-247. Returns (score, w) or (0, 0)."""
    if text is None or query is None:  # bns==0 mode (mate-rescue dedup)
        return 0, 0
    if a.rb < bns.l_pac <= b.rb:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += a.w + b.w
    w = min(w, opt.w << 2)
    score, cigar, _, _ = gen_cigar(opt, bns, text, w, query[a.qb: b.qe], a.rb, b.re)
    if cigar is None:
        return 0, 0
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def sort_dedup_patch(opt, bns, text: np.ndarray, query: np.ndarray,
                     regs: list[AlnReg]) -> list[AlnReg]:
    """mem_sort_dedup_patch (reference: src/bwamem.cpp:312-384)."""
    n = len(regs)
    if n <= 1:
        return regs
    a = sorted(regs, key=lambda r: r.re)  # sort by END
    for r in a:
        r.n_comp = 1
    for i in range(1, len(a)):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and p.rb < a[j].re + opt.max_chain_gap:
            q = a[j]
            j -= 1
            if q.qe == q.qb:
                continue
            or_ = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if or_ > opt.mask_level_redun * mr and oq > opt.mask_level_redun * mq:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb:
                score, w = mem_patch_reg(opt, bns, text, query, q, p)
                if score > 0:
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [r for r in a if r.qe > r.qb]
    # sort by (score desc, rb, qb)  — alnreg_slt
    a.sort(key=lambda r: (-r.score, r.rb, r.qb))
    for i in range(1, len(a)):
        if (a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb
                and a[i].qb == a[i - 1].qb):
            a[i].qe = a[i].qb
    return [r for i, r in enumerate(a) if i == 0 or r.qe > r.qb]


# ------------------------------------------------------------- primary marking

def mark_primary_core(opt, a: list[AlnReg], n: int) -> None:
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        hit = -1
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if a[k].score - a[i].score <= tmp and (a[k].is_alt or not a[i].is_alt):
                        a[k].sub_n += 1
                    hit = k
                    break
        if hit < 0:
            z.append(i)
        else:
            a[i].secondary = hit


def mark_primary(opt, regs: list[AlnReg], rid_counter: int) -> list[AlnReg]:
    """mem_mark_primary_se (reference: src/bwamem.cpp:2002-2047).
    Returns the reordered list (sorting is in-place-by-copy here)."""
    n = len(regs)
    if n == 0:
        return regs
    n_pri = 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64((rid_counter + i) & ((1 << 64) - 1))
        if not r.is_alt:
            n_pri += 1
    # sort: score desc, is_alt asc, hash asc  (alnreg_hlt)
    a = sorted(regs, key=lambda r: (-r.score, r.is_alt, r.hash))
    mark_primary_core(opt, a, n)
    for i, p in enumerate(a):
        p.secondary_all = i
        if not p.is_alt and p.secondary >= 0 and a[p.secondary].is_alt:
            p.alt_sc = a[p.secondary].score
    if 0 <= n_pri < n:
        if n_pri > 0:
            # alnreg_hlt2: is_alt asc, then score desc, hash asc
            a = sorted(a, key=lambda r: (r.is_alt, -r.score, r.hash))
        z = [0] * n
        for i in range(n):
            z[a[i].secondary_all] = i
        for i in range(n):
            if a[i].secondary >= 0:
                a[i].secondary_all = z[a[i].secondary]
                if a[i].is_alt:
                    a[i].secondary = INT_MAX
            else:
                a[i].secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                a[i].sub = 0
                a[i].secondary = -1
            mark_primary_core(opt, a, n_pri)
    else:
        for r in a:
            r.secondary_all = r.secondary
    return a


def approx_mapq(opt, a: AlnReg) -> int:
    """mem_approx_mapq_se (reference: src/bwamem.cpp:2052-2077)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(30.0 * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


def reorder_primary5(T: int, a: list[AlnReg]) -> None:
    """mem_reorder_primary5 (reference: src/bwamem.cpp:2078-2101)."""
    n_pri = sum(1 for r in a if r.secondary < 0 and not r.is_alt and r.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = INT_MAX, -1
    for k, p in enumerate(a):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    if left_k == 0:
        return
    a[0], a[left_k] = a[left_k], a[0]
    for k in range(1, len(a)):
        p = a[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0


# --------------------------------------------------------------------- reg2aln

@dataclasses.dataclass
class MemAln:
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: bool = False
    is_alt: bool = False
    mapq: int = 0
    NM: int = -1
    n_cigar: int = 0
    cigar: list[tuple[int, int]] | None = None
    md: str | None = None
    score: int = -1
    sub: int = -1
    alt_sc: int = 0
    XA: str | None = None


def reg2aln(opt, bns, text: np.ndarray, l_query: int, query: np.ndarray,
            ar: AlnReg | None) -> MemAln:
    a = MemAln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    w2 = max(
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins),
    )
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    cigar = None
    while True:
        w2 = min(w2, opt.w << 2)
        score, cigar, NM, md = gen_cigar(opt, bns, text, w2, query[qb:qe], rb, re)
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.NM = NM
    a.md = md
    pos, is_rev = bns.depos(rb if rb < bns.l_pac else re - 1)
    a.is_rev = is_rev
    cigar = list(cigar) if cigar else []
    if cigar:  # squeeze leading/trailing deletions
        if cigar[0][0] == 2:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clips
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    a.n_cigar = len(cigar)
    a.rid = bns.pos2rid(pos)
    a.pos = pos - bns.contigs[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a


# --------------------------------------------------------------------- aln2sam

def _cigar_str(opt, p: MemAln, which: int) -> str:
    if not p.n_cigar:
        return "*"
    out = []
    for op, ln in p.cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{'MIDSH'[c]}")
    return "".join(out)


def get_rlen(cigar) -> int:
    return sum(ln for op, ln in (cigar or []) if op in (0, 2))


def aln2sam(opt, bns, read, n: int, alns: list[MemAln], which: int,
            m: MemAln | None, rg_id: str | None = None) -> str:
    """mem_aln2sam (reference: src/bwamem.cpp:2174-2313). Returns one line."""
    p = dataclasses.replace(alns[which])
    m = dataclasses.replace(m) if m is not None else None
    p.flag |= 0x1 if m is not None else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m is not None and m.rid < 0) else 0
    if p.rid < 0 and m is not None and m.rid >= 0:
        p.rid, p.pos, p.is_rev, p.n_cigar = m.rid, m.pos, m.is_rev, 0
    if m is not None and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev, m.n_cigar = p.rid, p.pos, p.is_rev, 0
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m is not None and m.is_rev) else 0

    fields = [read.name]
    fields.append(str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0)))
    if p.rid >= 0:
        fields.append(bns.contigs[p.rid].name)
        fields.append(str(p.pos + 1))
        fields.append(str(p.mapq))
        fields.append(_cigar_str(opt, p, which))
    else:
        fields.extend(["*", "0", "0", "*"])
    if m is not None and m.rid >= 0:
        fields.append("=" if p.rid == m.rid else bns.contigs[m.rid].name)
        fields.append(str(m.pos + 1))
        if p.rid == m.rid and p.n_cigar and m.n_cigar:
            p0 = p.pos + (get_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (get_rlen(m.cigar) - 1 if m.is_rev else 0)
            fields.append(str(-(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))))
        else:
            fields.append("0")
    else:
        fields.extend(["*", "0", "0"])

    # SEQ / QUAL (printed from nt4 codes, like the reference which converts
    # s->seq in place during kernel 1 — lowercase/ambiguity become ACGTN)
    seq_str, qual_str = "*", "*"
    codes = read.codes  # uint8 nt4 codes
    qual = read.qual
    if p.flag & 0x100:
        pass
    else:
        qb, qe = 0, len(codes)
        if (p.n_cigar and which and not (opt.flag & MEM_F_SOFTCLIP)
                and not p.is_alt):
            if p.cigar[0][0] in (3, 4):
                if p.is_rev:
                    qe -= p.cigar[0][1]
                else:
                    qb += p.cigar[0][1]
            if p.cigar[-1][0] in (3, 4):
                if p.is_rev:
                    qb += p.cigar[-1][1]
                else:
                    qe -= p.cigar[-1][1]
        if not p.is_rev:
            seq_str = _FWD_BASES[np.minimum(codes[qb:qe], 4)].tobytes().decode()
            qual_str = qual[qb:qe] if qual else "*"
        else:
            seq_str = _REV_BASES[np.minimum(codes[qb:qe][::-1], 4)].tobytes().decode()
            qual_str = qual[qb:qe][::-1] if qual else "*"
    fields.append(seq_str if seq_str else "*")
    fields.append(qual_str if qual_str else "*")

    tags = []
    if p.n_cigar:
        tags.append(f"NM:i:{p.NM}")
        tags.append(f"MD:Z:{p.md}")
    if m is not None and m.n_cigar:
        tags.append(f"MC:Z:{_cigar_str(opt, m, which)}")
    if p.score >= 0:
        tags.append(f"AS:i:{p.score}")
    if p.sub >= 0:
        tags.append(f"XS:i:{p.sub}")
    if rg_id:
        tags.append(f"RG:Z:{rg_id}")
    if not (p.flag & 0x100):
        others = [i for i in range(n) if i != which and not (alns[i].flag & 0x100)]
        if others:
            sa = []
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in r.cigar)
                sa.append(
                    f"{bns.contigs[r.rid].name},{r.pos + 1},"
                    f"{'-' if r.is_rev else '+'},{cig},{r.mapq},{r.NM};"
                )
            tags.append("SA:Z:" + "".join(sa))
        if p.alt_sc > 0:
            tags.append(f"pa:f:{p.score / p.alt_sc:.3f}")
    if p.XA:
        tags.append(f"XA:Z:{p.XA}")
    if read.comment:
        tags.append(read.comment)
    return "\t".join(fields + tags)


def reg2sam(opt, bns, text: np.ndarray, read, query: np.ndarray,
            regs: list[AlnReg], extra_flag: int = 0, m: MemAln | None = None,
            rg_id: str | None = None, XA: list[str | None] | None = None) -> str:
    """mem_reg2sam (reference: src/bwamem.cpp:2103-2160). Returns SAM lines."""
    aa: list[MemAln] = []
    l = 0
    l_query = len(query)
    if XA is None and not (opt.flag & MEM_F_ALL):
        from bwameme_tpu_torch.align.alt import gen_alt

        XA = gen_alt(opt, bns, text, regs, l_query, query)
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (p.secondary >= 0 and p.secondary < INT_MAX
                and p.score < regs[p.secondary].score * opt.drop_ratio):
            continue
        q = reg2aln(opt, bns, text, l_query, query, p)
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1
        if l and p.secondary < 0:
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if (not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and l and not p.is_alt
                and q.mapq > aa[0].mapq):
            q.mapq = aa[0].mapq
        aa.append(q)
        l += 1
    if not aa:
        t = reg2aln(opt, bns, text, l_query, query, None)
        t.flag |= extra_flag
        return aln2sam(opt, bns, read, 1, [t], 0, m, rg_id) + "\n"
    lines = [aln2sam(opt, bns, read, len(aa), aa, k, m, rg_id) for k in range(len(aa))]
    return "\n".join(lines) + "\n"
