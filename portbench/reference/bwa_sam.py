"""The plain reference for the SAM that a short-read aligner writes.

Plain NumPy, independent of the program: it takes the genome as the
benchmark made it (its codes, contigs, repeats and duplications) and the
reads with the place each came from, and judges the records the program
wrote for them, read by read. Counts of faults, each of which should never
happen:

- ``faults``, the records: the read has one primary record and no
  secondary one (``-a`` is off), every line is named as the read; each
  record's SEQ and QUAL are the read's (reverse-complemented and reversed on
  the reverse strand, less what a hard clip leaves out), its CIGAR spans the
  read, its NM and MD are what the CIGAR gives against the genome, and its
  AS is the score of its CIGAR under the configuration's scoring, or above
  it by less than the clipping penalty for each end that is not clipped
  (bwa-mem reports its extension's best local score and extends to the end
  of the read when that costs less than the penalty); in a pair, the mate
  fields (RNEXT, PNEXT, the mate's strand and unmapped flags, TLEN by
  bwa-mem's rule) are what the mate's primary record says, and the first
  and second read flags are set;
- ``finalize``, what bwa-mem's finalize decides, on each mapped primary
  record: MAPQ lies in [0, 60] and XS is there; every XA hit is an
  alignment of the read at its place, its NM what its CIGAR gives there.
  MAPQ against mem_approx_mapq_se worked out from AS, XS and the aligned
  length (``approx_mapq``), which sub_n (other hits within a gap's cost of
  the best) and frac_rep (the share of the read under seeds of more than
  max_occ hits) can only lower: single-end, XS <= AS and MAPQ at most that;
  equal to it where AS - XS is over a gap's cost (so sub_n is 0) and the
  read's source touches no repeat (so frac_rep is 0); paired-end, where the
  pairing can only raise it, at least that on such a read. A read from one
  stretch of a segmental duplication, with 40 bases to spare, aligned
  inside either stretch, has its twin in the other stretch, base for base:
  its XS is its AS, and single-end its MAPQ is 0 and its XA holds the twin
  (paired-end an XA, where there is one, holds it; bwa-mem writes none for
  a mate whose pair took its second hit); a pair whose mates both come from
  one stretch has MAPQ 0 on both.

and two shares:

- ``score_gap``: reads whose clip-adjusted score (their CIGAR's score plus
  the clipping penalty for each end that is not clipped, which is what
  bwa-mem's extension maximises) lies below the best such score that any
  local alignment of the read reaches in a window around its source; that
  is, an alignment at least as good as the program's answer exists where
  the read came from and the program missed it;
- ``improper``: pairs with both mates' primary records over their sources
  that are not flagged as properly paired.

The best score is an affine-gap Smith-Waterman with end bonuses, one row of
the read at a time over all sampled reads at once; the deletion state of a
row is a running maximum (``numpy.maximum.accumulate``)."""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

NEG = -(1 << 28)
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
_CODE = np.full(256, 4, dtype=np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
_BASE = "ACGTN"
DUP_MARGIN = 40


@dataclasses.dataclass
class Scoring:
    a: int = 1          # match
    b: int = 4          # mismatch
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    clip: int = 5       # clipping penalty, both ends
    min_score: int = 30
    min_seed_len: int = 19
    mapq_coef_len: int = 50

    @property
    def gap_cost(self) -> int:
        """The most by which a hit may trail the best and count in sub_n."""
        return max(self.a + self.b, self.o_del + self.e_del,
                   self.o_ins + self.e_ins)


@dataclasses.dataclass
class Record:
    flag: int
    rname: str
    pos: int            # 0-based on its contig; -1 unmapped
    gpos: int           # 0-based in the genome end to end
    mapq: int
    cigar: list
    rnext: str
    pnext: int
    tlen: int
    seq: str
    qual: str
    tags: dict
    score: int | None = None    # its CIGAR's, once cigar_fields ran

    @property
    def mapped(self) -> bool:
        return not self.flag & 4 and bool(self.cigar)

    @property
    def rev(self) -> bool:
        return bool(self.flag & 16)

    def ref_len(self) -> int:
        return sum(n for n, op in self.cigar if op in "MDN=X")

    def query_len(self) -> int:
        return sum(n for n, op in self.cigar if op in "MI=X")

    def end5(self) -> int:
        """The genome position of the read's 5' end (bwa-mem's TLEN rule)."""
        return self.pos + (self.ref_len() - 1 if self.rev else 0)


def _cigar(s: str) -> list:
    return [] if s == "*" else [(int(n), op) for n, op in _CIGAR.findall(s)]


def records(block: str, name: str, offset: dict):
    """The records of one read's SAM block, the primary first, or a
    fault's text."""
    prim, rest = [], []
    for line in block.rstrip("\n").split("\n"):
        f = line.split("\t")
        if len(f) < 11 or f[0] != name:
            return f"a line not of read {name}: {line[:60]!r}"
        tags = {}
        for t in f[11:]:
            k, ty, v = t.split(":", 2)
            tags[k] = int(v) if ty == "i" else v
        pos = int(f[3]) - 1
        r = Record(int(f[1]), f[2], pos, offset.get(f[2], 0) + pos,
                   int(f[4]), _cigar(f[5]), f[6], int(f[7]) - 1, int(f[8]),
                   f[9], f[10], tags)
        if r.flag & 0x100:
            return f"read {name}: a secondary record (-a is off)"
        (rest if r.flag & 0x800 else prim).append(r)
    if len(prim) != 1:
        return f"read {name}: {len(prim)} primary records"
    return prim + rest


def cigar_fields(gpos: int, cigar: list, q: np.ndarray, genome: np.ndarray,
                 sc: Scoring):
    """NM, MD and the score of an alignment of the read ``q`` (codes, on
    the strand aligned, hard-clipped bases left out) at ``gpos``, and the
    read length its CIGAR spans."""
    qi, ti = 0, gpos
    nm = score = run = qlen = 0
    md = []
    for n, op in cigar:
        if op in "M=X":
            r = genome[ti: ti + n]
            if len(r) < n or qi + n > len(q):
                return None
            diff = np.nonzero(r != q[qi: qi + n])[0]
            score += sc.a * (n - len(diff)) - sc.b * len(diff)
            last = 0
            for k in diff:
                md.append(str(run + int(k) - last))
                md.append(_BASE[r[k]])
                run, last = 0, int(k) + 1
            nm += len(diff)
            run += n - last
            qi += n
            ti += n
            qlen += n
        elif op == "I":
            nm += n
            score -= sc.o_ins + sc.e_ins * n
            qi += n
            qlen += n
        elif op == "D":
            md.append(str(run))
            md.append("^" + "".join(_BASE[c] for c in genome[ti: ti + n]))
            run = 0
            nm += n
            score -= sc.o_del + sc.e_del * n
            ti += n
        elif op == "S":
            qi += n
            qlen += n
        elif op == "H":
            qlen += n
    md.append(str(run))
    return nm, "".join(md), score, qlen


def approx_mapq(score: int, xs: int, cigar: list, sc: Scoring) -> int:
    """mem_approx_mapq_se with no other hit within a gap's cost (sub_n 0)
    and no repetitive seed (frac_rep 0), from the record's AS, XS and
    CIGAR: the best other hit is XS, or a seed's worth where XS is less;
    the aligned length is the longer of the CIGAR's spans on the read and
    on the genome."""
    sub = max(xs, sc.min_seed_len * sc.a)
    if sub >= score:
        return 0
    lq = sum(n for n, op in cigar if op in "MI=X")
    lr = sum(n for n, op in cigar if op in "MDN=X")
    ln = max(lq, lr)
    identity = 1.0 - (ln * sc.a - score) / (sc.a + sc.b) / ln
    tmp = 1.0 if ln < sc.mapq_coef_len else (
        int(math.log(sc.mapq_coef_len)) / math.log(ln))
    tmp *= identity * identity
    mapq = int(6.02 * (score - sub) / sc.a * tmp * tmp + 0.499)
    return min(max(mapq, 0), 60)


def seq_of(codes: np.ndarray, rev: bool) -> str:
    s = bytes(np.frombuffer(b"ACGTN", np.uint8)[codes])
    return (s.translate(_COMP)[::-1] if rev else s).decode()


def best_scores(reads: list, windows: list, sc: Scoring) -> np.ndarray:
    """The best clip-adjusted local score of each read (codes, as it lies on
    the forward strand) in its window of the genome (codes): the maximum
    over local alignments of their score plus ``clip`` for each end of the
    read that they reach. Reads of one length and windows of one length."""
    n = len(reads)
    if not n:
        return np.zeros(0, np.int64)
    q = np.stack(reads).astype(np.int16)
    t = np.stack(windows).astype(np.int16)
    L, W = q.shape[1], t.shape[1]
    e_d = sc.e_del
    oe_i, e_i = sc.o_ins + sc.e_ins, sc.e_ins
    H = np.full((n, W), NEG, np.int64)
    F = np.full((n, W), NEG, np.int64)
    E = np.full((n, W), NEG, np.int64)
    best = np.full(n, NEG, np.int64)
    jj = np.arange(W, dtype=np.int64) * e_d
    for i in range(L):
        s = np.where(q[:, i: i + 1] == t, sc.a, -sc.b)
        prev = np.maximum(np.maximum(H, E), F)
        diag = np.full((n, W), NEG, np.int64)
        diag[:, 1:] = prev[:, :-1]
        start = sc.clip if i == 0 else 0
        Hn = s + np.maximum(diag, start)
        Fn = np.maximum(np.maximum(H, E) - oe_i, F - e_i)
        G = np.maximum(Hn, Fn) + jj
        run = np.maximum.accumulate(G, axis=1)
        En = np.full((n, W), NEG, np.int64)
        En[:, 1:] = run[:, :-1] - sc.o_del - jj[1:]
        H, F, E = Hn, Fn, En
        end = sc.clip if i == L - 1 else 0
        best = np.maximum(best, H.max(axis=1) + end)
    return best


def _unclipped(rec: Record) -> int:
    return (rec.cigar[0][1] not in "SH") + (rec.cigar[-1][1] not in "SH")


def adjusted(rec: Record, sc: Scoring) -> int:
    """The score of the record's CIGAR plus the clipping penalty of each
    unclipped end."""
    return rec.score + sc.clip * _unclipped(rec)


def _on_strand(c: np.ndarray, rev: bool) -> np.ndarray:
    return (3 - c)[::-1] if rev else c


def _record_faults(r: Record, c: np.ndarray, ql: str, code: np.ndarray,
                   sc: Scoring, unique: bool, tag: str) -> list:
    """The faults of one record of a read (codes ``c`` as sequenced,
    quality ``ql``, ``unique`` where its source touches no repeat); sets
    the record's score."""
    out = []
    hl = r.cigar[0][0] if r.cigar and r.cigar[0][1] == "H" else 0
    hr = r.cigar[-1][0] if len(r.cigar) > 1 and r.cigar[-1][1] == "H" else 0
    want = seq_of(c, r.rev)
    wq = ql[::-1] if r.rev else ql
    if (r.seq, r.qual) != (want[hl: len(want) - hr], wq[hl: len(wq) - hr]):
        out.append(f"{tag}: SEQ or QUAL is not the read's")
    if not r.mapped:
        return out
    q = _on_strand(c, r.rev)[hl: len(c) - hr]
    got = cigar_fields(r.gpos, r.cigar, q, code, sc)
    if got is None:
        return out + [f"{tag}: CIGAR runs past the genome or the read"]
    nm, md, score, qlen = got
    if qlen != len(c):
        out.append(f"{tag}: CIGAR spans {qlen} of {len(c)} bases")
    if (r.tags.get("NM"), r.tags.get("MD")) != (nm, md):
        out.append(f"{tag}: NM/MD {r.tags.get('NM')}/{r.tags.get('MD')}, "
                   f"the CIGAR gives {nm}/{md}")
    # bwa-mem's AS is its extension's best local score: an end it extends
    # to the read's end (by the clipping penalty's rule) may score up to
    # clip - 1 below it. In a repeat, AS may also be the estimate of two
    # regions patched into one, or a path through the seed that the CIGAR's
    # banded global alignment beats, so it is held only outside repeats
    room = (sc.clip - 1) * _unclipped(r)
    if unique and not 0 <= r.tags.get("AS", NEG) - score <= room:
        out.append(f"{tag}: AS {r.tags.get('AS')}, the CIGAR scores {score}")
    r.score = score
    return out


def _xa(r: Record, c: np.ndarray, code: np.ndarray, offset: dict,
        sc: Scoring, tag: str):
    """The record's XA hits as (genome position, reverse) and their
    faults: each hit an alignment of the whole read at its place, its NM
    what its CIGAR gives there."""
    hits, out = [], []
    for h in str(r.tags.get("XA", "")).split(";"):
        if not h:
            continue
        f = h.split(",")
        if len(f) != 4 or f[0] not in offset or f[1][:1] not in "+-":
            out.append(f"{tag}: XA hit {h!r} malformed")
            continue
        rev = f[1][0] == "-"
        g = offset[f[0]] + int(f[1][1:]) - 1
        got = cigar_fields(g, _cigar(f[2]), _on_strand(c, rev), code, sc)
        if got is None or got[3] != len(c) or got[0] != int(f[3]):
            out.append(f"{tag}: XA hit {h!r} is no alignment of the read "
                       "there")
        hits.append((g, rev))
    return hits, out


def _finalize_faults(r: Record, src: tuple, c: np.ndarray, genome,
                     offset: dict, sc: Scoring, paired: bool, tag: str,
                     seen: dict):
    """The faults of a mapped primary record in what finalize decides, and
    the duplication stretch (row, side) that holds it, if any; counts in
    ``seen`` the records that each rule could judge."""
    out = []
    xs = r.tags.get("XS")
    if not 0 <= r.mapq <= 60 or not isinstance(xs, int):
        return [f"{tag}: MAPQ {r.mapq}, XS {xs}"], None
    hits, bad = _xa(r, c, genome.code, offset, sc, tag)
    out += bad
    score = r.tags["AS"]
    want = approx_mapq(score, xs, r.cigar, sc)
    lo, hi = src[0], src[1]
    unique = not genome.in_repeat(np.array([lo]), np.array([hi]))[0]
    exact = unique and score - xs > sc.gap_cost
    seen["exact_mapq"] += exact
    if not paired:
        if xs > score:
            out.append(f"{tag}: XS {xs} above AS {score}")
        if r.mapq > want or (exact and r.mapq != want):
            out.append(f"{tag}: MAPQ {r.mapq}, AS {score} and XS {xs} give "
                       f"{want}")
    elif exact and r.mapq < want:
        out.append(f"{tag}: MAPQ {r.mapq}, below {want} that AS {score} and "
                   f"XS {xs} give alone")
    row, side = genome.dup_of(np.array([lo]), np.array([hi]), DUP_MARGIN)
    if row[0] < 0:
        return out, None
    a0, b0, ln = (int(v) for v in genome.dups[row[0]])
    end = r.gpos + r.ref_len()
    if a0 <= r.gpos and end <= a0 + ln:
        twin = r.gpos - a0 + b0
    elif b0 <= r.gpos and end <= b0 + ln:
        twin = r.gpos - b0 + a0
    else:
        return out, None
    seen["twins"] += 1
    if xs != score:
        out.append(f"{tag}: XS {xs}, AS {score}, where a twin of the hit "
                   "lies in the duplication's other stretch")
    if (twin, r.rev) not in hits and (not paired or hits):
        out.append(f"{tag}: XA lacks the twin at {twin + 1} in the "
                   "duplication's other stretch")
    if not paired and r.mapq:
        out.append(f"{tag}: MAPQ {r.mapq} with a twin of equal score")
    return out, (int(row[0]), int(side[0]))


def judge(units: list, genome, sc: Scoring, paired: bool,
          pad: int = 32) -> dict:
    """Judge sampled units against ``genome`` (pbench.genome.Genome). Each
    unit is (name, [block of each mate], [codes of each mate as sequenced],
    [qual of each mate], [(lo, hi, rev) of each mate's source in the genome
    end to end]). Returns the counts and shares, and the first faults'
    texts."""
    code = genome.code
    offset = genome.offset_of()
    faults, fin = [], []
    seen = {"exact_mapq": 0, "twins": 0}
    recs = []
    for name, blocks, codes, quals, src in units:
        rs, dup = [], []
        for m, (block, c, ql) in enumerate(zip(blocks, codes, quals)):
            tag = f"read {name}/{m + 1}"
            got = records(block, name, offset)
            if isinstance(got, str):
                faults.append(got)
                rs.append(None)
                continue
            unique = not genome.in_repeat(np.array([src[m][0]]),
                                          np.array([src[m][1]]))[0]
            for k, rec in enumerate(got):
                faults.extend(_record_faults(
                    rec, c, ql, code, sc, unique,
                    tag + ("" if k == 0 else " (supplementary)")))
            r = got[0]
            if r.mapped and r.score is not None:
                bad, d = _finalize_faults(r, src[m], c, genome, offset, sc,
                                          paired, tag, seen)
                fin.extend(bad)
                dup.append(d)
            if paired:
                want_bit = 0x40 if m == 0 else 0x80
                if not r.flag & 1 or (r.flag & 0xC0) != want_bit:
                    faults.append(f"{tag}: flag {r.flag} lacks the pair "
                                  "bits")
            rs.append(r)
        if paired and None not in rs:
            faults.extend(_mate_faults(name, rs))
            if len(dup) == 2 and dup[0] is not None and dup[0] == dup[1] \
                    and (rs[0].mapq or rs[1].mapq):
                fin.append(f"pair {name}: MAPQ {rs[0].mapq}/{rs[1].mapq}, "
                           "both mates from one stretch of a duplication")
        recs.append(rs)

    # the best score at each read's source
    items = []
    for (name, blocks, codes, quals, src), rs in zip(units, recs):
        for m, (c, (lo, hi, rev)) in enumerate(zip(codes, src)):
            fwd = _on_strand(c, rev).astype(np.uint8)
            items.append((rs[m], fwd, lo, hi))
    by_len = {}
    for k, (r, fwd, lo, hi) in enumerate(items):
        by_len.setdefault(len(fwd), []).append(k)
    ref_best = np.zeros(len(items), np.int64)
    for ln, ks in by_len.items():
        W = ln + 2 * pad + max(max(int(items[k][3] - items[k][2] + 1) - ln, 0)
                               for k in ks)
        wins = []
        for k in ks:
            lo = max(int(items[k][2]) - pad, 0)
            w = code[lo: lo + W]
            if len(w) < W:
                w = np.concatenate([w, np.full(W - len(w), 4, np.uint8)])
            wins.append(w)
        for b0 in range(0, len(ks), 512):
            part = ks[b0: b0 + 512]
            ref_best[part] = best_scores([items[k][1] for k in part],
                                         wins[b0: b0 + 512], sc)
    gaps = 0
    for k, (r, fwd, lo, hi) in enumerate(items):
        have = (adjusted(r, sc) if r is not None and r.score is not None
                else NEG)
        if ref_best[k] >= sc.min_score and have < ref_best[k]:
            gaps += 1
    out = dict(units=len(units), reads=len(items), faults=len(faults),
               finalize=len(fin), score_gap=gaps,
               fault_texts=faults[:5] + fin[:5], **seen)
    if paired:
        at_src = improper = 0
        for (name, blocks, codes, quals, src), rs in zip(units, recs):
            if None in rs or not all(r.mapped for r in rs):
                continue
            if all(r.gpos <= hi and r.gpos + r.ref_len() - 1 >= lo
                   for r, (lo, hi, rev) in zip(rs, src)):
                at_src += 1
                improper += not rs[0].flag & 2
        out.update(pairs_at_source=at_src, improper=improper)
    return out


def _mate_faults(name: str, rs: list) -> list:
    out = []
    for m in (0, 1):
        r, mate = rs[m], rs[1 - m]
        if bool(r.flag & 8) != (not mate.mapped):
            out.append(f"read {name}/{m + 1}: mate-unmapped flag wrong")
        if mate.mapped and bool(r.flag & 32) != mate.rev:
            out.append(f"read {name}/{m + 1}: mate-strand flag wrong")
        if r.mapped and mate.mapped:
            same = r.rname == mate.rname
            if (r.rnext != ("=" if same else mate.rname)
                    or r.pnext != mate.pos):
                out.append(f"read {name}/{m + 1}: RNEXT/PNEXT "
                           f"{r.rnext}:{r.pnext + 1}, the mate is at "
                           f"{mate.rname}:{mate.pos + 1}")
            if same:
                p0, p1 = r.end5(), mate.end5()
                tlen = -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
                if r.tlen != tlen:
                    out.append(f"read {name}/{m + 1}: TLEN {r.tlen}, the "
                               f"records give {tlen}")
    return out
