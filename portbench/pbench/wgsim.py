"""Reads by wgsim's model, vectorised with NumPy.

wgsim (github.com/lh3/wgsim, the simulator of the BWA-MEM paper,
arXiv:1303.3997) first mutates the reference into two haplotypes
(``maq_mut_diref``): each base mutates with probability ``mutation_rate``;
a mutation is an indel with probability ``indel_fraction``, else a
substitution to one of the three other bases; an indel is a deletion or an
insertion with even odds, a deletion extended base by base with probability
``indel_extend``, an insertion of 1-4 random bases extended the same way;
each mutation is homozygous with probability 1/3, else on one haplotype.
Then each pair takes a haplotype, a fragment length from N(fragment_mean,
fragment_sd) (at least the longer read) and a uniform position; the forward
end of the fragment and the reverse complement of its other end are the two
reads, which of them is read 1 decided by a coin; each base becomes one of
the three others with probability ``error_rate``; every quality is
``-10 log10(error_rate)`` rounded, plus 33. As in wgsim, no fragment runs
across a contig's end: one that would starts at the next contig's first
base instead.

Everything comes from the seed, in blocks of BLOCK units whose generator is
seeded by (seed, stream, block): a pool of n units is the first n of one
fixed stream, whatever n is."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

BLOCK = 1 << 13
_ACGT = np.frombuffer(b"ACGTN", dtype=np.uint8)
NAME_DIGITS = 10


@dataclasses.dataclass
class Haplotype:
    """A mutated copy of the genome: its bases, and the sparse edits that
    map its positions to the reference's: the deleted reference positions
    (sorted) and where inserted bases sit in the haplotype (sorted)."""

    codes: np.ndarray
    deleted: np.ndarray
    inserted: np.ndarray

    def to_ref(self, k: np.ndarray) -> np.ndarray:
        """The reference position of the haplotype's bases ``k``; an
        inserted base maps to the base before it."""
        j = k - np.searchsorted(self.inserted, k, side="right")
        shift = self.deleted - np.arange(len(self.deleted))
        return j + np.searchsorted(shift, j, side="right")

    def from_ref(self, r: np.ndarray) -> np.ndarray:
        """The haplotype position of reference positions ``r`` (of the next
        base kept, where r was deleted)."""
        j = r - np.searchsorted(self.deleted, r)
        slots = self.inserted - np.arange(len(self.inserted))
        return j + np.searchsorted(slots, j, side="right")


@dataclasses.dataclass
class Reads:
    """n units (reads, or pairs of reads) of one stream: ``seq[m]`` the
    reads of mate m (uint8 codes, n x length) as sequenced, ``lo[m]`` /
    ``hi[m]`` the first and last reference position they cover and
    ``rev[m]`` whether they are the reverse strand of the genome."""

    seq: list
    lo: list
    hi: list
    rev: list

    @property
    def n(self) -> int:
        return len(self.seq[0])


def haplotypes(code: np.ndarray, t: dict, seed: int) -> list[Haplotype]:
    """The two mutated haplotypes of the genome (maq_mut_diref's model)."""
    rng = np.random.default_rng([seed, 0])
    n = len(code)
    r = t["mutation_rate"]
    none = np.zeros(0, np.int64)
    if r <= 0:
        same = Haplotype(code, none, none)
        return [same, same]
    gaps = rng.geometric(r, size=int(n * r * 1.2) + 64)
    pos = np.cumsum(gaps) - 1
    while pos[-1] < n:
        more = np.cumsum(rng.geometric(r, size=len(gaps))) + pos[-1]
        pos = np.concatenate([pos, more])
    pos = pos[pos < n].astype(np.int64)
    m = len(pos)
    is_indel = rng.random(m) < t["indel_fraction"]
    is_del = is_indel & (rng.random(m) < 0.5)
    is_ins = is_indel & ~is_del
    hom = rng.random(m) < 1 / 3
    side = rng.integers(0, 2, m)
    sub_to = ((code[pos].astype(np.int64) + 1 + (rng.random(m) * 3).astype(
        np.int64)) & 3).astype(np.uint8)
    x = t["indel_extend"]
    del_len = rng.geometric(1 - x, size=m) if x > 0 else np.ones(m, np.int64)
    ins_len = np.minimum(del_len, 4)
    ins_bases = rng.integers(0, 4, (m, 4)).astype(np.uint8)
    out = []
    for h in (0, 1):
        on = hom | (side == h)
        c = code.copy()
        s = on & ~is_indel
        c[pos[s]] = sub_to[s]
        d = on & is_del
        starts = np.repeat(pos[d], del_len[d])
        offs = np.arange(len(starts)) - np.repeat(
            np.cumsum(del_len[d]) - del_len[d], del_len[d])
        gone = np.unique(np.minimum(starts + offs, n - 1))
        keep = np.ones(n, dtype=bool)
        keep[gone] = False
        i = on & is_ins
        i[i] = keep[pos[i]]
        # after each inserting base, its inserted bases, in kept coordinates
        at = pos[i] - np.searchsorted(gone, pos[i]) + 1
        reps = ins_len[i]
        slots = np.repeat(at, reps)
        vals = ins_bases[i][np.arange(4) < reps[:, None]]
        hap = np.insert(c[keep], slots, vals)
        out.append(Haplotype(hap, gone, slots + np.arange(len(slots))))
    return out


def _errors(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Each base becomes one of the three others with probability rate."""
    out = seq.copy()
    hit = rng.random(seq.shape, dtype=np.float32) < rate
    out[hit] = (seq[hit] + rng.integers(1, 4, int(hit.sum()),
                                        dtype=np.uint8)) & 3
    return out


def _block(haps, t: dict, seed: int, stream: int, b: int, count: int,
           starts: np.ndarray) -> Reads:
    rng = np.random.default_rng([seed, stream, b])
    l1, l2 = t["read_len"]
    paired = t["paired"]
    hap = rng.integers(0, 2, count)
    d = np.rint(rng.normal(t["fragment_mean"], t["fragment_sd"], count))
    d = np.maximum(d.astype(np.int64), max(l1, l2))
    u = rng.random(count)
    flip = rng.random(count) < 0.5
    seq = [np.empty((count, l1), np.uint8), np.empty((count, l2), np.uint8)]
    lo = [np.empty(count, np.int64), np.empty(count, np.int64)]
    hi = [np.empty(count, np.int64), np.empty(count, np.int64)]
    rev = [flip.copy(), ~flip]
    for h in (0, 1):
        sel = np.nonzero(hap == h)[0]
        if not len(sel):
            continue
        H = haps[h]
        n = len(H.codes)
        span = n - d[sel] + 1
        p = (span * u[sel]).astype(np.int64)
        c0 = np.searchsorted(starts, H.to_ref(p), side="right")
        c1 = np.searchsorted(starts, H.to_ref(p + d[sel] - 1), side="right")
        across = c1 != c0
        p[across] = H.from_ref(starts[c1[across] - 1])
        fwd_idx = p[:, None] + np.arange(l1)
        fwd = H.codes[fwd_idx]
        rev_start = p + d[sel] - l2
        rev_idx = rev_start[:, None] + np.arange(l2)
        back = (3 - H.codes[rev_idx])[:, ::-1]
        f_lo, f_hi = H.to_ref(p), H.to_ref(p + l1 - 1)
        r_lo, r_hi = H.to_ref(rev_start), H.to_ref(p + d[sel] - 1)
        # read 1 is the forward end unless flipped (wgsim: is_flip)
        fl = flip[sel]
        seq[0][sel[~fl]] = fwd[~fl]
        seq[0][sel[fl]] = back[fl]
        seq[1][sel[~fl]] = back[~fl]
        seq[1][sel[fl]] = fwd[fl]
        lo[0][sel] = np.where(fl, r_lo, f_lo)
        hi[0][sel] = np.where(fl, r_hi, f_hi)
        lo[1][sel] = np.where(fl, f_lo, r_lo)
        hi[1][sel] = np.where(fl, f_hi, r_hi)
    seq[0] = _errors(rng, seq[0], t["error_rate"])
    if not paired:
        return Reads(seq[:1], lo[:1], hi[:1], rev[:1])
    seq[1] = _errors(rng, seq[1], t["error_rate"])
    return Reads(seq, lo, hi, rev)


def generate(haps, t: dict, seed: int, stream: int, n: int,
             starts=np.zeros(1, np.int64)) -> Reads:
    """The first n units of stream ``stream`` (reads or pairs); ``starts``
    the contigs' offsets in the genome."""
    parts = [_block(haps, t, seed, stream, b, BLOCK, starts)
             for b in range(math.ceil(n / BLOCK))]
    mates = len(parts[0].seq)
    return Reads(*([np.concatenate([getattr(p, f)[m] for p in parts])[:n]
                    for m in range(mates)]
                   for f in ("seq", "lo", "hi", "rev")))


def quality_char(error_rate: float) -> int:
    """wgsim's one quality for every base."""
    if error_rate == 0:
        return ord("I")
    return int(-10.0 * math.log10(error_rate) + 0.499) + 33


def _records(seq: np.ndarray, names: np.ndarray, q: int) -> np.ndarray:
    n, ln = seq.shape
    w = 1 + NAME_DIGITS + 1 + ln + 3 + ln + 1
    a = np.empty((n, w), np.uint8)
    a[:, 0] = ord("@")
    for k in range(NAME_DIGITS):
        a[:, 1 + k] = ord("0") + (names // 10 ** (NAME_DIGITS - 1 - k)) % 10
    o = 1 + NAME_DIGITS
    a[:, o] = ord("\n")
    a[:, o + 1: o + 1 + ln] = _ACGT[seq]
    o += 1 + ln
    a[:, o: o + 3] = np.frombuffer(b"\n+\n", np.uint8)
    a[:, o + 3: o + 3 + ln] = q
    a[:, -1] = ord("\n")
    return a


def fastq_text(reads: Reads, first_name: int, error_rate: float) -> str:
    """The units as FASTQ text, mates interleaved (R1, R2, R1, ...) with one
    name a unit: its index from ``first_name``, as NAME_DIGITS digits."""
    names = np.arange(first_name, first_name + reads.n, dtype=np.int64)
    q = quality_char(error_rate)
    recs = [_records(s, names, q) for s in reads.seq]
    return np.concatenate(recs, axis=1).tobytes().decode("ascii")
