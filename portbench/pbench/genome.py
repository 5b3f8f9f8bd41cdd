"""The genome of a configuration, made from its parameters.

The sequence is made from a fixed seed, as a model's weights are; its shape
is the source's: the contigs and their lengths, the GC share, and the share
of the genome in repeats, of three kinds:

- interspersed families: a consensus of ``consensus_bp`` (log-uniform) a
  family, one family for every ``bp_per_family`` bases of the share; each
  copy is the whole consensus (with probability ``full_length``) or a piece
  of at least ``min_copy_bp``, on either strand, with each base substituted
  at the copy's divergence (uniform over ``divergence``); a copy's family is
  drawn with weight 1 / rank, so a few families have hundreds or thousands
  of copies and most have a few;
- tandem arrays: a unit of ``unit_bp`` (log-uniform) repeated over
  ``array_bp`` (log-uniform), each base substituted at the array's
  divergence;
- segmental duplications: a stretch of ``bp`` (uniform) of the background
  copied base for base, on the same strand, to a place far from it; both
  stretches count in the share.

Every repeat lies in a slot of its own, the slots placed at random without
overlap, and none across a contig's end. The background is independent
bases at the GC share."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

BG_BLOCK = 1 << 24


@dataclasses.dataclass
class Genome:
    """The codes (0-3 for A, C, G, T) of the contigs end to end; each
    contig's name, offset and length; the repeats as sorted, disjoint
    [start, end) intervals; the segmental duplications as rows (source,
    copy, length)."""

    code: np.ndarray
    names: list
    offsets: np.ndarray
    lengths: np.ndarray
    rep_start: np.ndarray
    rep_end: np.ndarray
    dups: np.ndarray

    def offset_of(self) -> dict:
        return dict(zip(self.names, (int(o) for o in self.offsets)))

    def in_repeat(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Whether each [lo, hi] (inclusive) touches a repeat."""
        k = np.searchsorted(self.rep_end, lo, side="right")
        return (k < len(self.rep_start)) & (
            self.rep_start[np.minimum(k, len(self.rep_start) - 1)] <= hi)

    def dup_of(self, lo: np.ndarray, hi: np.ndarray, margin: int):
        """For each [lo, hi]: the row of ``dups`` and the side (0 source, 1
        copy) whose stretch holds it with ``margin`` bases to spare on each
        side, or (-1, -1)."""
        row = np.full(len(lo), -1, np.int64)
        side = np.full(len(lo), -1, np.int64)
        for s in (0, 1):
            a = self.dups[:, s]
            order = np.argsort(a)
            k = np.searchsorted(a[order], lo - margin, side="right") - 1
            ok = k >= 0
            r = order[np.maximum(k, 0)]
            ok &= (a[r] <= lo - margin) & (a[r] + self.dups[r, 2] > hi
                                          + margin)
            row[ok], side[ok] = r[ok], s
        return row, side


def _bases(rng, n: int, gc: float) -> np.ndarray:
    cut = np.array([(1 - gc) / 2, 0.5, (1 + gc) / 2], np.float32)
    return np.searchsorted(cut, rng.random(n, dtype=np.float32),
                           side="right").astype(np.uint8)


def _log_uniform(rng, lo, hi, n) -> np.ndarray:
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)


def _substitute(rng, seq: np.ndarray, rate: np.ndarray) -> None:
    hit = rng.random(len(seq), dtype=np.float32) < rate
    seq[hit] = (seq[hit] + rng.integers(1, 4, int(hit.sum()),
                                        dtype=np.uint8)) & 3


def _ramp(lens: np.ndarray) -> np.ndarray:
    """0..len-1 for each length, end to end."""
    return np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                  lens)


def _take(lens: np.ndarray, budget: float) -> int:
    """How many of ``lens``, from the first, fill ``budget`` bases."""
    return int(np.searchsorted(np.cumsum(lens), budget)) + 1


def make_genome(spec: dict) -> Genome:
    """The genome that ``spec`` (a configuration's ``genome``) describes."""
    if spec["generator"] != "shaped":
        raise ValueError(f"unknown genome generator {spec['generator']!r}")
    rng = np.random.default_rng(spec["seed"])
    names = [c[0] for c in spec["contigs"]]
    lengths = np.array([c[1] for c in spec["contigs"]], np.int64)
    offsets = np.cumsum(lengths) - lengths
    n = int(lengths.sum())
    gc = spec["gc"]
    code = np.concatenate([_bases(rng, min(BG_BLOCK, n - s), gc)
                           for s in range(0, n, BG_BLOCK)])

    # interspersed families and their copies
    fam = spec["interspersed"]
    budget = fam["share"] * n
    nf = max(1, round(budget / fam["bp_per_family"]))
    cons_len = np.maximum(_log_uniform(rng, *fam["consensus_bp"], nf),
                          fam["min_copy_bp"])
    cons = _bases(rng, int(cons_len.sum()), gc)
    cons_off = np.cumsum(cons_len) - cons_len
    w = 1.0 / np.arange(1, nf + 1)
    k = int(budget / fam["min_copy_bp"]) + 16
    f = rng.choice(nf, k, p=w / w.sum())
    whole = rng.random(k) < fam["full_length"]
    piece = fam["min_copy_bp"] + (rng.random(k) * (
        cons_len[f] - fam["min_copy_bp"] + 1)).astype(np.int64)
    clen = np.where(whole, cons_len[f], piece)
    k = min(k, _take(clen, budget))
    f, clen = f[:k], clen[:k]
    cstart = (rng.random(k) * (cons_len[f] - clen + 1)).astype(np.int64)
    crev = rng.random(k) < 0.5
    cdiv = rng.uniform(*fam["divergence"], k)

    # tandem arrays
    tan = spec["tandem"]
    budget = tan["share"] * n
    k2 = int(budget / tan["array_bp"][0]) + 16
    unit = _log_uniform(rng, *tan["unit_bp"], k2)
    alen = np.maximum(_log_uniform(rng, *tan["array_bp"], k2), 2 * unit)
    k2 = min(k2, _take(alen, budget))
    unit, alen = unit[:k2], alen[:k2]
    units = _bases(rng, int(unit.sum()), gc)
    unit_off = np.cumsum(unit) - unit
    adiv = rng.uniform(*tan["divergence"], k2)

    # segmental duplications: two slots each
    dup = spec["duplications"]
    budget = dup["share"] * n / 2
    lo, hi = dup["bp"]
    k3 = int(budget / lo) + 16
    dlen = rng.integers(lo, hi + 1, k3)
    k3 = min(k3, _take(dlen, budget))
    dlen = dlen[:k3]

    # the slots, placed at random without overlap: copies, arrays, and each
    # duplication's two stretches
    slot_len = np.concatenate([clen, alen, dlen, dlen])
    kind = np.repeat([0, 1, 2, 3], [k, k2, k3, k3])
    order = rng.permutation(len(slot_len))
    free = n - int(slot_len.sum())
    gaps = np.sort((rng.random(len(order)) * free).astype(np.int64))
    start = np.empty(len(order), np.int64)
    start[order] = gaps + np.cumsum(slot_len[order]) - slot_len[order]
    end = start + slot_len
    ctg = np.searchsorted(offsets, start, side="right")
    ok = end <= offsets[ctg - 1] + lengths[ctg - 1]

    # in the genome's order of the duplications' slots, the k-th of the
    # first half is copied to the k-th of the second, over the shorter
    # length, so that the two stretches lie far apart
    both = ok[kind == 2] & ok[kind == 3]
    d_at = np.concatenate([start[kind == 2][both], start[kind == 3][both]])
    d_len = np.concatenate([dlen[both], dlen[both]])
    srt = np.argsort(d_at)
    half = len(srt) // 2
    dups = np.stack([d_at[srt[:half]], d_at[srt[half: 2 * half]],
                     np.minimum(d_len[srt[:half]], d_len[srt[half:
                                                             2 * half]])],
                    axis=1) if half else np.zeros((0, 3), np.int64)

    # write the copies, then the arrays, then the duplications
    sel = ok[kind == 0]
    f, clen, cstart, crev, cdiv = (x[sel] for x in (f, clen, cstart, crev,
                                                    cdiv))
    at = start[kind == 0][sel]
    r = _ramp(clen)
    rev = np.repeat(crev, clen)
    src = np.repeat(cons_off[f] + cstart, clen) + np.where(
        rev, np.repeat(clen - 1, clen) - r, r)
    seq = np.where(rev, 3 - cons[src], cons[src]).astype(np.uint8)
    _substitute(rng, seq, np.repeat(cdiv, clen).astype(np.float32))
    code[np.repeat(at, clen) + r] = seq
    sel = ok[kind == 1]
    unit, alen, adiv = unit[sel], alen[sel], adiv[sel]
    at = start[kind == 1][sel]
    r = _ramp(alen)
    seq = units[np.repeat(unit_off[sel], alen) + r % np.repeat(unit, alen)]
    _substitute(rng, seq, np.repeat(adiv, alen).astype(np.float32))
    code[np.repeat(at, alen) + r] = seq
    r = _ramp(dups[:, 2])
    code[np.repeat(dups[:, 1], dups[:, 2]) + r] = code[
        np.repeat(dups[:, 0], dups[:, 2]) + r]

    s = np.concatenate([start[ok & (kind < 2)], dups[:, 0], dups[:, 1]])
    e = np.concatenate([end[ok & (kind < 2)], dups[:, 0] + dups[:, 2],
                        dups[:, 1] + dups[:, 2]])
    o = np.argsort(s)
    return Genome(code, names, offsets, lengths, s[o], e[o], dups)


def key(spec: dict) -> str:
    """A directory name for ``spec``: what makes it, hashed."""
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    return f"genome-{h.hexdigest()[:16]}"


_FIELDS = ("code", "offsets", "lengths", "rep_start", "rep_end", "dups")


def cached(spec: dict, directory: str) -> Genome:
    """The genome of ``spec``, made once and kept in ``directory``
    (``genome.npz``, uncompressed, with the contigs' names)."""
    path = os.path.join(directory, "genome.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return Genome(z["code"], [str(s) for s in z["names"]],
                          *(z[k] for k in _FIELDS[1:]))
    g = make_genome(spec)
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".part.npz"
    np.savez(tmp, names=np.array(g.names),
             **{k: getattr(g, k) for k in _FIELDS})
    os.replace(tmp, path)
    return g
