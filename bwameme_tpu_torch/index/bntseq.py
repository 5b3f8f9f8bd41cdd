"""Reference metadata layer: FASTA -> 2-bit pack + contig/ambiguity records.

Functional equivalent of the reference's bntseq component
(src/bntseq.cpp: bns_fasta2bntseq/add1/bns_dump/bns_restore/bns_pos2rid/
bns_intv2rid). On-disk ``.pac``/``.ann``/``.amb`` files are byte/line
compatible with bwa/bwa-mem2/BWA-MEME so indexes can be cross-checked.

Ambiguous (non-ACGT) bases are replaced by pseudo-random bases drawn from a
POSIX lrand48() generator seeded with 11, exactly as the reference does
(src/bntseq.cpp:299,329), so the packed reference is bit-identical.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

from bwameme_tpu_torch.index.packing import NT4_TABLE, pack_pac, unpack_pac


class Lrand48:
    """POSIX lrand48: 48-bit LCG, returns top 31 bits. srand48(seed) sets
    X = seed<<16 | 0x330E."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 11) -> None:
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (self.x * self.A + self.C) & self.MASK
        return self.x >> 17

    def fill(self, n: int) -> np.ndarray:
        """Vectorized: n consecutive lrand48() draws."""
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        # Jump the LCG with a prefix scan: X_{i+1} = (A*X_i + C) mod 2^48.
        out = np.empty(n, dtype=np.uint64)
        x = self.x
        for i in range(n):  # LCG is inherently sequential; n per run is small-ish
            x = (x * self.A + self.C) & self.MASK
            out[i] = x >> 17
        self.x = x
        return out


@dataclasses.dataclass
class Contig:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0
    is_alt: bool = False


@dataclasses.dataclass
class AmbRecord:
    offset: int
    length: int
    amb: str


@dataclasses.dataclass
class BntSeq:
    """In-memory reference metadata + forward-strand 2-bit codes."""

    l_pac: int
    contigs: list[Contig]
    ambs: list[AmbRecord]
    seed: int = 11
    code: np.ndarray | None = None  # forward-strand 0..3 codes, len == l_pac

    @property
    def n_seqs(self) -> int:
        return len(self.contigs)

    @property
    def offsets(self) -> np.ndarray:
        return np.array([c.offset for c in self.contigs], dtype=np.int64)

    def pos2rid(self, pos_f: int) -> int:
        """Forward-strand position -> contig id; -1 if pos >= l_pac
        (reference: src/bntseq.cpp bns_pos2rid)."""
        if pos_f >= self.l_pac:
            return -1
        return int(np.searchsorted(self.offsets, pos_f, side="right") - 1)

    def intv2rid(self, rb: int, re: int) -> int:
        """Interval [rb,re) -> contig id, or -1 if it bridges contigs or the
        forward/reverse boundary (reference: src/bntseq.cpp bns_intv2rid)."""
        if rb < self.l_pac and re > self.l_pac:
            return -1
        fb = rb if rb < self.l_pac else (self.l_pac << 1) - 1 - rb
        fe = (re - 1) if (re - 1) < self.l_pac else (self.l_pac << 1) - 1 - (re - 1)
        if fb > fe:
            fb, fe = fe, fb
        rid_b = self.pos2rid(fb)
        rid_e = self.pos2rid(fe)
        return rid_b if rid_b == rid_e else -1

    def depos(self, pos: int) -> tuple[int, bool]:
        """Fold a [0,2*l_pac) coordinate onto the forward strand
        (reference: src/bntseq.h:89-92 bns_depos)."""
        is_rev = pos >= self.l_pac
        if is_rev:
            pos = (self.l_pac << 1) - 1 - pos
        return pos, is_rev


def _iter_fasta(path: str):
    op = gzip.open if path.endswith(".gz") else open
    name = None
    comment = ""
    chunks: list[bytes] = []
    with op(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                hdr = line[1:].split(None, 1)
                name = hdr[0].decode()
                comment = hdr[1].decode() if len(hdr) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


def fasta_to_bntseq(path: str) -> BntSeq:
    """Parse FASTA, build forward-strand code array + contig/amb metadata.

    Mirrors add1 (reference: src/bntseq.cpp:264-320): per-contig records,
    contiguous ambiguity runs keyed on the raw character, N -> lrand48()&3.
    """
    rng = Lrand48(seed=11)
    contigs: list[Contig] = []
    ambs: list[AmbRecord] = []
    codes: list[np.ndarray] = []
    offset = 0
    for name, comment, seq in _iter_fasta(path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        c = NT4_TABLE[raw]
        is_amb = c >= 4
        n_ambs = 0
        if is_amb.any():
            # Runs of ambiguity: a new record starts when the position is not
            # contiguous with the previous ambiguous one OR the raw character
            # differs (add1 keys runs on the raw char via `lasts`).
            idx = np.flatnonzero(is_amb)
            new_run = np.ones(len(idx), dtype=bool)
            if len(idx) > 1:
                contiguous = idx[1:] == idx[:-1] + 1
                same_char = raw[idx[1:]] == raw[idx[:-1]]
                new_run[1:] = ~(contiguous & same_char)
            run_starts = np.flatnonzero(new_run)
            run_ends = np.append(run_starts[1:], len(idx))
            for s, e in zip(run_starts, run_ends):
                ambs.append(
                    AmbRecord(offset + int(idx[s]), int(e - s), chr(raw[idx[s]]))
                )
                n_ambs += 1
            # replace ambiguous bases with lrand48()&3 in positional order
            draws = rng.fill(int(is_amb.sum()))
            c = c.copy()
            c[is_amb] = (draws & np.uint64(3)).astype(np.uint8)
        contigs.append(Contig(name, comment if comment else "(null)", offset, len(c), n_ambs))
        codes.append(c)
        offset += len(c)
    code = np.concatenate(codes) if codes else np.zeros(0, dtype=np.uint8)
    return BntSeq(l_pac=offset, contigs=contigs, ambs=ambs, code=code)


def dump(bns: BntSeq, prefix: str) -> None:
    """Write .pac/.ann/.amb in the reference's formats
    (src/bntseq.cpp bns_dump + pac finalization in bns_fasta2bntseq)."""
    pac = pack_pac(bns.code)
    with open(prefix + ".pac", "wb") as f:
        f.write(pac.tobytes())
        if bns.l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([bns.l_pac % 4]))
    with open(prefix + ".ann", "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.seed}\n")
        for c in bns.contigs:
            f.write(f"{c.gi} {c.name}")
            f.write(f" {c.anno}\n" if c.anno else "\n")
            f.write(f"{c.offset} {c.length} {c.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {len(bns.ambs)}\n")
        for a in bns.ambs:
            f.write(f"{a.offset} {a.length} {a.amb}\n")


def restore(prefix: str, load_pac: bool = True) -> BntSeq:
    """Load .ann/.amb(/.pac) written by dump() or by bwa/bwa-mem2/BWA-MEME."""
    contigs: list[Contig] = []
    with open(prefix + ".ann") as f:
        l_pac, n_seqs, seed = (int(x) for x in f.readline().split())
        for _ in range(n_seqs):
            hdr = f.readline().rstrip("\n").split(" ", 2)
            gi = int(hdr[0])
            name = hdr[1]
            anno = hdr[2] if len(hdr) > 2 else ""
            off, ln, na = (int(x) for x in f.readline().split())
            contigs.append(Contig(name, anno, off, ln, na, gi=gi))
    ambs: list[AmbRecord] = []
    if os.path.exists(prefix + ".amb"):
        with open(prefix + ".amb") as f:
            _, _, n_holes = (int(x) for x in f.readline().split())
            for _ in range(n_holes):
                parts = f.readline().split()
                ambs.append(AmbRecord(int(parts[0]), int(parts[1]), parts[2]))
    code = None
    if load_pac:
        raw = np.fromfile(prefix + ".pac", dtype=np.uint8)
        code = unpack_pac(raw, l_pac)
    return BntSeq(l_pac=l_pac, contigs=contigs, ambs=ambs, seed=seed, code=code)
