"""SAM output: header and record formatting.

Functional analog of bwa_print_sam_hdr (reference: src/bwa.cpp) and
mem_aln2sam (reference: src/bwamem.cpp:2174). Field order, flag semantics and
optional-tag order (NM, MD, AS, XS, RG, SA, XA) follow the reference so SAM
diffs against bwa-mem2 output are meaningful.
"""

from __future__ import annotations

import dataclasses

from bwameme_tpu_torch.index.bntseq import BntSeq

# SAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


def sam_header(bns: BntSeq, rg_line: str | None = None, pg_line: str | None = None,
               extra_hdr: str | None = None) -> str:
    lines = []
    for c in bns.contigs:
        lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
    if rg_line:
        lines.append(rg_line)
    if extra_hdr:
        lines.append(extra_hdr)
    if pg_line:
        lines.append(pg_line)
    return "\n".join(lines) + "\n" if lines else ""


def make_pg_line(version: str, cmdline: str) -> str:
    return f"@PG\tID:bwameme-tpu\tPN:bwameme-tpu\tVN:{version}\tCL:{cmdline}"


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str = "*"
    pos: int = 0          # 1-based leftmost
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[str] = dataclasses.field(default_factory=list)

    def format(self) -> str:
        fields = [
            self.qname, str(self.flag), self.rname, str(self.pos),
            str(self.mapq), self.cigar, self.rnext, str(self.pnext),
            str(self.tlen), self.seq, self.qual,
        ]
        return "\t".join(fields + self.tags)


_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def cigar_to_string(cigar: list[tuple[int, int]]) -> str:
    """cigar ops as (op, len) with op in 0..4 = MIDSH."""
    if not cigar:
        return "*"
    return "".join(f"{ln}{'MIDSH'[op]}" for op, ln in cigar)
