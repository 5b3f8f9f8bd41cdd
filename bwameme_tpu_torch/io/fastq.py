"""Chunked FASTQ/FASTA read input.

Functional analog of bseq_read_orig (reference: src/bwa.cpp:184) + kseq:
reads ~chunk_size base pairs per pipeline step (the ``-K`` reproducibility
knob, reference: src/fastmap.cpp:1582-1588); paired files are interleaved
record-by-record. Supports plain and gzip files.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator

from bwameme_tpu_torch.utils.timer import tstage


@dataclasses.dataclass
class Read:
    name: str
    seq: str
    qual: str | None
    comment: str | None = None
    id: int = 0


def _open(path: str):
    """Open a reads source: plain file, .gz, '-' for stdin, or an
    http(s)/ftp/file URL — the full source set of the reference's kopen
    (src/kopen.cpp: file/pipe at :49-60, http at :250-313, ftp at :134-248).
    URL streams are wrapped for line iteration and gunzipped when the path
    ends in .gz."""
    if path == "-":
        import sys

        return sys.stdin
    if path.split(":", 1)[0] in ("http", "https", "ftp", "file"):
        import io
        import urllib.request

        raw = urllib.request.urlopen(path)
        if path.split("?", 1)[0].endswith(".gz"):
            return io.TextIOWrapper(gzip.GzipFile(fileobj=raw))
        return io.TextIOWrapper(raw)
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path, "rt")


def _iter_records(path: str) -> Iterator[Read]:
    """Parse FASTQ or FASTA records (auto-detected per record, like kseq)."""
    with _open(path) as f:
        line = f.readline()
        while line:
            line = line.rstrip("\n")
            if not line:
                line = f.readline()
                continue
            if line.startswith("@"):  # FASTQ
                hdr = line[1:].split(None, 1)
                name = hdr[0]
                comment = hdr[1] if len(hdr) > 1 else None
                seq = f.readline().rstrip("\n")
                f.readline()  # +
                qual = f.readline().rstrip("\n")
                yield Read(name, seq, qual, comment)
            elif line.startswith(">"):  # FASTA
                hdr = line[1:].split(None, 1)
                name = hdr[0]
                comment = hdr[1] if len(hdr) > 1 else None
                chunks = []
                pos = f.tell()
                nxt = f.readline()
                while nxt and not nxt.startswith(">") and not nxt.startswith("@"):
                    chunks.append(nxt.rstrip("\n"))
                    pos = f.tell()
                    nxt = f.readline()
                f.seek(pos)
                yield Read(name, "".join(chunks), None, comment)
            line = f.readline()


def read_chunks(
    path1: str,
    path2: str | None = None,
    chunk_bp: int = 10_000_000,
    keep_pairs: bool = False,
) -> Iterator[list[Read]]:
    """Yield batches of reads totalling >= chunk_bp base pairs (last one
    smaller). With a second file, records are interleaved 1:1 (paired-end),
    and the chunk boundary always falls on an even record count — matching the
    reference's deterministic chunking contract for ``-K``. keep_pairs keeps
    chunk boundaries even for a single interleaved file (smart pairing -p).

    Each chunk's parse is the stage ``io.parse``: from the generator's
    resumption to its yield, so the consumer's time between chunks is not
    in it."""
    chunks = _chunks(path1, path2, chunk_bp, keep_pairs)
    while True:
        with tstage("io.parse"):
            batch = next(chunks, None)
        if batch is None:
            return
        yield batch


def _chunks(path1, path2, chunk_bp, keep_pairs) -> Iterator[list[Read]]:
    it1 = _iter_records(path1)
    it2 = _iter_records(path2) if path2 else None
    batch: list[Read] = []
    size = 0
    rid = 0
    for r1 in it1:
        r1.id = rid
        rid += 1
        batch.append(r1)
        size += len(r1.seq)
        if it2 is not None:
            r2 = next(it2, None)
            if r2 is None:
                raise ValueError("paired FASTQ files have unequal record counts")
            r2.id = rid
            rid += 1
            batch.append(r2)
            size += len(r2.seq)
        if size >= chunk_bp and not (keep_pairs and len(batch) % 2):
            yield batch
            batch, size = [], 0
    if batch:
        yield batch
