"""Data-parallel alignment over rows of devices, each row a sharded index.

Port of bwameme_tpu/parallel/dp.py. The distributed design has two axes:

* ``idx``, the index axis: each row's engine holds the whole index with its
  per-suffix planes in rank blocks over the row's devices (index/device.py
  ShardedPlane; seeding/engine.py ``shards=``), and cuts each batch it
  seeds into a slice a card of the row. A row with one device holds the
  whole index on it.
* ``dp``, the data axis: a chunk of reads is split into one contiguous
  slice a row. No row waits for another while it aligns: reads are
  independent, as the reference scales with threads (kt_for 512-read
  blocks, src/kthread.cpp:41-77).

The host drives the rows: every row's seeding is submitted before any row's
results are awaited (submission does not wait for the device, so rows on
different cards seed at the same time), then each row chains, extends and
finalizes its slice in row order. The SAM is the slices' in order and equals
a single-device run byte for byte: each row's reads take their global
offset in the chunk (the tie-breaking hash of mem_mark_primary_se,
reference src/bwamem.cpp:2002, and the pair ids), and paired-end insert
statistics are taken over the whole chunk, every row's regions, before any
row finalizes (the reference's chunk-wide mem_pestat, src/bwamem_pair.cpp
:81).
"""

from __future__ import annotations

import torch

from bwameme_tpu_torch.align import pairing
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.utils.config import MemOptions


def visible_devices() -> list[torch.device]:
    """The cards this process sees, in order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_dp_mesh(n_dp: int, n_idx: int, devices=None) -> list[list]:
    """n_dp rows of n_idx devices each over the first n_dp * n_idx devices
    (by default the visible cards); raises if there are fewer."""
    devices = list(visible_devices() if devices is None else devices)
    need = n_dp * n_idx
    if len(devices) < need:
        raise ValueError(f"dp x idx = {n_dp}x{n_idx} needs {need} devices, "
                         f"have {len(devices)}")
    return [[torch.device(d) for d in devices[r * n_idx: (r + 1) * n_idx]]
            for r in range(n_dp)]


def slices(n: int, k: int, even: bool = False) -> list[tuple[int, int]]:
    """Contiguous balanced slices of [0, n), k of them; ``even`` keeps the
    boundaries on pair boundaries (interleaved pairs)."""
    per = -(-n // k)
    if even and per % 2:
        per += 1
    out = []
    b = 0
    for _ in range(k):
        e = min(n, b + per)
        out.append((b, e))
        b = e
    return out


class DataParallelAligner:
    """An Aligner a row of the mesh, each over its own engine; a chunk is
    scattered as contiguous slices and the SAM gathered in order."""

    def __init__(self, idx, opt: MemOptions | None = None, mesh=None,
                 engine_factory=None, **aligner_kw) -> None:
        """mesh: rows of devices (make_dp_mesh). engine_factory(row) -> the
        seeding engine of one row, given the row's devices; by default the
        device engine over the row, its index sharded when the row has more
        than one device. Each row's Aligner runs on its row's first device."""
        if not mesh or any(len(row) != len(mesh[0]) or not row
                           for row in mesh):
            raise ValueError("DataParallelAligner needs rows of devices of "
                             "one length (make_dp_mesh)")
        self.opt = opt or MemOptions()
        if engine_factory is None:
            from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine

            def engine_factory(row):
                return DeviceSeedingEngine(
                    idx, self.opt, device=row[0],
                    shards=row if len(row) > 1 else None)

        self.mesh = mesh
        self.rows: list[Aligner] = []
        for row in mesh:
            eng = engine_factory(row)
            self.rows.append(Aligner(idx, self.opt, seeding_engine=eng,
                                     device=row[0], **aligner_kw))
        self.n_dp = len(self.rows)
        self.n_processed = 0

    def align_batch(self, reads) -> list[str]:
        """A single-end chunk: every row's seeding is submitted first, then
        each row chains, extends and finalizes its slice in order."""
        pend = []
        for (b, e), row in zip(slices(len(reads), self.n_dp), self.rows):
            recs = row.encode(reads[b:e])
            pend.append((row, b, recs, row.seed(recs) if recs else None))
        out: list[str] = []
        for row, b, recs, tok in pend:
            if recs:    # global ids for hash ties
                out.extend(row.sam_se(recs, row.regions(recs, tok),
                                      self.n_processed + b))
        self.n_processed += len(reads)
        return out

    def align_stream(self, batches):
        """Streamed single-end alignment: each batch scattered across the
        rows (align_batch); one SAM block list a batch, in order."""
        for reads in batches:
            yield self.align_batch(reads)

    def align_pairs(self, reads) -> list[str]:
        """An interleaved paired-end chunk: each row's kernels on a
        pair-aligned slice, insert statistics over every row's regions,
        then each row's rescue and finalization with global pair ids."""
        if len(reads) % 2:
            raise ValueError(f"{len(reads)} reads: paired-end reads come "
                             "in pairs")
        parts = []
        for (b, e), row in zip(slices(len(reads), self.n_dp, even=True),
                               self.rows):
            recs = row.encode(reads[b:e])
            parts.append((row, b, recs, row.pe_regions(recs)))
        all_regs = [regs for _, _, _, dd in parts for regs in dd]
        pes = (self.rows[0].pes0 if self.rows[0].pes0 is not None
               else pairing.pestat(self.opt, self.rows[0].idx.bns.l_pac,
                                   all_regs))
        out: list[str] = []
        for row, b, recs, deduped in parts:
            if recs:    # global pair ids
                out.extend(row.sam_pe(recs, deduped, pes,
                                      self.n_processed + b))
        self.n_processed += len(reads)
        return out
