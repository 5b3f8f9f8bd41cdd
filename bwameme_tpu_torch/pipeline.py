"""End-to-end alignment pipeline (the mem command) on PyTorch.

Port of bwameme_tpu/pipeline.py (reference: src/bwamem.cpp:1920-1971
mem_process_seqs):

  kernel 1: seeding (SMEMs) on the device engine (or the host
            engine), chaining in C++                             [worker_bwt]
  kernel 2: banded-SW extension on the device                   [worker_aln]
  kernel 3: dedup, primary marking, mapq, CIGAR, SAM in C++     [worker_sam]
            (single-end: the CIGARs' DP on the device)

The Aligner reaches its engine only through the seeding contract
(seeding/host_engine.SeedingEngine), never by probing it. Kernels 1-2 run
in one batch loop (``_batches``) for single-end streams and for the lane
batches of a paired-end chunk alike, with any of the four engines.

Paired-end reads (align_pairs) run kernels 1-2 in batches of the engine's
lanes, dedup each read's regions in C++, take the insert-size statistics
over the whole chunk (or the fixed -I ones), then rescue mates and emit the
pairs: with a scalar oracle for an engine, the serial per-pair
pairing.sam_pe of bwa 0.7.17 (mem_sam_pe), its rescue SW on the host; with
any other engine, every mate-rescue SW of the chunk in one call of the
full-SW kernel (bwa-mem2's mem_sam_pe_batch) and the pairing and SAM in
C++.

The phases are public for the callers that split a chunk (parallel/dp.py,
parallel/multihost.py): ``encode``, ``seed``, ``regions``, ``sam_se``,
``pe_regions`` and ``sam_pe``, each SAM phase at an explicit read offset,
which finalize's tie-breaking hash and the pair ids read. Only
``align_batch``, ``align_stream`` and ``align_pairs`` keep and advance
``n_processed``, the offset of the next read of the run.

With a device seeding engine the index's packed text is on the device once:
extension reads the engine's ``di.text32``. Kernel 2 goes through the flat
path whenever seed re-scoring is a no-op (short reads) and through the
dataclass path otherwise. The flat path hands its regions on as arrays
(extend.RegTable), which the single-end finalize reads as they are; the
paired-end path builds AlnReg objects from them (RegTable.to_lists) for the
dedup, pairing and rescue. Finalization needs the native host library;
without it the Aligner raises rather than take a slower path, and a kernel
that fails to build or launch is an error, never a reason to change tier.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwameme_tpu_torch.align import chain as chain_mod
from bwameme_tpu_torch.align import finalize_split, native, pairing
from bwameme_tpu_torch.index.build import MemeIndex
from bwameme_tpu_torch.index.packing import NT4_TABLE
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.seeding.host_engine import (HostSeedingEngine,
                                                   SeedingEngine,
                                                   sorted_by_span)
from bwameme_tpu_torch.utils.config import MemOptions
from bwameme_tpu_torch.utils.timer import tstage
from bwameme_tpu_torch.align import extend as extend_mod
from bwameme_tpu_torch.index.device import DeviceText

# the stage of a batch that outgrew the packed SMEM buffer: its whole slot
# planes fetched, an Smem an emission (the benchmark reads it as 0 where
# seeding ran and it did not)
UNPACKED = "seed.unpacked"


@dataclasses.dataclass
class ReadRec:
    name: str
    codes: np.ndarray
    qual: str | None
    comment: str | None


class Aligner:
    def __init__(self, idx: MemeIndex, opt: MemOptions | None = None,
                 seeding_engine: SeedingEngine | None = None,
                 rg_id: str | None = None, copy_comment: bool = False,
                 device="cuda", pes0=None) -> None:
        if not native.available():
            raise RuntimeError(
                "bwameme_tpu_torch needs the native host library "
                "(native/hostkernels.cpp, built with g++ at first use)"
            ) from native.load_error()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.idx = idx
        self.opt = opt or MemOptions()
        self.engine = seeding_engine or HostSeedingEngine(idx, self.opt)
        self.rg_id = rg_id
        self.copy_comment = copy_comment
        self.n_processed = 0
        # -I: a fixed insert-size distribution instead of the chunk's
        # (reference: src/fastmap.cpp:1346-1360, src/bwamem.cpp:1951-1953)
        self.pes0 = pes0
        # one copy of the packed text on the device: the seeding engine's
        di = self.engine.di
        if di is not None and di.device.type != self.device.type:
            raise ValueError(f"seeding engine on {di.device}, aligner on "
                             f"{self.device}")
        self.text = di if di is not None else DeviceText.from_host(
            idx, self.device)

    # ------------------------------------------------------------- phases
    def _encode(self, read: Read) -> ReadRec:
        codes = NT4_TABLE[np.frombuffer(read.seq.encode(), dtype=np.uint8)]
        comment = read.comment if self.copy_comment else None
        return ReadRec(read.name, codes, read.qual, comment)

    def encode(self, reads: list[Read]) -> list[ReadRec]:
        """A batch's reads as codes (ReadRec), what every later phase
        takes."""
        with tstage("encode"):
            return [self._encode(r) for r in reads]

    def seed(self, recs: list[ReadRec]):
        """Submit a batch's seeding; returns the token ``regions`` takes. A
        device engine returns without waiting for the device."""
        with tstage("seed.submit"):
            return self.engine.submit_batch([r.codes for r in recs])

    def regions(self, recs: list[ReadRec], token=None):
        """The regions of one batch: kernels 1-2, seeding submitted here
        unless ``token`` (``seed``'s) says it is; extend.RegTable from the
        flat path, AlnReg lists per read from the dataclass path."""
        return next(self._batches([recs], token))[1]

    def sam_se(self, recs: list[ReadRec], regs, n0: int) -> list[str]:
        """The SAM blocks (one string a read, possibly multi-line) of a
        single-end batch whose first read is read ``n0`` of the run. Kernel
        3 in C++, split around the CIGARs' DP on the device, one launch a
        batch (align/finalize_split.py): dedup, primary marking, XA, SAM,
        finalize_se_c's byte for byte."""
        with tstage("finalize"):
            return finalize_split.finalize_se_split(
                self.opt, self.idx.bns, self.idx.text, self.text.text32,
                recs, regs, self.rg_id, n0)

    def pe_regions(self, recs: list[ReadRec]) -> list[list]:
        """The deduplicated regions of an interleaved chunk, an AlnReg list
        a read: kernels 1-2 in batches of the engine's lanes (the whole
        chunk where it has none), each batch's dedup in C++."""
        opt, idx = self.opt, self.idx
        bsz = self.engine.lanes or len(recs) or 1
        parts = (recs[b0: b0 + bsz] for b0 in range(0, len(recs), bsz))
        deduped = []
        for part, regs_per_read in self._batches(parts, lists=True):
            with tstage("pe.dedup"):
                dd = native.dedup_batch_native(opt, idx.bns, idx.text, part,
                                               regs_per_read)
                if dd is None:
                    raise RuntimeError("native finalization unavailable")
                for regs in dd:
                    for r in regs:
                        if r.rid >= 0 and idx.bns.contigs[r.rid].is_alt:
                            r.is_alt = True
                    deduped.append(regs)
        return deduped

    def sam_pe(self, recs: list[ReadRec], deduped, pes, n0: int
               ) -> list[str]:
        """Mate rescue, pairing and SAM of an interleaved chunk whose first
        read is read ``n0`` of the run, from its deduplicated regions
        (``pe_regions``) under the insert statistics ``pes``. A scalar
        oracle for an engine takes the serial per-pair path, any other the
        chunk's rescue in one call (the module's docstring)."""
        opt, idx = self.opt, self.idx
        bns, text = idx.bns, idx.text
        pair_id0 = n0 >> 1
        if self.engine.scalar_oracle:
            with tstage("pe.finalize"):
                out = []
                for i in range(0, len(recs), 2):
                    out.extend(pairing.sam_pe(
                        opt, bns, text, pes, pair_id0 + (i >> 1),
                        [recs[i], recs[i + 1]], [deduped[i], deduped[i + 1]],
                        rg_id=self.rg_id))
            return out
        with tstage("pe.rescue"):
            recs_pairs = [(recs[i], recs[i + 1])
                          for i in range(0, len(recs), 2)]
            regs_pairs = [[deduped[i], deduped[i + 1]]
                          for i in range(0, len(recs), 2)]
            pairing.sam_pe_batch_rescue(opt, bns, text, pes, recs_pairs,
                                        regs_pairs, self.text.text32)
        with tstage("pe.finalize"):
            out = native.finalize_pe_native(opt, bns, text, pes, pair_id0,
                                            recs, deduped, self.rg_id)
        if out is None:
            raise RuntimeError("native finalization unavailable")
        return out

    # the streams reach the SAM phases by these names (the benchmark's
    # fault checks patch them)
    _finalize_se, _pe_finalize = sam_se, sam_pe

    # ---------------------------------------------------------- the loop
    def _batches(self, batches, token=None, lists=False):
        """The one batch loop of kernels 1-2: yields (recs, regions) for
        each encoded batch of ``batches``, drawn one ahead. The device
        runs

          seed(k) . extend(k) . seed(k+1) . extend(k+1) . ...

        For batch k the host draws batch k+1, waits on seed(k), chains,
        launches extend(k) and only then submits seed(k+1), so extension is
        never queued behind the next batch's seeding, and the host's retry
        ladder and what the caller does with batch k's regions overlap
        seed(k+1) on the device. A scalar oracle seeds batch k+1 on the
        host while the device extends batch k. ``token``: the first
        batch's seeding, where it is already submitted; ``lists``: the
        regions as AlnReg lists per read, made inside extend.finish."""
        it = iter(batches)
        recs = next(it, None)
        if recs is None:
            return
        if token is None:
            token = self.seed(recs)
        while True:
            nxt = next(it, None)
            smems = self._finish_seed(token)
            with tstage("extend.submit"):
                k2 = self._kernel2_submit(recs, smems)
            if nxt is not None:
                token = self.seed(nxt)
            with tstage("extend.finish"):
                regs = self._kernel2_finish(k2)
                if lists and isinstance(regs, extend_mod.RegTable):
                    regs = regs.to_lists()
            yield recs, regs
            if nxt is None:
                return
            recs = nxt

    def _finish_seed(self, token):
        """A batch's SMEMs, flat, or per-read lists when the batch outgrew
        the engine's packed buffer."""
        with tstage("seed.finish"):
            smems = self.engine.finish_batch_flat(token)
            if smems is None:
                with tstage(UNPACKED):
                    smems = [sorted_by_span(sm)
                             for sm in self.engine.finish_batch(token)]
            return smems

    def _kernel2_submit(self, recs, smems_per_read):
        """Chaining and the launch of the extension; returns a token for
        _kernel2_finish without waiting for the device."""
        opt, idx = self.opt, self.idx
        queries = [r.codes for r in recs]
        sa = self.engine.sa_positions
        if extend_mod.rescore_is_noop(opt, queries):
            with tstage("chain"):
                raw = chain_mod.chain_and_filter_raw(
                    opt, idx.bns, queries, smems_per_read, sa)
            if raw is not None:  # None: the batch has no seeds at all
                return ("flat", extend_mod.extend_flat_submit(
                    opt, idx.bns, queries, raw, self.text))
        with tstage("chain"):
            chains_per_read = chain_mod.chain_and_filter_batch(
                opt, idx.bns, queries, smems_per_read, sa)
            for q, chains in zip(queries, chains_per_read):
                chain_mod.filter_chained_seeds(opt, idx.bns, idx.text, q,
                                               len(q), chains)
        return ("chains", (queries, chains_per_read))

    def _kernel2_finish(self, token):
        kind, tok = token
        if kind == "flat":
            return extend_mod.extend_flat_finish(tok)
        queries, chains_per_read = tok
        return extend_mod.extend_chains_batch(
            self.opt, self.idx.bns, self.idx.text, queries, chains_per_read,
            self.device)

    # ----------------------------------------------------------- the runs
    def align_batch(self, reads: list[Read]) -> list[str]:
        """Align a batch of single-end reads; returns SAM line blocks (one
        string per read, possibly multi-line)."""
        return next(self.align_stream([reads]))

    def align_stream(self, batches):
        """Align an iterable of read batches, yielding SAM blocks per batch
        in order, each batch finalized while the next one's seeding runs
        (``_batches``)."""
        encoded = (self.encode(reads) for reads in batches)
        for recs, regs in self._batches(encoded):
            sam = self._finalize_se(recs, regs, self.n_processed)
            self.n_processed += len(recs)
            yield sam

    def align_pairs(self, reads: list[Read]) -> list[str]:
        """Align interleaved paired-end reads (R1, R2, R1, R2, ...); returns
        SAM line blocks per read (reference: mem_process_seqs' PE flow)."""
        if len(reads) % 2:
            raise ValueError(f"{len(reads)} reads: paired-end reads come "
                             "in pairs")
        recs = self.encode(reads)
        deduped = self.pe_regions(recs)
        with tstage("pe.pestat"):
            pes = (self.pes0 if self.pes0 is not None
                   else pairing.pestat(self.opt, self.idx.bns.l_pac, deduped))
        out = self._pe_finalize(recs, deduped, pes, self.n_processed)
        self.n_processed += len(recs)
        return out
