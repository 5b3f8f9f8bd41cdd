"""End-to-end single-end alignment pipeline (the mem command) on PyTorch.

Port of bwameme_tpu/pipeline.py for single-end reads (reference:
src/bwamem.cpp:1920-1971 mem_process_seqs):

  kernel 1: seeding (SMEMs) on the host engine, chaining in C++  [worker_bwt]
  kernel 2: banded-SW extension on the device                   [worker_aln]
  kernel 3: dedup, primary marking, mapq, CIGAR, SAM in C++     [worker_sam]

Kernel 2 goes through the flat path whenever seed re-scoring is a no-op
(short reads), against the packed text resident on the device, and through
the dataclass path otherwise. Finalization needs the native host library;
without it the Aligner raises rather than take a slower path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwameme_tpu.align import chain as chain_mod
from bwameme_tpu.align import native
from bwameme_tpu.index.build import MemeIndex
from bwameme_tpu.index.packing import NT4_TABLE
from bwameme_tpu.io.fastq import Read
from bwameme_tpu.seeding.host_engine import HostSeedingEngine
from bwameme_tpu.utils.config import MemOptions
from bwameme_tpu.utils.timer import tstage
from bwameme_tpu_torch.align import extend as extend_mod
from bwameme_tpu_torch.index.device import DeviceText


@dataclasses.dataclass
class ReadRec:
    name: str
    codes: np.ndarray
    qual: str | None
    comment: str | None


class Aligner:
    def __init__(self, idx: MemeIndex, opt: MemOptions | None = None,
                 seeding_engine=None, rg_id: str | None = None,
                 copy_comment: bool = False, device="cuda") -> None:
        if not native.available():
            raise RuntimeError(
                "bwameme_tpu_torch needs the native host library "
                "(native/hostkernels.cpp, built with g++ at first use)")
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
        self.text = DeviceText.from_host(idx, self.device)

    def _encode(self, read: Read) -> ReadRec:
        codes = NT4_TABLE[np.frombuffer(read.seq.encode(), dtype=np.uint8)]
        comment = read.comment if self.copy_comment else None
        return ReadRec(read.name, codes, read.qual, comment)

    def collect_smems(self, recs: list[ReadRec]):
        """Kernel-1 seeding for a batch on the host engine."""
        with tstage("seed.collect"):
            return [self.engine.sorted_smems(r.codes) for r in recs]

    def _kernel2_submit(self, recs, smems_per_read):
        """Chaining and the launch of the extension; returns a token for
        _kernel2_finish without waiting for the device."""
        opt, idx = self.opt, self.idx
        queries = [r.codes for r in recs]
        sa = getattr(self.engine, "sa_positions", idx.sa)
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

    def _finalize_se(self, recs, regs_per_read) -> list[str]:
        """Kernel 3 in C++ (native.finalize_se_c): dedup, primary marking,
        XA, SAM."""
        with tstage("finalize"):
            out = native.finalize_se_native(
                self.opt, self.idx.bns, self.idx.text, recs, regs_per_read,
                self.rg_id, self.n_processed)
        if out is None:
            raise RuntimeError("native finalization unavailable")
        self.n_processed += len(recs)
        return out

    def _finish(self, recs, token) -> list[str]:
        with tstage("extend.finish"):
            regs_per_read = self._kernel2_finish(token)
        return self._finalize_se(recs, regs_per_read)

    def align_batch(self, reads: list[Read]) -> list[str]:
        """Align a batch of single-end reads; returns SAM line blocks (one
        string per read, possibly multi-line)."""
        recs = [self._encode(r) for r in reads]
        smems = self.collect_smems(recs)
        with tstage("extend.submit"):
            token = self._kernel2_submit(recs, smems)
        return self._finish(recs, token)

    def align_stream(self, batches):
        """Align an iterable of read batches, yielding SAM blocks per batch
        in order. The host seeds batch k+1 while the device extends batch k:
        extension is launched, not awaited, before the next batch's seeding.
        """
        pending = None
        for reads in batches:
            recs = [self._encode(r) for r in reads]
            smems = self.collect_smems(recs)
            if pending is not None:
                yield self._finish(*pending)
            with tstage("extend.submit"):
                pending = (recs, self._kernel2_submit(recs, smems))
        if pending is not None:
            yield self._finish(*pending)

    def align_pairs(self, reads: list[Read]) -> list[str]:
        raise NotImplementedError(
            "paired-end alignment is not ported yet (ROADMAP Queue 1 item 9)")
