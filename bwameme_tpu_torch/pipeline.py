"""End-to-end alignment pipeline (the mem command) on PyTorch.

Port of bwameme_tpu/pipeline.py (reference: src/bwamem.cpp:1920-1971
mem_process_seqs):

  kernel 1: seeding (SMEMs) on the device engine (or the host
            engine), chaining in C++                             [worker_bwt]
  kernel 2: banded-SW extension on the device                   [worker_aln]
  kernel 3: dedup, primary marking, mapq, CIGAR, SAM in C++     [worker_sam]
            (single-end: the CIGARs' DP on the device)

Paired-end reads (align_pairs) run kernels 1-2 in batches of the engine's
lanes, dedup each read's regions in C++, take the insert-size statistics
over the whole chunk (or the fixed -I ones), then rescue mates and emit the
pairs: with the device engine, every mate-rescue SW of the chunk in one
call of the full-SW kernel (the reference's mem_sam_pe_batch path) and the
pairing and SAM in C++; with the host engine, the serial per-pair
pairing.sam_pe of the reference, its rescue SW on the host.

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
from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine
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
                 seeding_engine=None, rg_id: str | None = None,
                 copy_comment: bool = False, device="cuda",
                 batched_rescue: bool | None = None, pes0=None) -> None:
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
        # mate rescue: one batched full-SW call per chunk with a device
        # seeding engine, the serial per-pair path otherwise (the rule of
        # bwameme_tpu/pipeline.py:62-65)
        if batched_rescue is None:
            batched_rescue = seeding_engine is not None and hasattr(
                seeding_engine, "collect_smems_batch")
        self.batched_rescue = batched_rescue
        # one copy of the packed text on the device: the seeding engine's
        di = getattr(self.engine, "di", None)
        if di is not None and di.device.type != self.device.type:
            raise ValueError(f"seeding engine on {di.device}, aligner on "
                             f"{self.device}")
        self.text = di if di is not None else DeviceText.from_host(
            idx, self.device)

    def _encode(self, read: Read) -> ReadRec:
        codes = NT4_TABLE[np.frombuffer(read.seq.encode(), dtype=np.uint8)]
        comment = read.comment if self.copy_comment else None
        return ReadRec(read.name, codes, read.qual, comment)

    def _encode_batch(self, reads: list[Read]) -> list[ReadRec]:
        with tstage("encode"):
            return [self._encode(r) for r in reads]

    def collect_smems(self, recs: list[ReadRec]):
        """Kernel-1 seeding for a batch. A device engine returns the flat
        compacted struct (FlatSmems), which chaining consumes as it is, or
        per-read lists when the batch outgrew the packed buffer."""
        with tstage("seed.collect"):
            if hasattr(self.engine, "submit_batch"):
                return self._finish_seed(self._submit_seed(recs))
            return [self.engine.sorted_smems(r.codes) for r in recs]

    def _submit_seed(self, recs):
        with tstage("seed.submit"):
            return self.engine.submit_batch([r.codes for r in recs])

    def _finish_seed(self, token):
        with tstage("seed.finish"):
            smems = self.engine.finish_batch_flat(token)
            if smems is None:
                with tstage(UNPACKED):
                    smems = [sorted(sm, key=lambda s: (s.start, s.end))
                             for sm in self.engine.finish_batch(token)]
            return smems

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

    def _finalize_se(self, recs, regs) -> list[str]:
        """Kernel 3 in C++, split around the CIGARs' DP on the device, one
        launch a batch (align/finalize_split.py): dedup, primary marking,
        XA, SAM, finalize_se_c's byte for byte. ``regs``: the flat path's
        RegTable or AlnReg lists per read (the dataclass path's)."""
        with tstage("finalize"):
            out = finalize_split.finalize_se_split(
                self.opt, self.idx.bns, self.idx.text, self.text.text32,
                recs, regs, self.rg_id, self.n_processed)
        self.n_processed += len(recs)
        return out

    def _finish(self, recs, token) -> list[str]:
        with tstage("extend.finish"):
            regs = self._kernel2_finish(token)
        return self._finalize_se(recs, regs)

    def align_batch(self, reads: list[Read]) -> list[str]:
        """Align a batch of single-end reads; returns SAM line blocks (one
        string per read, possibly multi-line)."""
        recs = self._encode_batch(reads)
        smems = self.collect_smems(recs)
        with tstage("extend.submit"):
            token = self._kernel2_submit(recs, smems)
        return self._finish(recs, token)

    def align_stream(self, batches):
        """Align an iterable of read batches, yielding SAM blocks per batch
        in order. With a device engine the device runs

          seed(k) . extend(k) . seed(k+1) . extend(k+1) . ...

        For batch k the host waits on seed(k), chains, launches extend(k)
        and only then submits seed(k+1), so extension is never queued behind
        the next batch's seeding, and the host's retry ladder and
        finalization of batch k overlap seed(k+1) on the device. With the
        host engine the host seeds batch k+1 while the device extends
        batch k."""
        if not hasattr(self.engine, "submit_batch"):
            yield from self._align_stream_host_seeding(batches)
            return
        pending = None
        for reads in batches:
            recs = self._encode_batch(reads)
            if pending is None:
                pending = (recs, self._submit_seed(recs))
                continue
            sam, token = self._finish_stream(pending, recs)
            yield sam
            pending = (recs, token)
        if pending is not None:
            yield self._finish_stream(pending, None)[0]

    def _finish_stream(self, item, next_recs):
        """One pipelined batch: returns its SAM blocks and the seeding token
        of next_recs, submitted between this batch's extension launch and
        its finish."""
        recs, token = item
        smems = self._finish_seed(token)
        with tstage("extend.submit"):
            k2 = self._kernel2_submit(recs, smems)
        next_token = self._submit_seed(next_recs) if next_recs else None
        return self._finish(recs, k2), next_token

    def _align_stream_host_seeding(self, batches):
        pending = None
        for reads in batches:
            recs = self._encode_batch(reads)
            smems = self.collect_smems(recs)
            if pending is not None:
                yield self._finish(*pending)
            with tstage("extend.submit"):
                pending = (recs, self._kernel2_submit(recs, smems))
        if pending is not None:
            yield self._finish(*pending)

    def align_pairs(self, reads: list[Read]) -> list[str]:
        """Align interleaved paired-end reads (R1, R2, R1, R2, ...); returns
        SAM line blocks per read (reference: mem_process_seqs' PE flow)."""
        if len(reads) % 2:
            raise ValueError(f"{len(reads)} reads: paired-end reads come "
                             "in pairs")
        recs = self._encode_batch(reads)
        deduped = self._pe_kernels(recs)
        with tstage("pe.pestat"):
            pes = (self.pes0 if self.pes0 is not None
                   else pairing.pestat(self.opt, self.idx.bns.l_pac, deduped))
        return self._pe_finalize(recs, deduped, pes)

    def _pe_kernels(self, recs: list[ReadRec]) -> list[list]:
        """Kernels 1-2 and the dedup of each read's regions, in batches of
        the engine's lanes; with a device engine pipelined as align_stream:
        seed(k+1) is submitted between extend(k)'s launch and its finish."""
        opt, idx = self.opt, self.idx
        device_seeding = hasattr(self.engine, "submit_batch")
        bsz = getattr(self.engine, "lanes", None) or len(recs) or 1
        parts = [recs[b0: b0 + bsz] for b0 in range(0, len(recs), bsz)]
        deduped = []
        token = (self._submit_seed(parts[0]) if parts and device_seeding
                 else None)
        for k, part in enumerate(parts):
            smems = (self._finish_seed(token) if device_seeding
                     else self.collect_smems(part))
            with tstage("extend.submit"):
                k2 = self._kernel2_submit(part, smems)
            if device_seeding and k + 1 < len(parts):
                token = self._submit_seed(parts[k + 1])
            with tstage("extend.finish"):
                regs_per_read = self._kernel2_finish(k2)
                if isinstance(regs_per_read, extend_mod.RegTable):
                    regs_per_read = regs_per_read.to_lists()
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

    def _pe_finalize(self, recs: list[ReadRec], deduped, pes) -> list[str]:
        """Mate rescue, pairing and SAM for an interleaved chunk whose
        kernels ran (_pe_kernels), under the insert statistics pes."""
        opt, idx = self.opt, self.idx
        bns, text = idx.bns, idx.text
        pair_id0 = self.n_processed >> 1
        if self.batched_rescue:
            with tstage("pe.rescue"):
                recs_pairs = [(recs[i], recs[i + 1])
                              for i in range(0, len(recs), 2)]
                regs_pairs = [[deduped[i], deduped[i + 1]]
                              for i in range(0, len(recs), 2)]
                pairing.sam_pe_batch_rescue(opt, bns, text, pes, recs_pairs,
                                            regs_pairs, self.text.text32)
            with tstage("pe.finalize"):
                out = native.finalize_pe_native(opt, bns, text, pes,
                                                pair_id0, recs, deduped,
                                                self.rg_id)
            if out is None:
                raise RuntimeError("native finalization unavailable")
        else:
            with tstage("pe.finalize"):
                out = []
                for i in range(0, len(recs), 2):
                    out.extend(pairing.sam_pe(
                        opt, bns, text, pes, pair_id0 + (i >> 1),
                        [recs[i], recs[i + 1]], [deduped[i], deduped[i + 1]],
                        rg_id=self.rg_id))
        self.n_processed += len(recs)
        return out
