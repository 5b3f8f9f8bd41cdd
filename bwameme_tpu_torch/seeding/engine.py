"""Batched device seeding engine on PyTorch.

Port of ``DeviceSeedingEngine`` (bwameme_tpu/seeding/engine.py) for the
learned index (the P-RMI root) on one device, in every memory mode (1-4) and
in narrow (int32) or wide (int64) coordinates (index/device.py); wide slot
planes carry sa_lo and the hitcount as int64, read coordinates stay small.
A batch is prepared on the device
(ops/seed_smem.prepare_reads), seeded by the three rounds - on a CUDA device
the hand-written kernels, one launch a round, a warp running one read's
state machine to its end, its lanes probing a whole P-RMI window's ranks in
one step; on the CPU the plain versions - and packed into one flat buffer,
so a batch costs one host-to-device and one device-to-host copy. Nothing
waits for the device between ``submit_batch`` and ``finish_batch_flat``: the
caller overlaps a batch's seeding with the previous batch's host work.

The kernels are designed for batches of up to about 32k reads: a warp a read
shortens each read's chain of dependent loads, which is what a small batch
waits for, and repeats the state machine's scalar work in every lane. On an
H100, against one thread a read, the three rounds take 0.3 of the card time
at 4096 reads, the same at 32768, and 1.4 times as much at 65536, where one
thread a read has enough loads in flight (PERF.md, section 6).

Produces the SMEM sets of ``HostSeedingEngine`` (the scalar contract), which
stays the independent oracle and is never called from here. The read length
is a runtime argument up to the learned path's 500 bp cap; none of the
reference's compile tiers, straggler compaction or fused/host-driven
fallbacks exists here. A kernel that fails to build or launch raises.

Capacities are the reference's: 96 emission slots a read in rounds 1 and 3,
16 in round 2, 24 packed entries a read on average (a larger batch result is
fetched as whole slot planes instead). An emission that finds no slot is
dropped, as the reference drops it (bwameme_tpu/seeding/engine.py, the
rounds' slot writes): the read keeps the SMEMs that found one.
``dropped_smems`` counts the dropped ones over the engine's life, and a
batch that drops any says so on stderr.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from bwameme_tpu_torch.index.device import DeviceIndex
from bwameme_tpu_torch.ops import seed_smem
from bwameme_tpu_torch.seeding.host_engine import FlatSmems, Smem
from bwameme_tpu_torch.utils.timer import tstage

# the learned seeding path's read-length cap (reference:
# LEARNED_MAX_READ_LEN, src/macro.h:54); the packed transfer encodes end
# coordinates in 10 bits
MAX_READ_LEN = 512


class DeviceSeedingEngine:
    def __init__(self, idx, opt, lanes: int = 1024, device="cuda",
                 mode: int | None = None, wide: bool | None = None):
        """``lanes`` is the batch size the caller intends (the reference's
        fixed lane count; any batch size runs, see the module's docstring
        for the sizes the kernels are designed for). ``device`` is explicit:
        the card by default, the CPU for the tests. ``mode`` and ``wide``
        choose the index's layout as the JAX engine's do: by default the
        fastest mode that fits the device's memory, and wide coordinates
        from 2^31 suffixes on (``DeviceIndex.from_host``)."""
        self.idx = idx
        self.opt = opt
        self.lanes = lanes
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.di = DeviceIndex.from_host(idx, self.device, mode=mode,
                                        wide=wide)
        self.max_smems = 96       # emission slots a read, rounds 1 and 3
        self.max_reseeds = 16     # emission slots a read, round 2
        self.pack_cap_per_read = 24
        self.dropped_smems = 0    # emissions that found no slot

    # chaining reads positions from here; the device planes hold them for
    # the device, the host index for the host
    @property
    def sa_positions(self):
        return self.idx.sa

    # ------------------------------------------------------------- batches
    @staticmethod
    def _batch_matrix(codes_list):
        """(R, maxlen) uint8 code matrix padded with T, and the lengths."""
        R = len(codes_list)
        lens = np.fromiter((len(c) for c in codes_list), np.int64, R)
        maxlen = int(lens.max()) if R and lens.max() > 0 else 1
        mat = np.full((R, maxlen), 3, dtype=np.uint8)
        if R and lens.sum():
            flat = np.concatenate([np.asarray(c) for c in codes_list])
            mat[np.arange(maxlen)[None, :] < lens[:, None]] = \
                np.minimum(flat, 4)
        return mat, lens, maxlen

    def submit_batch(self, codes_list):
        """Enqueue prep, the three rounds and the pack for a batch and return
        a token without waiting for the device. Pair with finish_batch_flat
        or finish_batch."""
        opt, dev, di = self.opt, self.device, self.di
        with tstage("seed.prep"):
            mat, lens_np, maxlen = self._batch_matrix(codes_list)
            if maxlen > MAX_READ_LEN:
                raise ValueError(
                    f"read length {maxlen} exceeds the learned seeding "
                    f"path's {MAX_READ_LEN} bp ceiling (the reference "
                    "hard-caps at LEARNED_MAX_READ_LEN=500, src/macro.h:54)")
            lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
            qbuf, nf, nr, nvf = seed_smem.prepare_reads(
                torch.from_numpy(mat).to(dev), lens)
        # on a CUDA device the stage times below are launch times: the device
        # time surfaces where the result is fetched (seed.finish)
        with tstage("seed.round1"):
            d1 = seed_smem.seed_round1(di, qbuf, nf, nr, nvf, lens,
                                       opt.min_seed_len, self.max_smems)
        with tstage("seed.round2"):
            d2 = seed_smem.seed_round2(
                di, qbuf, nf, nr, lens, d1[0], d1[1], opt.split_len,
                opt.split_width, opt.min_seed_len, self.max_reseeds)
        rounds = [d1, d2]
        if opt.max_mem_intv > 0:
            with tstage("seed.round3"):
                rounds.append(seed_smem.seed_round3(
                    di, qbuf, nf, lens, opt.max_mem_intv,
                    opt.min_seed_len + 1, self.max_smems))
        with tstage("seed.pack"):
            cap = len(codes_list) * self.pack_cap_per_read
            packed = seed_smem.pack_rounds(rounds, cap)
        return (len(codes_list), rounds, packed, cap)

    def _note_dropped(self, n_dropped: int) -> None:
        if n_dropped:
            self.dropped_smems += n_dropped
            print(f"seeding: {n_dropped} SMEM(s) of this batch found no "
                  f"emission slot ({self.max_smems} a read in rounds 1 and "
                  f"3, {self.max_reseeds} in round 2) and were dropped",
                  file=sys.stderr)

    def finish_batch_flat(self, token):
        """Fetch a submit_batch token as the flat SMEM struct native chaining
        consumes: per-read runs sorted by (start, end), ties in emission
        order. None when the batch holds more entries than the packed buffer
        (the caller then uses finish_batch)."""
        R, _rounds, packed, cap = token
        flat = packed.cpu().numpy()
        counts = flat[1: 1 + R]
        total = int(counts.sum())
        if total > cap:
            return None
        self._note_dropped(int(flat[0]))
        sten, lb, cn = (flat[1 + R + k * cap: 1 + R + k * cap + total]
                        for k in range(3))
        start = (sten >> 10).astype(np.int32)
        end = (sten & 1023).astype(np.int32)
        smem_off = np.zeros(R + 1, np.int32)
        np.cumsum(counts, out=smem_off[1:])
        # the device compaction kept emission order inside each read: restore
        # the (read, start, end) order chaining consumes; lexsort is stable
        read_ids = np.repeat(np.arange(R, dtype=np.int32), counts)
        order = np.lexsort((end, start, read_ids))
        return FlatSmems(smem_off, start[order], end[order],
                         lb[order].astype(np.int64),
                         cn[order].astype(np.int64))

    def finish_batch(self, token) -> list[list[Smem]]:
        """Fetch a submit_batch token as per-read SMEM lists in emission
        order (round 1, round 2, round 3), from the whole slot planes."""
        R, rounds, _packed, _cap = token
        smems: list[list[Smem]] = [[] for _ in range(R)]
        n_dropped = 0
        for slots, nsm, dropped in rounds:
            n_dropped += int(dropped.sum())
            s, n = slots.cpu().numpy(), nsm.cpu().numpy()
            for i in range(R):
                smems[i].extend(
                    Smem(int(s[0, i, k]), int(s[1, i, k]), int(s[2, i, k]),
                         int(s[3, i, k])) for k in range(int(n[i])))
        self._note_dropped(n_dropped)
        return smems

    # ----------------------------------------------------------- interface
    def collect_smems_batch(self, codes_list) -> list[list[Smem]]:
        return self.finish_batch(self.submit_batch(codes_list))

    def sorted_smems_batch(self, codes_list) -> list[list[Smem]]:
        return [sorted(sm, key=lambda s: (s.start, s.end))
                for sm in self.collect_smems_batch(codes_list)]

    def sorted_smems_batch_flat(self, codes_list) -> FlatSmems | None:
        return self.finish_batch_flat(self.submit_batch(codes_list))

    def sorted_smems(self, codes: np.ndarray) -> list[Smem]:
        return self.sorted_smems_batch([codes])[0]
