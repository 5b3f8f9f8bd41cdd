"""Batched device seeding engine on PyTorch.

Port of ``DeviceSeedingEngine`` (bwameme_tpu/seeding/engine.py) for the
learned index (the P-RMI root) and the ERT backend (the k-mer root,
``root="kmer"``) on one device, in every memory mode (1-4) and in narrow
(int32) or wide (int64) coordinates (index/device.py); wide slot planes
carry sa_lo and the hitcount as int64, read coordinates stay small. The root
changes only the window a search starts from: the rounds, their kernels (a
variant a root) and the SMEM sets are the same.
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

Sharded (``shards=[devices]``, the counterpart of the JAX engine's
``mesh=``): the index's per-suffix planes lie in rank blocks over the
devices (index/device.py ShardedPlane), every distinct device holds the
text, the leaves and the root, and each rank's row is read from its block
(the sharded kernel variants; on the CPU the plain versions' owned
gather). A batch is cut into contiguous slices, one a distinct device of
the list (``cut_batch``): each device prepares, seeds and packs its slice
on its own stream, reading its own block locally and the others through
peer pointers, and the slices' results are merged in read order. A list
that repeats one device is one slice, one launch a round. Its SMEMs are the
unsharded engine's.

Produces the SMEM sets of ``HostSeedingEngine`` (the scalar contract), which
stays the independent oracle and is never called from here; implements the
seeding contract (host_engine.SeedingEngine). The read length
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
from bwameme_tpu_torch.seeding.host_engine import (FlatSmems, SeedingEngine,
                                                   Smem)
from bwameme_tpu_torch.utils.timer import tstage

# the learned seeding path's read-length cap (reference:
# LEARNED_MAX_READ_LEN, src/macro.h:54); the packed transfer encodes end
# coordinates in 10 bits
MAX_READ_LEN = 512


def cut_batch(n: int, devices) -> list[tuple]:
    """A batch of n reads as contiguous slices, (device, start, end), one a
    device of the list (parallel/dp.slices), the empty ones left out; a
    batch of no read is one empty slice on the first device."""
    from bwameme_tpu_torch.parallel.dp import slices

    devices = list(devices)
    cut = [(d, b, e) for d, (b, e) in zip(devices, slices(n, len(devices)))
           if e > b]
    return cut or [(devices[0], 0, n)]


class DeviceSeedingEngine(SeedingEngine):
    def __init__(self, idx, opt, lanes: int = 1024, device="cuda",
                 mode: int | None = None, wide: bool | None = None,
                 root: str = "prmi", ert_bits: int = 0, shards=None):
        """``lanes`` is the batch size the caller intends (the reference's
        fixed lane count; any batch size runs, see the module's docstring
        for the sizes the kernels are designed for). ``device`` is explicit:
        the card by default, the CPU for the tests. ``mode`` and ``wide``
        choose the index's layout as the JAX engine's do: by default the
        fastest mode that fits the device's memory, and wide coordinates
        from 2^31 suffixes on (``DeviceIndex.from_host``). ``root``: "prmi"
        (the learned index, the -7 path) or "kmer" (the ERT backend, -Z),
        whose k-mer table has ``ert_bits`` bases, 0 for the size
        index/ert.pick_ert_bits gives. ``shards``: a list of devices over
        which the index's per-suffix planes are split in rank blocks (a
        device may repeat); the engine then runs on the list's first, and
        ``device`` is not read; a batch is cut into a slice a distinct
        device of the list (``cards``)."""
        if root not in ("prmi", "kmer"):
            raise ValueError(f"root must be 'prmi' or 'kmer', not {root!r}")
        self.idx = idx
        self.opt = opt
        self.lanes = lanes
        self.device = torch.device(shards[0] if shards else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.di = DeviceIndex.from_host(
            idx, self.device, mode=mode, wide=wide,
            ert_bits=ert_bits if root == "kmer" else None,
            shards=list(shards) if shards else None)
        cards = self.cards
        if len(cards) > 1 and cards[0].type == "cuda":
            from bwameme_tpu_torch.ops.seed_smem_cuda import peer_access

            # every card of the row reads every other's block: each
            # ordered pair, or raise
            for d in cards:
                peer_access(d, cards, self.di.mode)
        self.max_smems = 96       # emission slots a read, rounds 1 and 3
        self.max_reseeds = 16     # emission slots a read, round 2
        self.pack_cap_per_read = 24
        self.dropped_smems = 0    # emissions that found no slot

    @property
    def cards(self) -> list:
        """The distinct devices of the index's blocks (its device when
        whole): a batch is cut into a slice each."""
        return list(dict.fromkeys(self.di.shards or [self.di.device]))

    # chaining reads positions from here; the device planes hold them for
    # the device, the host index for the host
    @property
    def sa_positions(self):
        return self.idx.sa

    # ------------------------------------------------------------- batches
    def submit_batch(self, codes_list, devices=None):
        """Enqueue prep, the three rounds and the pack for a batch and return
        a token without waiting for the device. Pair with finish_batch_flat
        or finish_batch. The batch is cut into a slice a device of
        ``devices`` (by default ``cards``; a device may repeat), each slice
        submitted on its device; the token of one slice is that slice's,
        of more the list of (first read, slice token)."""
        cut = cut_batch(len(codes_list), devices or self.cards)
        if len(cut) == 1:
            return self._submit(codes_list, cut[0][0])
        return [(b, self._submit(codes_list[b:e], dev)) for dev, b, e in cut]

    def _submit(self, codes_list, dev):
        """One slice on ``dev`` (current stream), with the index's view from
        there."""
        dev = torch.device(dev)
        if dev.type == "cuda" and torch.cuda.current_device() != dev.index:
            with torch.cuda.device(dev):
                return self._submit(codes_list, dev)
        opt, di = self.opt, self.di.on(dev)
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
        order. None when a batch of one slice holds more entries than the
        packed buffer (the caller then uses finish_batch); a slice of more
        that does is fetched as its whole slot planes instead."""
        if not isinstance(token, list):
            flat, n_dropped = self._flat(token)
            if flat is not None:
                self._note_dropped(n_dropped)
            return flat
        parts, n_dropped = [], 0
        for _, tok in token:
            flat, d = self._flat(tok)
            if flat is None:
                lists, d = self._lists(tok)
                flat = FlatSmems.from_lists(lists)
            parts.append(flat)
            n_dropped += d
        self._note_dropped(n_dropped)
        return _merge_flat(parts)

    @staticmethod
    def _flat(token):
        """A slice's packed result as FlatSmems (None when it overflowed
        the packed buffer), and the SMEMs it dropped."""
        R, _rounds, packed, cap = token
        return seed_smem.unpack(packed, R, cap)

    def finish_batch(self, token) -> list[list[Smem]]:
        """Fetch a submit_batch token as per-read SMEM lists in emission
        order (round 1, round 2, round 3), from the whole slot planes."""
        toks = token if isinstance(token, list) else [(0, token)]
        smems, n_dropped = [], 0
        for _, tok in toks:
            lists, d = self._lists(tok)
            smems += lists
            n_dropped += d
        self._note_dropped(n_dropped)
        return smems

    @staticmethod
    def _lists(token):
        """A slice's per-read SMEM lists from its slot planes, and the SMEMs
        it dropped."""
        R, rounds, _packed, _cap = token
        smems: list[list[Smem]] = [[] for _ in range(R)]
        n_dropped = 0
        for slots, nsm, dropped in rounds:
            with tstage("seed.fetch"):
                n_dropped += int(dropped.sum())
                s, n = slots.cpu().numpy(), nsm.cpu().numpy()
            for i in range(R):
                smems[i].extend(
                    Smem(int(s[0, i, k]), int(s[1, i, k]), int(s[2, i, k]),
                         int(s[3, i, k])) for k in range(int(n[i])))
        return smems, n_dropped


def _merge_flat(parts) -> FlatSmems:
    """Consecutive slices' FlatSmems as one, in read order."""
    off = [parts[0].off]
    for p in parts[1:]:
        off.append(p.off[1:] + off[-1][-1])
    return FlatSmems(np.concatenate(off).astype(np.int32),
                     *(np.concatenate([getattr(p, f) for p in parts])
                       for f in ("start", "end", "sa_lo", "hitcount")))
