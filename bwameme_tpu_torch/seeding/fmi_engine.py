"""FM-index seeding backend: the host contract engine and the device engine.

``FmiHostEngine`` is a copy of bwameme_tpu/seeding/fmi_engine.py:31, the
scalar semantic model of the reference's FM-index SMEM search (the default,
non ``-7`` backend) and the oracle of the device engine:

* bidirectional ``backwardExt`` with the sentinel-offset rule for the
  complement interval (reference: src/FMI_search.cpp:1039-1067);
* forward extension = backward extension of the complement with k/l swapped
  (reference: src/FMI_search.cpp:543-551);
* round 1: all-position SMEM sweep ``getSMEMsAllPosOneThread`` driving the
  per-pivot forward/backward pass ``getSMEMsOnePosOneThread``
  (reference: src/FMI_search.cpp:506-683, 686-737);
* round 2: re-seed long/rare SMEMs at their midpoint with
  min_intv = hitcount+1 (reference: src/bwamem.cpp:760-790);
* round 3: forward-only ``bwtSeedStrategyAllPosOneThread`` with max_intv
  (reference: src/FMI_search.cpp:738-830).

``FmiDeviceEngine`` is the port of bwameme_tpu/seeding/fmi_engine.py:212. On
a CUDA device a batch is one launch of ``fmi_smem`` (csrc/fmi_search.cu), a
warp running each read's machines to their end in FmiHostEngine's order,
the forward passes one chain of every lane and each backward step's list
split across the lanes; on the CPU it runs the JAX engine's own design,
the per-read state machines on the host and each wave of extensions one
batched call of the plain ``backward_ext`` (``collect_smems_waves``, also
what the kernel is held against on the card).

Both implement the seeding contract (host_engine.SeedingEngine) and emit
the Smem tuples of the learned-index engines (start, end, sa_lo, hitcount)
with sa_lo in THIS index's suffix-array coordinates; hit positions come from
``FmIndex.sa`` (``sa_positions``), so chaining is shared.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from bwameme_tpu_torch.index.fmindex import FmIndex, build_fm_index
from bwameme_tpu_torch.ops import fmi_search
from bwameme_tpu_torch.ops.seed_smem import pack_rounds, unpack
from bwameme_tpu_torch.seeding.host_engine import (FlatSmems, SeedingEngine,
                                                   Smem)
from bwameme_tpu_torch.utils.timer import tstage


class FmiHostEngine(SeedingEngine):
    scalar_oracle = True

    def __init__(self, idx, opt, fm: FmIndex | None = None) -> None:
        self.idx = idx
        self.opt = opt
        self.fm = fm if fm is not None else build_fm_index(idx.bns.code)
        self.sa_positions = self.fm.sa

    # ------------------------------------------------------ interval algebra
    def _init_intv(self, a: int) -> tuple[int, int, int]:
        c = self.fm.count
        return int(c[a]), int(c[3 - a]), int(c[a + 1] - c[a])

    def backward_ext(self, k: int, l: int, s: int, a: int):
        fm = self.fm
        occ_k = [int(fm.occ(b, k)) for b in range(4)]
        occ_ks = [int(fm.occ(b, k + s)) for b in range(4)]
        sb = [occ_ks[b] - occ_k[b] for b in range(4)]
        kb = [int(fm.count[b]) + occ_k[b] for b in range(4)]
        sent = 1 if (k <= fm.sentinel_index < k + s) else 0
        l3 = l + sent
        l2 = l3 + sb[3]
        l1 = l2 + sb[2]
        l0 = l1 + sb[1]
        lb = [l0, l1, l2, l3]
        return kb[a], lb[a], sb[a]

    def forward_ext(self, k: int, l: int, s: int, a: int):
        nk, nl, ns = self.backward_ext(l, k, s, 3 - a)
        return nl, nk, ns

    # -------------------------------------------------------------- round 1/2
    def _one_pos(self, codes: np.ndarray, x: int, min_intv: int,
                 min_seed: int, out: list[Smem]) -> int:
        """One forward/backward SMEM pass from pivot x; returns the next
        pivot (reference: FMI_search.cpp:506-683)."""
        l_seq = len(codes)
        a = int(codes[x])
        next_x = x + 1
        if a >= 4:
            return next_x
        k, l, s = self._init_intv(a)
        m, n = x, x
        prev: list[tuple[int, int, int, int, int]] = []
        j = x + 1
        while j < l_seq:
            a = int(codes[j])
            next_x = j + 1
            if a >= 4:
                break
            nk, nl, ns = self.forward_ext(k, l, s, a)
            if ns != s:
                prev.append((k, l, s, m, n))
            if ns < min_intv:
                next_x = j           # restart at the failing column
                break
            k, l, s, n = nk, nl, ns, j
            j += 1
        if s >= min_intv:
            prev.append((k, l, s, m, n))
        prev.reverse()               # longest-first

        for j in range(x - 1, -1, -1):
            a = int(codes[j])
            if a >= 4:
                break
            curr: list[tuple[int, int, int, int, int]] = []
            curr_s = -1
            p = 0
            while p < len(prev):
                pk, pl, ps, pm, pn = prev[p]
                nk, nl, ns = self.backward_ext(pk, pl, ps, a)
                if ns < min_intv and (pn - pm + 1) >= min_seed:
                    out.append(Smem(pm, pn + 1, pk, ps))
                    p += 1
                    break
                if ns >= min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((nk, nl, ns, j, pn))
                    p += 1
                    break
                p += 1
            while p < len(prev):
                pk, pl, ps, pm, pn = prev[p]
                nk, nl, ns = self.backward_ext(pk, pl, ps, a)
                if ns >= min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((nk, nl, ns, j, pn))
                p += 1
            prev = curr
            if not prev:
                break
        if prev:
            pk, pl, ps, pm, pn = prev[0]
            if pn - pm + 1 >= min_seed:
                out.append(Smem(pm, pn + 1, pk, ps))
        return next_x

    # ---------------------------------------------------------------- round 3
    def _bwt_seed_strategy(self, codes: np.ndarray, max_intv: int,
                           min_seed1: int, out: list[Smem]) -> None:
        l_seq = len(codes)
        x = 0
        while x < l_seq:
            next_x = x + 1
            a = int(codes[x])
            if a < 4:
                k, l, s = self._init_intv(a)
                m, n = x, x
                j = x + 1
                while j < l_seq:
                    next_x = j + 1
                    a = int(codes[j])
                    if a >= 4:
                        break
                    k, l, s = self.forward_ext(k, l, s, a)
                    n = j
                    if s < max_intv and (n - m + 1) >= min_seed1:
                        if s > 0:
                            out.append(Smem(m, n + 1, k, s))
                        break
                    j += 1
            x = next_x

    # -------------------------------------------------------------- interface
    def collect_smems(self, codes: np.ndarray) -> list[Smem]:
        opt = self.opt
        codes = np.minimum(codes, 4)
        out: list[Smem] = []
        x = 0
        while x < len(codes):
            x = self._one_pos(codes, x, 1, opt.min_seed_len, out)

        # round 2: re-seed long low-occurrence SMEMs at their midpoint
        n_round1 = len(out)
        for i in range(n_round1):
            sm = out[i]
            if (sm.end - sm.start) < opt.split_len or sm.hitcount > opt.split_width:
                continue
            self._one_pos(codes, (sm.start + sm.end) >> 1, sm.hitcount + 1,
                          opt.min_seed_len, out)

        if opt.max_mem_intv > 0:
            self._bwt_seed_strategy(codes, opt.max_mem_intv,
                                    opt.min_seed_len + 1, out)
        return out


# ---------------------------------------------------------------------------
# Device engine
# ---------------------------------------------------------------------------

FWD, BWD, FWD3, DONE = 0, 1, 2, 3


class _Machine:
    """One getSMEMsOnePosOneThread (or round-3 forward sweep) in flight."""

    __slots__ = ("read", "codes", "min_intv", "min_seed", "x", "j",
                 "k", "l", "s", "m", "n", "prev", "phase", "next_x", "out")

    def __init__(self, read, codes, x, min_intv, min_seed, k, l, s, phase, out):
        self.read = read
        self.codes = codes
        self.min_intv = min_intv
        self.min_seed = min_seed
        self.x = x
        self.j = x + 1
        self.k, self.l, self.s = k, l, s
        self.m, self.n = x, x
        self.prev = []
        self.phase = phase
        self.next_x = x + 1
        self.out = out




class FmiWork:
    """What a batch's SMEM search needs of the FM-index, as the plain wave
    engine counts it, whatever the design that runs it: ``waves`` (R,), the
    waves of extensions each read took part in (its chain of dependent
    steps where a read's extensions of one step run side by side), and the
    occ blocks (64-base checkpoints) that every extension stands on, kept
    by id (``blocks``; ``sectors``: one 32-byte sector a block)."""

    def __init__(self, R: int) -> None:
        self.waves = np.zeros(R, np.int64)
        self.extensions = 0
        self._blocks = []

    def add(self, reads, k, s) -> None:
        np.add.at(self.waves, np.unique(reads), 1)
        self.extensions += len(k)
        self._blocks.append(torch.unique(fmi_search.ext_blocks(k, s)))

    def blocks(self) -> torch.Tensor:
        """The distinct blocks, int64 ids."""
        if not self._blocks:
            return torch.zeros(0, dtype=torch.int64)
        return torch.unique(torch.cat(self._blocks))

    def sectors(self) -> int:
        """The blocks' 32-byte sectors (fmi_search.block_sectors)."""
        return fmi_search.block_sectors(self.blocks())


class FmiDeviceEngine(SeedingEngine):
    """Batched FM-index seeding on one device (see the module's docstring).
    Produces FmiHostEngine's SMEM multisets; a batch is submitted and
    finished as DeviceSeedingEngine's is, so the pipeline overlaps it.

    On the card an emission that finds none of a read's ``max_smems`` slots
    is counted, not lost: the batch's reads that outgrew their slots are
    seeded again, on the card, with room for all of their emissions
    (``reruns`` counts those launches, each under the stage ``seed.rerun``).
    The reference and the JAX package have no read-length cap on this path,
    and neither has this engine: a batch with reads past the packed
    transfer's 1023 bases is fetched as whole slot planes."""

    def __init__(self, idx, opt, fm: FmIndex | None = None,
                 device="cuda") -> None:
        self.idx = idx
        self.opt = opt
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.fm = fm if fm is not None else build_fm_index(idx.bns.code)
        self.dfm = fmi_search.DeviceFmIndex.from_host(self.fm, self.device)
        self.sa_positions = self.fm.sa
        self.count = self.fm.count
        self.max_smems = 128        # emission slots a read, all rounds
        self.pack_cap_per_read = 24
        self.reruns = 0             # launches for reads that outgrew slots

    def _init_intv(self, a: int):
        c = self.count
        return int(c[a]), int(c[3 - a]), int(c[a + 1] - c[a])

    # ---------------------------------------------- the wave design (plain)
    def _ext_wave(self, units, owners, work):
        """units: list of (k, l, s, a) backward-ext problems, one batched
        call of the plain backward_ext; returns (nk, nl, ns) numpy arrays."""
        u = torch.tensor(units, dtype=torch.int64, device=self.dfm.device)
        k, l, s, a = u.unbind(1)
        if work is not None:
            work.add(np.fromiter((mc.read for mc, _ in owners), np.int64,
                                 len(owners)), k, s)
        out = self.dfm.backward_ext(k, l, s, a)
        return [x.cpu().numpy() for x in out]

    def _run_machines(self, machines: list[_Machine], work=None) -> None:
        """Run a set of machines to completion in lockstep waves."""
        active = [mc for mc in machines if mc.phase != DONE]
        while active:
            units = []
            owners = []  # (machine, kind)
            for mc in active:
                codes = mc.codes
                if mc.phase in (FWD, FWD3):
                    if mc.j >= len(codes) or codes[mc.j] >= 4:
                        continue  # resolved on host below
                    a = int(codes[mc.j])
                    # forward ext = backward ext with (l, k) and comp base
                    units.append((mc.l, mc.k, mc.s, 3 - a))
                    owners.append((mc, -1))
                else:  # BWD
                    a = int(codes[mc.j])
                    if a >= 4:
                        continue  # resolved on host below
                    for p, (pk, pl, ps, pm, pn) in enumerate(mc.prev):
                        units.append((pk, pl, ps, a))
                        owners.append((mc, p))
            res = {}
            if units:
                nk, nl, ns = self._ext_wave(units, owners, work)
                for t, (mc, p) in enumerate(owners):
                    res.setdefault(id(mc), {})[p] = (
                        int(nk[t]), int(nl[t]), int(ns[t]))
            nxt = []
            for mc in active:
                self._step(mc, res.get(id(mc)))
                if mc.phase != DONE:
                    nxt.append(mc)
            active = nxt

    def _finish_forward(self, mc: _Machine) -> None:
        if mc.s >= mc.min_intv:
            mc.prev.append((mc.k, mc.l, mc.s, mc.m, mc.n))
        mc.prev.reverse()
        mc.j = mc.x - 1
        if not mc.prev:
            mc.phase = DONE
        elif mc.j < 0:
            self._finalize(mc)
        else:
            mc.phase = BWD

    def _finalize(self, mc: _Machine) -> None:
        if mc.prev:
            pk, pl, ps, pm, pn = mc.prev[0]
            if pn - pm + 1 >= mc.min_seed:
                mc.out.append(Smem(pm, pn + 1, pk, ps))
        mc.phase = DONE

    def _step(self, mc: _Machine, res) -> None:
        codes = mc.codes
        if mc.phase == FWD:
            if mc.j >= len(codes):
                mc.next_x = mc.j
                return self._finish_forward(mc)
            if codes[mc.j] >= 4:
                mc.next_x = mc.j + 1
                return self._finish_forward(mc)
            nk, nl, ns = res[-1]
            nl, nk = nk, nl  # un-swap: result of forward extension
            if ns != mc.s:
                mc.prev.append((mc.k, mc.l, mc.s, mc.m, mc.n))
            if ns < mc.min_intv:
                mc.next_x = mc.j
                return self._finish_forward(mc)
            mc.k, mc.l, mc.s, mc.n = nk, nl, ns, mc.j
            mc.j += 1
            mc.next_x = mc.j
        elif mc.phase == FWD3:
            # round 3: forward-only (reference: FMI_search.cpp:738-830)
            if mc.j >= len(codes):
                mc.next_x = mc.j
                mc.phase = DONE
                return
            if codes[mc.j] >= 4:
                mc.next_x = mc.j + 1
                mc.phase = DONE
                return
            nk, nl, ns = res[-1]
            nl, nk = nk, nl
            mc.k, mc.l, mc.s, mc.n = nk, nl, ns, mc.j
            mc.next_x = mc.j + 1
            if ns < mc.min_intv and (mc.n - mc.m + 1) >= mc.min_seed:
                if ns > 0:
                    mc.out.append(Smem(mc.m, mc.n + 1, nk, ns))
                mc.phase = DONE
                return
            mc.j += 1
        elif mc.phase == BWD:
            if codes[mc.j] >= 4:
                return self._finalize(mc)
            curr = []
            curr_s = -1
            p = 0
            prev = mc.prev
            while p < len(prev):
                pk, pl, ps, pm, pn = prev[p]
                nk, nl, ns = res[p]
                if ns < mc.min_intv and (pn - pm + 1) >= mc.min_seed:
                    mc.out.append(Smem(pm, pn + 1, pk, ps))
                    p += 1
                    break
                if ns >= mc.min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((nk, nl, ns, mc.j, pn))
                    p += 1
                    break
                p += 1
            while p < len(prev):
                pk, pl, ps, pm, pn = prev[p]
                nk, nl, ns = res[p]
                if ns >= mc.min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((nk, nl, ns, mc.j, pn))
                p += 1
            mc.prev = curr
            if not mc.prev:
                mc.phase = DONE
            elif mc.j == 0:
                self._finalize(mc)
            else:
                mc.j -= 1

    def _new_machine(self, read, codes, x, min_intv, min_seed, phase, out):
        a = int(codes[x])
        if a >= 4:
            return None
        k, l, s = self._init_intv(a)
        return _Machine(read, codes, x, min_intv, min_seed, k, l, s, phase, out)

    def _sweep(self, codes_list, outs, min_intv, min_seed, phase, work):
        """An all-position sweep of every read in lockstep (rounds 1, 3)."""
        cursors = [0] * len(codes_list)
        while True:
            machines = []
            for i, codes in enumerate(codes_list):
                while cursors[i] < len(codes):
                    x = cursors[i]
                    mc = self._new_machine(i, codes, x, min_intv, min_seed,
                                           phase, outs[i])
                    if mc is None:
                        cursors[i] = x + 1
                        continue
                    machines.append(mc)
                    break
            if not machines:
                return
            self._run_machines(machines, work)
            for mc in machines:
                cursors[mc.read] = mc.next_x

    def collect_smems_waves(self, codes_list, work: FmiWork | None = None):
        """The JAX engine's design (bwameme_tpu/seeding/fmi_engine.py:393):
        the machines on the host, a wave of extensions one call of the plain
        backward_ext on the index's device; per-read SMEM lists, emissions
        in wave order. ``work``: an FmiWork that counts what the search
        needs of the index."""
        opt = self.opt
        R = len(codes_list)
        codes_list = [np.minimum(c, 4) for c in codes_list]
        outs: list[list[Smem]] = [[] for _ in range(R)]
        # round 1: all-pos sweeps, all reads in lockstep
        self._sweep(codes_list, outs, 1, opt.min_seed_len, FWD, work)
        # round 2: re-seed long/rare SMEMs at their midpoint
        jobs = []
        for i in range(R):
            for sm in list(outs[i]):
                if (sm.end - sm.start) < opt.split_len or sm.hitcount > opt.split_width:
                    continue
                piv = (sm.start + sm.end) >> 1
                mc = self._new_machine(i, codes_list[i], piv, sm.hitcount + 1,
                                       opt.min_seed_len, FWD, outs[i])
                if mc is not None:
                    jobs.append(mc)
        if jobs:
            self._run_machines(jobs, work)
        # round 3: bwt seed strategy (forward-only sweeps)
        if opt.max_mem_intv > 0:
            self._sweep(codes_list, outs, opt.max_mem_intv,
                        opt.min_seed_len + 1, FWD3, work)
        return outs

    # ------------------------------------------------- the kernel (card)
    def _upload(self, codes_list):
        """A batch's code matrix and read lengths on the engine's device."""
        mat, lens, _ = self._batch_matrix(codes_list)
        return (torch.from_numpy(mat).to(self.device),
                torch.from_numpy(lens.astype(np.int32)).to(self.device))

    def _launch(self, codes_list, M: int, steps=False):
        """fmi_smem over a batch: (slots, nsm[, steps]) on the card."""
        return self._smem(*self._upload(codes_list), M, steps)

    def _smem(self, codes, lens, M: int, steps=False):
        """fmi_smem over an uploaded batch (``_upload``)."""
        from bwameme_tpu_torch.ops import fmi_search_cuda

        st = (torch.zeros((3, lens.shape[0]), dtype=torch.int32,
                          device=self.device) if steps else None)
        opt = self.opt
        slots, nsm = fmi_search_cuda.smem(
            self.dfm, codes, lens, opt.min_seed_len, opt.split_len,
            opt.split_width, opt.max_mem_intv, M, steps=st)
        return (slots, nsm, st) if steps else (slots, nsm)

    def submit_batch(self, codes_list):
        """Enqueue a batch and return a token without waiting for the device
        (on the CPU the wave engine runs here). Pair with finish_batch_flat
        or finish_batch."""
        if not fmi_search._on_cuda(self.dfm.count):
            with tstage("seed.waves"):
                return ("lists", self.collect_smems_waves(codes_list))
        R, M = len(codes_list), self.max_smems
        with tstage("seed.fmi_smem"):
            slots, nsm = self._launch(codes_list, M)
        packed = None
        cap = R * self.pack_cap_per_read
        if max((len(c) for c in codes_list), default=0) <= 1023:
            with tstage("seed.pack"):
                # an emission past the slots counts as dropped: the token
                # is then fetched whole and its reads seeded again
                packed = pack_rounds([(slots, nsm, (nsm - M).clamp_min(0))],
                                     cap)
        return ("card", (codes_list, slots, nsm, M, packed, cap))

    def finish_batch_flat(self, token):
        """A submit_batch token as the flat SMEM struct native chaining
        consumes, per-read runs sorted by (start, end), ties in emission
        order; None when the packed buffer cannot hold the batch (more
        entries than it has, a read that outgrew its slots, or reads past
        1023 bases): the caller then uses finish_batch."""
        kind, tok = token
        if kind == "lists":
            return FlatSmems.from_lists(tok)
        codes_list, _slots, _nsm, _M, packed, cap = tok
        if packed is None:
            return None
        flat, dropped = unpack(packed, len(codes_list), cap)
        # a read that outgrew its slots is seeded again (finish_batch)
        return None if dropped else flat

    def finish_batch(self, token) -> list[list[Smem]]:
        """A submit_batch token as per-read SMEM lists in emission order,
        from the whole slot planes; the reads that outgrew their slots are
        seeded again on the card with room for every emission."""
        kind, tok = token
        if kind == "lists":
            return tok
        codes_list, slots, nsm, M, _packed, _cap = tok
        with tstage("seed.fetch"):
            s, n = slots.cpu().numpy(), nsm.cpu().numpy()
        out = [[Smem(int(s[0, i, k]), int(s[1, i, k]), int(s[2, i, k]),
                     int(s[3, i, k])) for k in range(min(int(n[i]), M))]
               for i in range(len(codes_list))]
        todo = np.flatnonzero(n > M)
        need = n[todo]
        while len(todo):
            # round 2 reads round 1's slots, so a read that outgrew them can
            # need more than it counted: repeat until every read fits
            M = 2 * max(M, int(need.max()))
            self.reruns += 1
            print(f"seeding: {len(todo)} read(s) outgrew their emission "
                  f"slots; seeded again with {M}", file=sys.stderr)
            with tstage("seed.rerun"):
                again = self._launch([codes_list[i] for i in todo], M)
            with tstage("seed.fetch"):
                s2, n2 = (x.cpu().numpy() for x in again)
            fits = n2 <= M
            for j in np.flatnonzero(fits):
                out[todo[j]] = [Smem(int(s2[0, j, k]), int(s2[1, j, k]),
                                     int(s2[2, j, k]), int(s2[3, j, k]))
                                for k in range(int(n2[j]))]
            todo, need = todo[~fits], n2[~fits]
        return out
