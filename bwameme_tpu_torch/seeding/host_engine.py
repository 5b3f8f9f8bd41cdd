"""The seeding contract of the port's engines, and the host (numpy)
reference implementation of learned-index SMEM seeding.

``SeedingEngine`` is the one surface between the Aligner and its four
engines: ``DeviceSeedingEngine`` (learned index and ERT, seeding/engine.py),
``FmiDeviceEngine`` and the two scalar oracles, ``HostSeedingEngine`` (here)
and ``FmiHostEngine`` (seeding/fmi_engine.py).

``HostSeedingEngine`` is the scalar semantic model of the seeding stage — the
exact contract the batched JAX/Pallas engine must reproduce, and the
differential-test oracle (the analog of the reference's
test/compare_result.sh FMI-vs-Learned fuzzing).

Semantics replicated from the reference (file:line cites):
* zigzag step-1 sweep: Learned_getSMEMsOnePosOneThread_step1
  (src/LearnedIndex_seeding.cpp:1691-1894)
* step-2 reseeding of long/rare SMEMs: Learned_getSMEMsAllPosOneThread
  (src/LearnedIndex_seeding.cpp:913-968) + Learned_getSMEMsOnePosOneThread
  (src/LearnedIndex_seeding.cpp:1898-2128)
* third round "bwt seed strategy": Learned_bwtSeedStrategyAllPosOneThread
  (src/LearnedIndex_seeding.cpp:974-1283)
* last-mile interval semantics: right_smem_search / mem_search
  (src/LearnedIndex_seeding.cpp:2131-2665, 2667-3200). Those functions
  enumerate, per query pivot, the longest match length whose suffix-array
  interval holds >= min_intv entries; we compute the same fixed point with
  clean binary searches over the suffix array.

The text is forward+RC, so left extensions are right searches of the
reverse-complemented read against the same SA (same trick as the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Smem:
    start: int      # query begin (forward read coords)
    end: int        # query end (exclusive)
    sa_lo: int      # suffix-array interval start
    hitcount: int   # suffix-array interval size


@dataclasses.dataclass
class FlatSmems:
    """A batch's SMEMs as flat arrays (the layout native chaining consumes
    directly): per-read runs delimited by ``off``, each run sorted by
    (start, end). Produced by every engine's finish_batch_flat."""

    off: "object"       # int32[R+1] prefix offsets
    start: "object"     # int32[n]
    end: "object"       # int32[n]
    sa_lo: "object"     # int64[n]
    hitcount: "object"  # int64[n]

    def to_lists(self) -> list[list[Smem]]:
        return [
            [Smem(int(self.start[k]), int(self.end[k]), int(self.sa_lo[k]),
                  int(self.hitcount[k]))
             for k in range(int(self.off[i]), int(self.off[i + 1]))]
            for i in range(len(self.off) - 1)
        ]

    @classmethod
    def from_lists(cls, lists) -> "FlatSmems":
        """Per-read SMEM lists in emission order as FlatSmems, each read's
        run sorted by (start, end), ties in emission order."""
        runs = [sorted_by_span(sm) for sm in lists]
        off = np.zeros(len(runs) + 1, np.int32)
        np.cumsum([len(r) for r in runs], out=off[1:])
        flat = [s for r in runs for s in r]
        return cls(off, *(np.fromiter((getattr(s, f) for s in flat), dt,
                                      len(flat))
                          for f, dt in (("start", np.int32), ("end", np.int32),
                                        ("sa_lo", np.int64),
                                        ("hitcount", np.int64))))


def sorted_by_span(smems) -> list[Smem]:
    """SMEMs sorted by (start, end), ties in their order — the order
    chaining consumes (reference: src/bwamem.cpp:53
    mem_smem_sort_lt_learned)."""
    return sorted(smems, key=lambda s: (s.start, s.end))


class SeedingEngine:
    """The seeding contract. An engine implements

    * ``submit_batch(codes_list) -> token``: start a batch's search; a
      device engine enqueues it and returns without waiting for the device,
      a scalar oracle runs it here;
    * ``finish_batch_flat(token) -> FlatSmems | None``: the batch's SMEMs,
      each read's run sorted by (start, end), ties in emission order; None
      where the batch outgrew a device engine's packed buffer (the caller
      then calls finish_batch);
    * ``finish_batch(token) -> list[list[Smem]]``: per-read lists in
      emission order;
    * ``sa_positions``: the suffix array that turns an SMEM's sa_lo into
      text positions (chaining reads it);

    and may set the attributes below. Everything else is defined once,
    here. The defaults of the three methods are the scalar oracles': the
    search runs read by read in ``submit_batch`` (``collect_smems``)."""

    # the batch size the engine is made for; None: a chunk is one batch
    lanes: int | None = None
    # the engine's DeviceIndex, whose packed text extension reads; None:
    # the engine holds no device index
    di = None
    # a scalar oracle: the Aligner then rescues mates pair by pair, as bwa
    # 0.7.17's mem_sam_pe, instead of a chunk's rescue in one batch
    # (bwa-mem2's mem_sam_pe_batch); the two can differ where rescues
    # cascade
    scalar_oracle = False
    sa_positions: np.ndarray

    def submit_batch(self, codes_list):
        return [self.collect_smems(c) for c in codes_list]

    def finish_batch(self, token) -> list[list[Smem]]:
        return token

    def finish_batch_flat(self, token) -> FlatSmems | None:
        return FlatSmems.from_lists(self.finish_batch(token))

    def collect_smems_batch(self, codes_list) -> list[list[Smem]]:
        return self.finish_batch(self.submit_batch(codes_list))

    def sorted_smems_batch(self, codes_list) -> list[list[Smem]]:
        return [sorted_by_span(sm)
                for sm in self.collect_smems_batch(codes_list)]

    def sorted_smems_batch_flat(self, codes_list) -> FlatSmems | None:
        return self.finish_batch_flat(self.submit_batch(codes_list))

    def sorted_smems(self, codes: np.ndarray) -> list[Smem]:
        return self.sorted_smems_batch([codes])[0]

    @staticmethod
    def _batch_matrix(codes_list):
        """(R, maxlen) uint8 codes clipped to 4 (N), padded with T past
        each read's end, and the lengths."""
        R = len(codes_list)
        lens = np.fromiter((len(c) for c in codes_list), np.int64, R)
        maxlen = max(int(lens.max()) if R else 0, 1)
        mat = np.full((R, maxlen), 3, dtype=np.uint8)
        if R and lens.sum():
            mat[np.arange(maxlen)[None, :] < lens[:, None]] = np.minimum(
                np.concatenate([np.asarray(c) for c in codes_list]), 4)
        return mat, lens, maxlen


class HostSeedingEngine(SeedingEngine):
    scalar_oracle = True

    def __init__(self, idx, opt) -> None:
        self.idx = idx
        self.opt = opt
        # padded text so comparisons never run off the end (all-T tail,
        # mirroring the build padding; see index/build.py guard words)
        self.textp = np.concatenate(
            [idx.text, np.full(1024, 3, dtype=np.uint8)]
        )
        self.sa = self.sa_positions = idx.sa
        self.n = len(idx.sa)

    # ----- comparators ---------------------------------------------------
    def _lcp(self, sa_i: int, pat: np.ndarray) -> int:
        if sa_i < 0 or sa_i >= self.n:
            return 0
        pos = self.sa[sa_i]
        s = self.textp[pos: pos + len(pat)]
        neq = np.flatnonzero(s != pat)
        return int(neq[0]) if len(neq) else len(pat)

    def _suffix_less(self, sa_i: int, pat: np.ndarray) -> bool:
        pos = self.sa[sa_i]
        s = self.textp[pos: pos + len(pat)]
        neq = np.flatnonzero(s != pat)
        if len(neq) == 0:
            return False  # pattern is a prefix of the suffix
        j = neq[0]
        return bool(s[j] < pat[j])

    def _suffix_prefix_greater(self, sa_i: int, pat: np.ndarray) -> bool:
        pos = self.sa[sa_i]
        s = self.textp[pos: pos + len(pat)]
        neq = np.flatnonzero(s != pat)
        if len(neq) == 0:
            return False
        j = neq[0]
        return bool(s[j] > pat[j])

    def _lower_bound(self, pat: np.ndarray) -> int:
        lo, hi = 0, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self._suffix_less(mid, pat):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _upper_bound(self, pat: np.ndarray) -> int:
        lo, hi = 0, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self._suffix_prefix_greater(mid, pat):
                hi = mid
            else:
                lo = mid + 1
        return lo

    def interval_at(self, pat: np.ndarray, length: int) -> tuple[int, int]:
        p = pat[:length]
        lb = self._lower_bound(p)
        ub = self._upper_bound(p)
        return lb, ub - lb

    def find_longest(self, pat: np.ndarray) -> int:
        """Maximum LCP between pat and any suffix (capped at len(pat))."""
        ip = self._lower_bound(pat)
        return max(self._lcp(ip - 1, pat), self._lcp(ip, pat))

    # ----- abstract last-mile query --------------------------------------
    def sa_query(self, pat: np.ndarray, min_intv: int) -> tuple[int, int, int]:
        """Longest l such that |{suffixes with LCP >= l}| >= min_intv.

        Returns (l, sa_lo, count) — the fixed point computed by
        right_smem_search / mem_search's widening loop
        (reference: src/LearnedIndex_seeding.cpp:2352-2560).
        """
        if len(pat) == 0:
            return 0, 0, self.n
        l = self.find_longest(pat)
        while True:
            if l == 0:
                return 0, 0, self.n
            lb, cnt = self.interval_at(pat, l)
            if cnt >= min_intv:
                return l, lb, cnt
            nxt = max(self._lcp(lb - 1, pat[:l]), self._lcp(lb + cnt, pat[:l]))
            assert nxt < l
            l = nxt

    # ----- read preparation ----------------------------------------------
    @staticmethod
    def _next_n(codes: np.ndarray) -> np.ndarray:
        """next_n[i] = smallest j >= i with codes[j] >= 4, else len."""
        l = len(codes)
        out = np.empty(l + 1, dtype=np.int64)
        out[l] = l
        nxt = l
        for i in range(l - 1, -1, -1):
            if codes[i] >= 4:
                nxt = i
            out[i] = nxt
        return out

    # ----- the three seeding rounds --------------------------------------
    def collect_smems(self, codes: np.ndarray) -> list[Smem]:
        """Full 3-round seeding for one read; returns SMEMs in emission order."""
        opt = self.opt
        l = len(codes)
        if l < opt.min_seed_len:
            return []
        rc = np.where(codes < 4, 3 - codes, codes)[::-1]
        next_n_f = self._next_n(codes)
        next_n_r = self._next_n(rc)
        smems: list[Smem] = []

        def right_pat(p: int) -> np.ndarray:
            return codes[p: next_n_f[p]]

        def left_pat(p: int) -> np.ndarray:
            lp = l - 1 - p
            return rc[lp: next_n_r[lp]]

        def right_emit(p: int, min_intv: int, min_seed: int) -> int:
            ln, lo, cnt = self.sa_query(right_pat(p), min_intv)
            if ln >= min_seed:
                smems.append(Smem(p, p + ln, lo, cnt))
            return ln

        def left_len(p: int, min_intv: int) -> int:
            ln, _, _ = self.sa_query(left_pat(p), min_intv)
            return ln

        def right_len(p: int, min_intv: int) -> int:
            ln, _, _ = self.sa_query(right_pat(p), min_intv)
            return ln

        # ---- step 1 + step 2 (reference: Learned_getSMEMsAllPosOneThread)
        def step1(pivot: int) -> int:
            """One _step1 call; returns the new pivot."""
            if codes[pivot] >= 4:
                if l - pivot < opt.min_seed_len:
                    return l
                return pivot + 1
            if pivot != 0 and codes[pivot - 1] < 4:
                next_pivot = l
                p = pivot
                while p < next_pivot:
                    if codes[p] >= 4:
                        if l - p < opt.min_seed_len:
                            return l
                        p += 1
                        continue
                    prev_sp = p
                    blen = left_len(p, 1)
                    p = p - blen + 1
                    if next_pivot - p < opt.min_seed_len:
                        break
                    rlen = right_emit(p, 1, opt.min_seed_len)
                    p = p + rlen
                    # Progress guard: the reference asserts pivot+len >
                    # search_pivot (DEBUG_MODE, src/LearnedIndex_seeding.cpp
                    # :1848). A left match reaching the T-padding junction can
                    # exceed the forward match and stall the zigzag; force
                    # strictly increasing search pivots.
                    if p <= prev_sp:
                        p = prev_sp + 1
                return l
            else:
                rlen = right_emit(pivot, 1, opt.min_seed_len)
                return pivot + max(rlen, 1)

        def one_pos(pivot: int, min_intv: int) -> None:
            """Step-2 reseed from a middle pivot (reference:
            Learned_getSMEMsOnePosOneThread)."""
            if codes[pivot] >= 4:
                return
            if pivot != 0 and codes[pivot - 1] < 4:
                rlen = right_len(pivot, min_intv)
                next_pivot = pivot + rlen
                p = pivot
                search_pivot = p
                while search_pivot < next_pivot:
                    prev_sp = search_pivot
                    blen = left_len(p, min_intv)
                    p = p - blen + 1
                    if next_pivot - p < opt.min_seed_len:
                        break
                    rlen2 = right_emit(p, min_intv, opt.min_seed_len)
                    search_pivot = p + rlen2
                    if search_pivot <= prev_sp:  # progress guard (see step1)
                        search_pivot = prev_sp + 1
                    p = search_pivot
            else:
                right_emit(pivot, min_intv, opt.min_seed_len)

        split_len = opt.split_len
        pivot = 0
        while pivot < l:
            before = len(smems)
            pivot = step1(pivot)
            after = len(smems)
            for k in range(before, after):
                sm = smems[k]
                if (sm.end - sm.start) < split_len or sm.hitcount > opt.split_width:
                    continue
                one_pos((sm.start + sm.end) >> 1, sm.hitcount + 1)

        # ---- third round (reference: Learned_bwtSeedStrategyAllPosOneThread)
        if opt.max_mem_intv > 0:
            s = opt.min_seed_len + 1
            min_intv = opt.max_mem_intv
            p = 0
            while p < l - s + 1:
                if codes[p] >= 4:
                    p += 1
                    continue
                pat = right_pat(p)
                v = len(pat)
                if v < s:
                    p += v
                    continue
                lmax = self.find_longest(pat)
                if lmax < s:
                    p += s
                    continue
                # walk levels from lmax down
                cur_l = lmax
                lb, cnt = self.interval_at(pat, cur_l)
                prev_cnt = 0
                prev_lb = 0
                advance = None
                while True:
                    if cnt >= min_intv:
                        if prev_cnt > 0:
                            smems.append(
                                Smem(p, p + cur_l + 1, prev_lb, prev_cnt)
                            )
                        advance = cur_l + 1
                        break
                    nxt = max(
                        self._lcp(lb - 1, pat[:cur_l]),
                        self._lcp(lb + cnt, pat[:cur_l]),
                    )
                    if nxt < s:
                        smems.append(Smem(p, p + s, lb, cnt))
                        advance = s
                        break
                    prev_cnt, prev_lb = cnt, lb
                    cur_l = nxt
                    lb, cnt = self.interval_at(pat, cur_l)
                p += advance
        return smems
