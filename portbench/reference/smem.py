"""The plain SMEM reference: BWA-MEM2's three seeding rounds over a sorted
suffix array of the forward+RC text.

Plain ``torch`` on the CPU, independent of the program: it imports nothing
of the aligner and uses no FM-index. The rounds are those of bwa-mem2's
``mem`` (Vasimuddin et al., IPDPS 2019; FMI_search.cpp
``getSMEMsAllPosOneThread``, ``getSMEMsOnePosOneThread``,
``bwtSeedStrategyAllPosOneThread``; bwamem.cpp's reseeding), written from
their description:

1. the all-position sweep: from a pivot x, the forward pass keeps, for each
   occurrence count met while read[x..n] grows, the longest such match
   (longest first); the backward pass prepends one base at a time, emits the
   first match that falls below ``min_intv`` occurrences (if it is at least
   ``min_seed_len`` long and no longer match survived before it) and keeps
   the survivors whose counts differ from the survivor before; what
   survives the read's start or an N is emitted, the longest, if long
   enough. The next pivot is where the forward pass stopped. ``min_intv``
   is 1;
2. reseeding: each round-1 SMEM at least ``split_len`` long with at most
   ``split_width`` occurrences is searched again from its midpoint with
   ``min_intv`` = its occurrences + 1;
3. the forward-only sweep: from each pivot, grow read[x..n] until it is at
   least ``min_seed_len`` + 1 long and has fewer than ``max_mem_intv``
   occurrences; emit it if it has any, and go on from the base after it.

Each emission is (start, end, occurrences, lo, hi): the read's bases
[start, end) occur ``occurrences`` times in the text, at the positions of
``positions(lo, hi, end - start)``.

Departures from bwa-mem2's code, none of which changes an emission:

- an occurrence count is that of the read's bases found by binary search of
  the sorted suffixes, not the size of a bi-interval of the FM-index; a
  backward step is a new search of the longer string, not an update of the
  interval of the shorter;
- each read's intervals are found for every start and every length at once
  (a table), before any round runs; the rounds then only read the table;
- the suffix array may sort a text that runs past the forward+RC text
  (``n``) into padding, as the learned index's does; a match that runs into
  the padding is no occurrence, and is taken off the count and the
  positions (bwa-mem2's text ends in a sentinel that matches nothing).
"""

from __future__ import annotations

import dataclasses

import torch


def forward_rc(code) -> torch.Tensor:
    """The forward+RC text (uint8 codes 0-3) of a genome's codes."""
    c = torch.as_tensor(code, dtype=torch.uint8)
    return torch.cat([c, 3 - c.flip(0)])


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """The suffixes of ``text`` (int64), sorted with the end of the text
    below every base: prefix doubling, a stable sort a round."""
    n = len(text)
    rank = text.long()
    sa = torch.arange(n)
    k = 1
    while True:
        nxt = torch.full((n,), -1, dtype=torch.int64)
        nxt[: max(n - k, 0)] = rank[k:]
        key = rank * (n + 2) + (nxt + 1)
        sa = torch.argsort(key, stable=True)
        ks = key[sa]
        new = torch.zeros(n, dtype=torch.int64)
        new[sa[1:]] = torch.cumsum((ks[1:] != ks[:-1]).long(), 0)
        rank = new
        if n == 0 or int(rank.max()) == n - 1:
            return sa
        k *= 2


@dataclasses.dataclass
class Options:
    min_seed_len: int = 19
    split_len: int = 28          # int(min_seed_len * 1.5 + .499)
    split_width: int = 10
    max_mem_intv: int = 20


class SmemReference:
    """SMEMs of reads over ``text`` (uint8 codes), whose first ``n`` bases
    (all of it by default) are the forward+RC text, and ``sa``, the
    positions below ``n`` sorted by the suffix of ``text`` at each (the end
    of ``text`` below every base)."""

    def __init__(self, text, sa, opt: Options, n: int | None = None):
        self.text = torch.as_tensor(text, dtype=torch.uint8)
        self.sa = torch.as_tensor(sa, dtype=torch.int64)
        self.n = len(self.text) if n is None else int(n)
        self.opt = opt

    # ------------------------------------------------------------ the table
    def _char(self, pos: torch.Tensor) -> torch.Tensor:
        T = len(self.text)
        inside = pos < T
        return torch.where(inside, self.text[pos.clamp(max=T - 1)].long(),
                           torch.full_like(pos, -1))

    def _lower(self, lo, hi, t: int, c) -> torch.Tensor:
        """For each row, the first i in [lo, hi) whose suffix has a base of
        at least c at offset t (the rows' suffixes there agree on their
        first t bases)."""
        lo, hi = lo.clone(), hi.clone()
        while True:
            act = lo < hi
            if not bool(act.any()):
                return lo
            mid = (lo + hi) // 2
            below = self._char(self.sa[mid.clamp(max=len(self.sa) - 1)]
                               + t) < c
            lo = torch.where(act & below, mid + 1, lo)
            hi = torch.where(act & ~below, mid, hi)

    def _past_end(self, Q: torch.Tensor, rows_r, rows_m, L: int):
        """(rows, L + 1) int64: for each row (read, start) and length t, the
        matches of the read's t bases from start that run past ``n`` into
        the padding (no occurrences, though the sort counts them)."""
        out = torch.zeros((len(rows_r), L + 1), dtype=torch.int64)
        if len(self.text) == self.n or not len(rows_r):
            return out
        Qp = torch.cat([Q, torch.full((len(Q), L), 4, dtype=torch.uint8)], 1)
        P = Qp[rows_r[:, None], rows_m[:, None] + torch.arange(L)].long()
        P[P > 3] = -2                    # N (or the read's end) matches none
        for k in range(1, min(L, self.n) + 1):
            seg = self._char(torch.arange(self.n - k, self.n - k + L))
            first = P[:, 0] == seg[0]
            if not bool(first.any()):
                continue
            idx = torch.nonzero(first).flatten()
            lcp = torch.cumprod((P[idx] == seg).long(), 1).sum(1)
            # the suffix at n - k matches t bases for t <= lcp: past the
            # end for k < t <= lcp
            t = torch.arange(L + 1)
            hit = (t[None, :] > k) & (t[None, :] <= lcp[:, None])
            out[idx] += hit.long()
        return out

    def tables(self, reads):
        """For each read (codes 0-3, 4 for N), its (lo, hi, count) tables,
        each (len, len + 1): row m, column t the block [lo, hi) of the
        suffix array that the read's t bases from m begin, and their
        occurrences (the block less the matches past ``n``)."""
        R = len(reads)
        lens = [len(r) for r in reads]
        L = max(lens, default=0)
        Q = torch.full((R, L + 1), 4, dtype=torch.uint8)
        for i, r in enumerate(reads):
            Q[i, : lens[i]] = torch.as_tensor(r, dtype=torch.uint8).clamp(
                max=4)
        rows_r, rows_m = torch.nonzero(Q[:, :L] < 4, as_tuple=True)
        LO = torch.zeros((R, L, L + 1), dtype=torch.int64)
        HI = torch.zeros((R, L, L + 1), dtype=torch.int64)
        HI[:, :, 0] = len(self.sa)
        lo = torch.zeros(len(rows_r), dtype=torch.int64)
        hi = torch.full((len(rows_r),), len(self.sa), dtype=torch.int64)
        act = torch.arange(len(rows_r))
        t = 0
        while len(act):
            c = Q[rows_r[act], rows_m[act] + t].long()
            act = act[c < 4]
            c = c[c < 4]
            if not len(act):
                break
            a = self._lower(lo[act], hi[act], t, c)
            b = self._lower(a, hi[act], t, c + 1)
            lo[act], hi[act] = a, b
            LO[rows_r[act], rows_m[act], t + 1] = a
            HI[rows_r[act], rows_m[act], t + 1] = b
            act = act[b > a]
            t += 1
        count = HI - LO
        past = self._past_end(Q, rows_r, rows_m, L)
        count[rows_r, rows_m] -= past
        return [tuple(x[i, : lens[i], : lens[i] + 1] for x in (LO, HI, count))
                for i in range(R)]

    # ------------------------------------------------------------ the rounds
    @staticmethod
    def _one_pos(codes, cnt, x: int, min_intv: int, min_seed: int,
                 out: list) -> int:
        """Round 1's search from pivot x; returns the next pivot."""
        L = len(codes)
        next_x = x + 1
        if codes[x] >= 4:
            return next_x
        s, n = cnt[x][1], x
        prev = []                        # (occurrences, start, last base)
        j = x + 1
        while j < L:
            next_x = j + 1
            if codes[j] >= 4:
                break
            ns = cnt[x][j + 1 - x]
            if ns != s:
                prev.append((s, x, n))
            if ns < min_intv:
                next_x = j
                break
            s, n = ns, j
            j += 1
        if s >= min_intv:
            prev.append((s, x, n))
        prev.reverse()                   # longest first
        for j in range(x - 1, -1, -1):
            if codes[j] >= 4:
                break
            curr, curr_s = [], -1
            p = 0
            while p < len(prev):
                ps, pm, pn = prev[p]
                ns = cnt[j][pn + 1 - j]
                p += 1
                if ns < min_intv and pn - pm + 1 >= min_seed:
                    out.append((pm, pn + 1, ps))
                    break
                if ns >= min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((ns, j, pn))
                    break
            while p < len(prev):
                ps, pm, pn = prev[p]
                ns = cnt[j][pn + 1 - j]
                if ns >= min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((ns, j, pn))
                p += 1
            prev = curr
            if not prev:
                break
        if prev:
            ps, pm, pn = prev[0]
            if pn - pm + 1 >= min_seed:
                out.append((pm, pn + 1, ps))
        return next_x

    @staticmethod
    def _forward_only(codes, cnt, max_intv: int, min_seed1: int,
                      out: list) -> None:
        """Round 3."""
        L = len(codes)
        x = 0
        while x < L:
            next_x = x + 1
            if codes[x] < 4:
                j = x + 1
                while j < L:
                    next_x = j + 1
                    if codes[j] >= 4:
                        break
                    s = cnt[x][j + 1 - x]
                    if s < max_intv and j - x + 1 >= min_seed1:
                        if s > 0:
                            out.append((x, j + 1, s))
                        break
                    j += 1
            x = next_x

    def smems(self, reads) -> list:
        """Each read's SMEMs of the three rounds, in emission order:
        (start, end, occurrences, lo, hi)."""
        opt = self.opt
        res = []
        for codes, (lo, hi, cnt) in zip(reads, self.tables(reads)):
            codes = [min(int(c), 4) for c in codes]
            cnt = cnt.tolist()
            out = []
            x = 0
            while x < len(codes):
                x = self._one_pos(codes, cnt, x, 1, opt.min_seed_len, out)
            for st, en, s in list(out):
                if en - st >= opt.split_len and s <= opt.split_width:
                    self._one_pos(codes, cnt, (st + en) >> 1, s + 1,
                                  opt.min_seed_len, out)
            if opt.max_mem_intv > 0:
                self._forward_only(codes, cnt, opt.max_mem_intv,
                                   opt.min_seed_len + 1, out)
            res.append([(st, en, s, int(lo[st, en - st]),
                         int(hi[st, en - st])) for st, en, s in out])
        return res

    def positions(self, lo: int, hi: int, length: int) -> list:
        """The sorted text positions of the occurrences of a block [lo, hi)
        of matches ``length`` long: the block less those past ``n``."""
        pos = self.sa[lo:hi]
        return sorted(pos[pos + length <= self.n].tolist())
