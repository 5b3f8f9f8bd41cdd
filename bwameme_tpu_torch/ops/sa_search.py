"""Suffix-array search primitives of learned-index seeding: plain PyTorch.

Port of bwameme_tpu/ops/sa_search.py (``make_search_fns``) for both roots,
the P-RMI and the ERT k-mer table, in every memory mode and width, as
functions batched over queries.
They are the plain versions of the ``__device__`` functions in
csrc/seed_smem.cu: the CPU tests hold them against the JAX package, and on
the card the kernels are held against them. The public functions at the end
take the same arguments, in the same order, as the functions
``make_search_fns`` returns.

* Patterns are 2-bit packed reads in uint32 words, 16 bases a word, most
  significant bits first, so unsigned word order is lexicographic base order.
  torch has no uint32 arithmetic: every packed word is widened to a
  non-negative int64 here (never compared as a signed int32), and ranks,
  positions and lengths are int64 in both widths.
* ``prmi_window`` predicts a [lo, hi) window that is guaranteed to hold the
  lower bound; its one f32 step multiplies and adds with separate roundings,
  as the error windows of models/prmi.py assume. A wide index reads its leaf
  starts from ``params64``. An index with the ERT root (``di.root`` is
  "kmer") starts from ``kmer_window`` instead, the ranks of the key's first
  kb bases (``root_window`` picks, as :591 does).
* A compare has a head that depends on the layout (index/device.py): mode 4
  reads one rank row (text position + first 48 bases), mode 3 the position
  and then 32 bases of ``ktext`` there, mode 2 the position and 32 bases of
  ``key2`` beside it, mode 1 the position alone. From the first base the
  head does not cover it reads the packed text 64 bases a segment. The
  results are those of the JAX package's compares of each layout
  (``cmp_ctx_rk``, ``suffix_cmp_flat``, ``suffix_cmp_deep``,
  ``suffix_cmp_pos_only``): a layout moves only where the bases come from.
* Loops end when no lane is active; a finished lane keeps its values, so the
  results equal the reference's fixed-round, lane-masked forms.
* The work a search needs, whatever the design that does it: every function
  that probes takes an optional ``work`` (a ``Work``) and a bool tensor
  ``live`` (every lane by default) that says whether the lane really runs
  the step; lanes that only ride along in a masked loop add nothing. It
  keeps two counts. ``probes``, one entry a lane: the 32-byte index sectors
  the scalar contract reads, one for each rank-indexed plane a rank in range
  reads (the rank row, or the position and, in modes 2 and 3, the key) and
  one a 64-base text segment of every step of its binary searches. And the
  sectors that the answers stand on, which no design can leave unread: the
  root's record that locates the longest match (the leaf record, and in a
  wide index the leaf starts; or the k-mer table's two entries), the rank-indexed entries at ip - 1 and ip and on both
  sides of both borders of every interval, and of these suffixes the bases
  past the head up to the one that decides the compare. These are kept by
  address, so a sector that two ranks, two queries or two reads share is
  counted once (``Work.answer_sectors``): the least a launch can move.
"""

from __future__ import annotations

import torch

from bwameme_tpu_torch.index.device import (DeviceIndex, ShardedPlane,
                                             words_u32)

FULL = 0xFFFFFFFF
I64 = torch.int64
SECTOR = 32                     # bytes the memory moves at a time
LEAF_RECORD, KEY = 24, 8        # bytes
# sector ids of the index's planes, kept apart: the rank-indexed plane (rank
# rows or positions), the keys (ktext, key2), the packed text, the leaf
# records and the wide leaf starts
IN_RK, IN_KEY, IN_TEXT, IN_PARAMS, IN_PARAMS64 = (k << 40 for k in range(5))


def rank_bytes(di: DeviceIndex) -> int:
    """Bytes of the rank-indexed plane a probe reads first: a rank row, or
    a position."""
    if di.mode == 4:
        return 20 if di.wide else 16
    return 8 if di.wide else 4


class Work:
    """What ``n`` lanes' searches need of the index (see the module's
    docstring): ``probes`` (n,) int64, and the addresses of the sectors the
    answers stand on. Lanes that touch nothing add the id -1, so that no
    count waits for the device. The root's sectors are kept as the keys
    that were located, so that one search's count also gives what the same
    answers stand on under the other root (``answer_ids(root=)``): both
    roots give the same answers, and only the record that starts a search
    differs."""

    def __init__(self, n: int, device) -> None:
        self.probes = torch.zeros(n, dtype=I64, device=device)
        self._ids = [torch.zeros(0, dtype=I64, device=device)]
        self._keys = [torch.zeros(0, dtype=I64, device=device)]
        self._held = {"_ids": 0, "_keys": 0}    # ids in each list
        self._di = None

    def _add(self, name: str, ids) -> None:
        """Appends ids to one of the lists, which is made distinct once it
        holds more than 2^24."""
        parts = getattr(self, name)
        parts.append(ids.reshape(-1))
        self._held[name] += parts[-1].numel()
        if self._held[name] > 1 << 24:
            parts[:] = [_distinct(parts)]
            self._held[name] = parts[0].numel()

    def touch(self, ids) -> None:
        self._add("_ids", ids)

    def touch_span(self, space: int, at, size: int, live) -> None:
        """Every sector of ``size`` bytes at each byte offset ``at`` of the
        live lanes."""
        for ids in _span(space, at, size, live):
            self.touch(ids)

    def answer_ids(self, root: DeviceIndex | None = None):
        """The distinct sectors touched, sorted: rank-indexed entries below
        IN_KEY, keys from IN_KEY, text from IN_TEXT, the root's records from
        IN_PARAMS; those of ``root``'s root (an index of the same planes),
        by default of the index searched."""
        return _distinct(self._ids + self._root_ids(root or self._di))

    def answer_sectors(self, leaves: bool = True,
                       root: DeviceIndex | None = None) -> int:
        ids = self.answer_ids(root)
        return int(ids.numel() if leaves else (ids < IN_PARAMS).sum())

    def touch_leaf(self, di: DeviceIndex, khi, live) -> None:
        """Notes the key whose root record locates a longest match: the
        P-RMI leaf record (and, in a wide index, its two leaf starts) or the
        k-mer table's entries m and m + 1, where they straddle two sectors
        both."""
        self._di = di
        live = torch.ones_like(khi, dtype=torch.bool) & live
        self._add("_keys", torch.where(live, khi, -1))

    def _root_ids(self, di: DeviceIndex | None) -> list:
        if di is None:
            return []
        khi = _distinct(self._keys)
        live = torch.ones_like(khi, dtype=torch.bool)
        if di.root == "kmer":
            es = di.kmer_table.element_size()
            return _span(IN_PARAMS, kmer_id(di, khi) * es, 2 * es, live)
        leaf = (khi >> (32 - di.bits)).clamp(max=di.params.shape[0] - 1)
        ids = _span(IN_PARAMS, leaf * LEAF_RECORD, LEAF_RECORD, live)
        if di.wide:
            ids += _span(IN_PARAMS64, leaf * 8, 16, live)
        return ids

    def touch_compare(self, di: DeviceIndex, rank, sa_pos, v, lcp,
                      head_only, live, max_bases: int):
        """What the compare of pattern[:v] with the suffix at ``rank`` (the
        live lanes, ranks in range) stands on: the rank-indexed entries and,
        unless the head decides it, the text from the first base past the
        head to the first that differs or the pattern's last (at most
        max_bases). Past the text's end all is T, which needs no read."""
        rb = rank_bytes(di)
        self.touch_span(IN_RK, rank * rb, rb, live)
        if di.mode in (2, 3):
            at = sa_pos if di.mode == 3 else rank
            self.touch(torch.where(live, IN_KEY + at * KEY // SECTOR, -1))
        start = sa_pos + di.head_bases
        end = (sa_pos + torch.minimum(lcp + 1, v)).clamp(max=di.n_sa)
        deep = live & ~head_only & (end > start)
        first, last = start >> 7, (end - 1) >> 7   # 128 bases a sector
        ids = first[:, None] + torch.arange(max_bases // 128 + 2,
                                            device=first.device)
        self.touch(torch.where(deep[:, None] & (ids <= last[:, None]),
                               IN_TEXT + ids, -1))


def _distinct(parts):
    """The distinct ids >= 0 of a list of id tensors, sorted."""
    ids = torch.unique(torch.cat(parts))
    return ids[ids >= 0]


def _span(space: int, at, size: int, live) -> list:
    """The sector ids of ``size`` bytes at each byte offset ``at`` of the
    live lanes (-1 for the others): the first sector and, where the bytes
    straddle two, the last."""
    first, last = at // SECTOR, (at + size - 1) // SECTOR
    return [torch.where(live, space + first, -1),
            torch.where(live & (last > first), space + last, -1)]


def _combine(w0, w1, sh):
    """(w0 << sh) | (w1 >> (32 - sh)) on uint32 values held in int64; sh in
    0..30 (sh == 0 gives w0: w1 >> 32 is 0)."""
    return ((w0 << sh) & FULL) | (w1 >> (32 - sh))


def _high_mask(nbits):
    """Mask with the top ``nbits`` (clipped to 0..32) of 32 bits set."""
    nb = nbits.clamp(0, 32)
    return FULL ^ (FULL >> nb)


def keep_masks(l_bases):
    """(keep_hi, keep_lo): masks selecting the first l_bases of a 32-base
    (khi, klo) pattern."""
    b = (l_bases * 2).clamp(0, 64)
    return _high_mask(b), _high_mask(b - 32)


def _lcp_bases32(x):
    """Number of leading equal 2-bit bases encoded by a 32-bit xor (0..16)."""
    # frexp's exponent of a double is exact: msb = exponent - 1
    msb = torch.frexp(x.to(torch.float64)).exponent.to(I64) - 1
    return torch.where(x == 0, 16, (31 - msb) >> 1)


def prmi_window(di: DeviceIndex, khi, klo):
    """[lo, hi) rank window of a 32-base key from the P-RMI leaf model."""
    shift = 32 - di.bits
    n_leaf = di.params.shape[0]
    leaf = (khi >> shift).clamp(max=n_leaf - 1)
    rel = ((khi & ((1 << shift) - 1)).to(torch.float32) * 4294967296.0
           + klo.to(torch.float32))
    rec = di.params[leaf]                       # (L, 6) int32 storage
    ab = rec[:, 2:4].contiguous().view(torch.float32)
    alpha, beta = ab[:, 0], ab[:, 1]
    recw = words_u32(rec)
    elo, ehi = recw[:, 4], recw[:, 5]
    if di.wide:     # leaf starts past 2^32 live in the int64 plane
        ls, le = di.params64[leaf], di.params64[leaf + 1]
    else:
        ls, le = recw[:, 0], recw[:, 1]
    # err_lo / err_hi are int32 in the reference
    elo = torch.where(elo >= 2**31, elo - 2**32, elo)
    ehi = torch.where(ehi >= 2**31, ehi - 2**32, ehi)
    cnt = (le - ls).to(torch.float32)
    prod = beta * rel                           # rounded before the add
    predf = torch.minimum(torch.clamp_min(alpha + prod, 0.0), cnt)
    pred = ls + predf.to(I64)
    return (pred - elo).clamp_min(0), (pred + ehi).clamp_max(di.n_sa)


def kmer_id(di: DeviceIndex, khi):
    """The k-mer of a key's first kmer_bits bases, clipped to the table."""
    m = khi >> (32 - 2 * di.kmer_bits)
    return m.clamp(max=di.kmer_table.shape[0] - 2)


def kmer_window(di: DeviceIndex, khi, klo):
    """[lo, hi) rank window of a key from the ERT root: the ranks whose
    first kmer_bits bases are the key's (bwameme_tpu/ops/sa_search.py:556).
    ``klo`` is not read: the table's k-mers are at most 16 bases."""
    m = kmer_id(di, khi)
    return di.kmer_table[m].to(I64), di.kmer_table[m + 1].to(I64)


def root_window(di: DeviceIndex, khi, klo):
    """The window a search starts from, by the index's root (:591)."""
    if di.root == "kmer":
        return kmer_window(di, khi, klo)
    return prmi_window(di, khi, klo)


def text64_at(di: DeviceIndex, pos):
    """64 text bases at position pos as 4 packed words; all ones past the
    end of the text (the guard words are all T as well)."""
    last = di.text32.shape[0] - 1
    base = pos >> 4
    w = [words_u32(di.text32[(base + j).clamp(0, last)]) for j in range(5)]
    sh = (pos & 15) * 2
    in_range = pos < di.n_sa
    return [torch.where(in_range, _combine(w[j], w[j + 1], sh), FULL)
            for j in range(4)]


def ctx_words(qbuf32) -> int:
    """Pattern words a ctx needs for a query buffer, whatever the head: up
    to 3 for the head, then 4 for each 64-base text segment up to the
    buffer's read length."""
    bases = (qbuf32.shape[1] - 3) * 16
    return 3 + 4 * max(0, -(-bases // 64))


def make_ctx(qbuf32, row, pivot):
    """The pattern's 16-base words from base ``pivot`` of query row ``row``,
    never reading past the row's last word."""
    n_words = ctx_words(qbuf32)
    W = qbuf32.shape[1]
    flat = qbuf32.reshape(-1)
    base0 = row * W + (pivot >> 4).clamp(max=W - 1)
    last = (row + 1) * W - 1
    cols = [words_u32(flat[torch.minimum(base0 + k, last)])
            for k in range(n_words + 1)]
    sh = (pivot & 15) * 2
    return tuple(_combine(cols[k], cols[k + 1], sh) for k in range(n_words))


def _multiword_cmp(swords, kwords, total: int):
    """(less, lcp_bases) of suffix words against pattern words; lcp == total
    when all are equal. The words are compared side by side: the first
    that differs decides."""
    S, K = torch.stack(list(swords)), torch.stack(list(kwords))
    x = S ^ K
    diff = x != 0
    first = diff.to(torch.int32).argmax(0, keepdim=True)   # the first max
    hit = diff.any(0)
    lcp = torch.where(hit, 16 * first[0] + _lcp_bases32(x.gather(0, first)[0]),
                      total)
    less = (S < K).gather(0, first)[0] & hit
    return less, lcp


def owned(plane, g, fill):
    """The rows of a per-suffix plane at global ranks (or, for ktext, text
    positions) ``g``, ``fill`` where g is outside [0, rows). A whole plane
    takes them at once; a ShardedPlane as the JAX package's sharded search
    does (bwameme_tpu/parallel/sharded_index.py:137-146, ops/sa_search.py
    :495-506): every block takes its row at the clipped local index, keeps
    it where it owns g and gives zero elsewhere, and the blocks' parts are
    summed on g's device."""
    n = plane.shape[0]
    if isinstance(plane, ShardedPlane):
        B = plane.block_rows
        tot = 0
        for s, blk in enumerate(plane.blocks):
            local = g.to(blk.device) - s * B
            mine = (local >= 0) & (local < B)
            val = blk[local.clamp(0, B - 1)]
            mine = mine.reshape(*mine.shape, *[1] * (val.dim() - mine.dim()))
            tot = tot + torch.where(mine, val, torch.zeros_like(val)).to(
                g.device)
    else:
        tot = plane[g.clamp(0, n - 1)]
    inb = (g >= 0) & (g < n)
    inb = inb.reshape(*inb.shape, *[1] * (tot.dim() - inb.dim()))
    return torch.where(inb, tot, torch.full_like(tot, fill))


def suffix_heads(di: DeviceIndex, idx):
    """(text positions, head words) of the suffixes at ranks ``idx`` (in
    range): the layout's first ``di.head_bases`` bases, 16 a word."""
    if di.mode == 4:
        r0 = words_u32(owned(di.rk, idx, 0))
        if di.wide:     # (pos_lo, pos_hi, key_hi, key_lo, b48)
            return r0[:, 0] | (r0[:, 1] << 32), [r0[:, 2], r0[:, 3],
                                                 r0[:, 4]]
        return r0[:, 0], [r0[:, 1], r0[:, 2], r0[:, 3]]
    pos = owned(di.sa, idx, 0).to(I64)
    if di.mode == 1:
        return pos, []
    # past the text a key is all ones, as the JAX package's ktext_at fills it
    k = words_u32(owned(di.ktext, pos, -1) if di.mode == 3
                  else owned(di.key2, idx, 0))
    return pos, [k[:, 0], k[:, 1]]


def cmp_ctx(di: DeviceIndex, aw, v, sa_idx, work=None, live=True,
            probe=True, answer=False):
    """(less, lcp) of suffix rank sa_idx against the ctx pattern[:v]. A rank
    below 0 is less with lcp 0; one at n_sa or above is not less, lcp 0.
    With ``work``: ``probe`` says the scalar contract makes this compare,
    ``answer`` that the result stands on it."""
    oob = (sa_idx < 0) | (sa_idx >= di.n_sa)
    reads = ~oob & live
    probe = probe and work is not None
    if probe:   # the rank-indexed plane, and the key of modes 2 and 3
        work.probes += reads * (2 if di.mode in (2, 3) else 1)
    idx = sa_idx.clamp(0, di.n_sa - 1)
    sa_pos, head = suffix_heads(di, idx)
    hb = di.head_bases
    if head:
        less, lh = _multiword_cmp(head, aw[: len(head)], hb)
    else:
        less, lh = torch.zeros_like(idx, dtype=torch.bool), torch.zeros_like(
            idx)
    vc = v.clamp(0, hb)
    diffb = lh < vc
    lcp = torch.minimum(lh, vc)
    less = less & diffb
    resolved = diffb | (v <= hb)
    head_only = resolved
    w0 = hb // 16
    n_deep = (len(aw) - w0) // 4
    for k in range(n_deep):
        if bool(resolved.all()):
            break
        off = hb + 64 * k
        if probe:
            work.probes += reads & ~resolved    # a 64-base text segment
        dr = text64_at(di, sa_pos + off)
        lk, l64 = _multiword_cmp(dr, aw[w0 + 4 * k: w0 + 4 * k + 4], 64)
        rem = v - off
        vck = rem.clamp(0, 64)
        diffk = l64 < vck
        less = torch.where(resolved, less, lk & diffk)
        lcp = torch.where(resolved, lcp, off + torch.minimum(l64, vck))
        resolved = resolved | diffk | (rem <= 64)
    if answer and work is not None:
        work.touch_compare(di, idx, sa_pos, torch.broadcast_to(v, idx.shape),
                           lcp, head_only, reads, 16 * len(aw))
    lcp = torch.where(oob, 0, lcp)
    less = (less & ~oob) | (sa_idx < 0)
    return less, lcp


class _Tiled:
    """A ctx's words repeated ``k`` times along the lanes, each made when a
    compare reads it."""

    def __init__(self, aw, k: int) -> None:
        self.aw, self.k = aw, k

    def __len__(self) -> int:
        return len(self.aw)

    def __getitem__(self, words):
        return [w.repeat(self.k) for w in self.aw[words]]


def _answers(di: DeviceIndex, ctx, v, ranks, work: Work, live) -> None:
    """Counts what the answers stand on at each of ``ranks`` (rank tensors
    of the ctx's lanes) for the live lanes: one compare of them all."""
    k = len(ranks)
    live = torch.ones_like(ranks[0], dtype=torch.bool) & live
    cmp_ctx(di, _Tiled(ctx, k), v.repeat(k), torch.cat(ranks), work,
            live.repeat(k), probe=False, answer=True)


def lower_bound_ctx(di: DeviceIndex, ctx, v, wlo, whi, strict_greater=False,
                    work=None, live=True):
    """First rank in [wlo, whi] whose suffix is >= pattern[:v] (> where
    strict_greater, a bool or a per-lane bool tensor)."""
    lo, hi = wlo.clone(), whi.clone()
    while bool((lo < hi).any()):
        mid = (lo + hi) >> 1
        active = lo < hi
        less, lcp = cmp_ctx(di, ctx, v, mid, work, active & live)
        pred = less | ((lcp >= v) & strict_greater)
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def find_longest_ctx(di: DeviceIndex, ctx, v, work=None, live=True):
    """(mlen, ip): the longest match of pattern[:v] over the whole suffix
    array and its insertion point. The key is padded with ones past v. A
    match shorter than v stands on the rows at ip - 1 and ip, between which
    the pattern falls; a match of all v bases on any one row of its interval
    (``full_match_row``, or a border that the caller reads anyway)."""
    keep_hi, keep_lo = keep_masks(v)
    khi_p = (ctx[0] & keep_hi) | (FULL ^ keep_hi)
    klo_p = (ctx[1] & keep_lo) | (FULL ^ keep_lo)
    wlo, whi = root_window(di, khi_p, klo_p)
    if work is not None:
        work.touch_leaf(di, khi_p, live)
    ip = lower_bound_ctx(di, ctx, v, wlo, whi, work=work, live=live)
    _, l0 = cmp_ctx(di, ctx, v, ip - 1, work, live)
    _, l1 = cmp_ctx(di, ctx, v, ip, work, live)
    mlen = torch.maximum(l0, l1)
    if work is not None:
        _answers(di, ctx, v, (ip - 1, ip), work, live & (mlen < v))
    return mlen, ip


def full_match_row(di: DeviceIndex, ctx, v, ip, work: Work, live) -> None:
    """The one row a match of all of pattern[:v] stands on, of the two
    beside ``find_longest_ctx``'s ip, for the ``live`` lanes."""
    _, l0 = cmp_ctx(di, ctx, v, ip - 1)
    cmp_ctx(di, ctx, v, torch.where(l0 >= v, ip - 1, ip), work, live,
               probe=False, answer=True)


def interval_at_ctx(di: DeviceIndex, ctx, l, work=None, live=True, used=True):
    """(lb, count) of the suffix-array interval of pattern[:l]: the key is
    padded with zeros for the lower and with ones for the upper bound.
    ``used`` (bool or bool tensor): the lanes whose caller reads the
    interval, so that their answers stand on its borders."""
    keep_hi, keep_lo = keep_masks(l)
    khi_a, klo_a = ctx[0] & keep_hi, ctx[1] & keep_lo
    khi_t, klo_t = khi_a | (FULL ^ keep_hi), klo_a | (FULL ^ keep_lo)
    lb = lower_bound_ctx(di, ctx, l, *root_window(di, khi_a, klo_a),
                         work=work, live=live)
    ub = lower_bound_ctx(di, ctx, l, *root_window(di, khi_t, klo_t),
                         strict_greater=True, work=work, live=live)
    if work is not None:        # both sides of both borders
        _answers(di, ctx, l, (lb - 1, lb, ub - 1, ub), work, live & used)
    return lb, ub - lb


def sa_query_min1_ctx(di: DeviceIndex, ctx, v, work=None, interval_from=0):
    mlen, ip = find_longest_ctx(di, ctx, v.clamp_min(1), work, v > 0)
    mlen = torch.where(v <= 0, 0, mlen)
    used = mlen >= interval_from
    if work is not None:
        full_match_row(di, ctx, v, ip, work, (v > 0) & (mlen >= v) & ~used)
    lb, cnt = interval_at_ctx(di, ctx, mlen.clamp_min(1), work, mlen > 0,
                              used)
    lb = torch.where(mlen == 0, 0, lb)
    cnt = torch.where(mlen == 0, di.n_sa, cnt)
    return mlen, lb, cnt


def sa_query_ctx(di: DeviceIndex, ctx, v, min_intv, work=None):
    mlen, _ = find_longest_ctx(di, ctx, v.clamp_min(1), work, v > 0)
    mlen = torch.where(v <= 0, 0, mlen)
    lb = torch.zeros_like(mlen)
    cnt = torch.zeros_like(mlen)
    done = torch.zeros_like(mlen, dtype=torch.bool)
    while not bool(done.all()):
        l_eff = mlen.clamp_min(1)
        lb2, cnt2 = interval_at_ctx(di, ctx, l_eff, work,
                                    ~done & (mlen > 0))
        lb2 = torch.where(mlen == 0, 0, lb2)
        cnt2 = torch.where(mlen == 0, di.n_sa, cnt2)
        sat = (cnt2 >= min_intv) | (mlen == 0)
        widen = ~done & ~sat
        _, l0 = cmp_ctx(di, ctx, l_eff, lb2 - 1, work, widen)
        _, l1 = cmp_ctx(di, ctx, l_eff, lb2 + cnt2, work, widen)
        mlen = torch.where(done | sat, mlen, torch.maximum(l0, l1))
        lb = torch.where(done, lb, lb2)
        cnt = torch.where(done, cnt, cnt2)
        done = done | sat
    return mlen, lb, cnt


# ------------------------------------------------------------------ public
# The functions make_search_fns returns, index first, then the same arrays.


def rmi_window(di: DeviceIndex, khi, klo):
    return root_window(di, khi, klo)


def suffix_cmp(di: DeviceIndex, qbuf32, row, pivot, v, sa_idx):
    """(less, lcp) of suffix rank sa_idx against pattern[:v]."""
    return cmp_ctx(di, make_ctx(qbuf32, row, pivot), v, sa_idx)


def lcp_at(di: DeviceIndex, qbuf32, row, pivot, cap, sa_idx):
    """LCP of suffix rank sa_idx with pattern[:cap]."""
    return suffix_cmp(di, qbuf32, row, pivot, cap, sa_idx)[1]


def find_longest(di: DeviceIndex, qbuf32, row, pivot, v):
    return find_longest_ctx(di, make_ctx(qbuf32, row, pivot), v)


def interval_at(di: DeviceIndex, qbuf32, row, pivot, l):
    return interval_at_ctx(di, make_ctx(qbuf32, row, pivot), l)


def sa_query_min1(di: DeviceIndex, qbuf32, row, pivot, v, work=None,
                  interval_from=0):
    """sa_query at min_intv == 1: (mlen, lb, cnt) of the longest match of
    pattern[:v]; v <= 0 gives (0, 0, n_sa). ``interval_from`` (int or a
    tensor, one a lane): the caller reads lb and cnt only of a match this
    long or longer (see ``interval_at_ctx``'s ``used``)."""
    return sa_query_min1_ctx(di, make_ctx(qbuf32, row, pivot), v, work,
                             interval_from)


def sa_query(di: DeviceIndex, qbuf32, row, pivot, v, min_intv, work=None):
    """The widening fixed point: the longest l whose interval holds at least
    min_intv suffixes, as (l, lb, cnt); v <= 0 gives (0, 0, n_sa)."""
    return sa_query_ctx(di, make_ctx(qbuf32, row, pivot), v, min_intv,
                        work)
