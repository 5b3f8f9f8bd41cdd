"""FM-index search primitives on PyTorch: the device index, dispatch and
plain versions.

Port of bwameme_tpu/ops/fmi_search.py (reference: src/FMI_search.cpp
backwardExt :1039-1067, GET_OCC src/FMI_search.h:66-73,
get_sa_entry_compressed src/FMI_search.cpp:1117-1180):

* ``occ(b, p)``: the checkpoint count of p's 64-base block plus the
  popcount of base b's match plane under the block's first p & 63 bases;
* ``backward_ext_all``: the four child intervals of a bi-interval (k, l, s)
  with the sentinel rule for the complement side; ``backward_ext`` one of
  them, ``forward_ext`` the backward extension of the complement with k and
  l swapped (textF is its own reverse complement);
* ``sa_lookup``: the LF-walk of a rank to a stored entry of the 1/8
  compressed suffix array, or to the sentinel.

``DeviceFmIndex`` holds the index on one explicit device, a 64-base block
of the BWT as one 32-byte record (one sector of device memory): the occ of
the four bases at the block's start (int32), then the block's 64 codes as
two 64-bit bit planes, H the high bit of each code and L the low bit, bit o
(least significant first) for the block's base o. The sentinel's slot and
the last block's slots past the BWT's end hold code 0: occ(0, p) takes the
sentinel out again when it lies in [64 blk, p), and no p reaches past the
end. Its methods are the plain versions: batched torch ops, the CPU path
and what the CUDA kernels (ops/fmi_search_cuda.py, csrc/fmi_search.cu) are
held against. The functions at the end dispatch: CUDA tensors go to the
kernels, CPU tensors to the plain versions, with no fallback between them.

torch has no uint32 arithmetic: a record is held as eight int32 (the
kernels read the planes as ``uint64_t``), the plain versions take each
plane as two 32-bit halves widened to int64; every count, rank and
interval is int64 in the plain versions and int32 in the kernels. Like the
JAX package, the index is int32 throughout, so its text (forward + reverse
complement + sentinel) must stay below 2^31 bases: ``from_host`` raises
above that.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

I64 = torch.int64
FULL = 0xFFFFFFFF
SA_COMPX = 3
SA_COMPX_MASK = (1 << SA_COMPX) - 1
SECTOR = 32


def popcount32(x):
    """Set bits of uint32 values held in int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & FULL) >> 24


def _low_mask(t):
    """uint32 (in int64) with the low t bits set, t clipped to 0..32."""
    return (1 << t.clamp(0, 32)) - 1


# bit i of byte x -> bit 7 - i: the one-hot words are most significant bit
# first, the planes least significant first
_REVERSE_BITS = np.array([int(f"{x:08b}"[::-1], 2) for x in range(256)],
                         np.uint8)


def occ_records(cp_count, cp_bits) -> np.ndarray:
    """(nb, 8) int32 records of the blocks (see the module's docstring) from
    an ``FmIndex``'s ``cp_count`` (nb, 4) and its one-hot ``cp_bits`` (nb,
    4, 2) uint32, offset o at word o >> 5, bit 31 - (o & 31)."""
    nb = cp_count.shape[0]
    # big-endian bytes: byte j holds offsets 8j..8j+7, the first at the top
    onehot = np.asarray(cp_bits, ">u4").view(np.uint8).reshape(nb, 4, 8)
    h = _REVERSE_BITS[onehot[:, 2] | onehot[:, 3]]
    l = _REVERSE_BITS[onehot[:, 1] | onehot[:, 3]]
    return np.concatenate([np.asarray(cp_count, np.int32),
                           h.view("<i4"), l.view("<i4")], axis=1)


@dataclasses.dataclass(frozen=True)
class DeviceFmIndex:
    count: torch.Tensor     # int32[5]; count[b] = first rank of base b
    blocks: torch.Tensor    # int32[nb, 8] a block's record: counts, H, L
    sa_comp: torch.Tensor   # int32[(n >> 3) + 1] every 8th suffix position
    sentinel: int
    n: int
    counts: tuple           # count on the host, the kernels' parameter

    @staticmethod
    def from_host(fm, device) -> "DeviceFmIndex":
        """The index of an ``index.fmindex.FmIndex`` on ``device``
        (bwameme_tpu/ops/fmi_search.py:51), its occ blocks as records.
        Raises if the text does not fit int32 ranks."""
        if fm.n + 1 >= 2**31:
            raise ValueError(
                f"FM-index text of {fm.n + 1} bases (forward, reverse "
                "complement and sentinel): the FM-index backend takes int32 "
                "ranks, as the JAX package does, so texts below 2^31 bases")
        device = torch.device(device)
        sa_comp = ((fm.sa_ms_byte.astype(np.int64) & 0xFF) << 32
                   | fm.sa_ls_word.astype(np.int64))

        def put(a, dtype):
            # a tensor of its own, aligned as the allocator aligns (a
            # record a sector), also where device is the CPU
            a = torch.from_numpy(np.ascontiguousarray(
                np.asarray(a).astype(dtype)))
            return torch.empty_like(a, device=device).copy_(a)

        return DeviceFmIndex(
            count=put(fm.count, np.int32),
            blocks=put(occ_records(fm.cp_count, fm.cp_bits), np.int32),
            sa_comp=put(sa_comp, np.int32),
            sentinel=int(fm.sentinel_index), n=int(fm.n),
            counts=tuple(int(c) for c in fm.count))

    @property
    def device(self) -> torch.device:
        return self.count.device

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.count, self.blocks, self.sa_comp))

    # ------------------------------------------------------- plain versions
    def _records(self, p):
        """p's block and its record, (..., 8) int64 with the planes' halves
        as uint32; 0 <= p <= n + 1."""
        blk = p >> 6
        rec = self.blocks[blk].to(I64)
        return blk, torch.cat([rec[..., :4], rec[..., 4:] & FULL], -1)

    def occ4(self, p):
        """(..., 4) occurrences of each base in bwt[0:p) (the sentinel is
        no base); p an int64 tensor, p >= 0. Past n + 1, which no
        bi-interval reaches, p reads as the JAX package's clipped gathers
        read it (bwameme_tpu/ops/fmi_search.py:120): as n + 1 in the last
        block, and past that block as its count of base 3 plus base 3's
        bases among its last 32 under p & 63 and under p & 63 - 32."""
        q = p.clamp(max=self.n + 1)
        blk, rec = self._records(q)
        off = q & 63
        under = (_low_mask(off), _low_mask(off - 32))
        out = []
        for b in range(4):
            pc = 0
            for half in range(2):
                h, l = rec[..., 4 + half], rec[..., 6 + half]
                m = (h if b & 2 else FULL ^ h) & (l if b & 1 else FULL ^ l)
                pc = pc + popcount32(m & under[half])
            out.append(rec[..., b] + pc)
        sent = (q > self.sentinel) & (self.sentinel >= blk << 6)
        out[0] = out[0] - sent.to(I64)
        out = torch.stack(out, -1)
        past = (p >> 6) >= self.n_blocks
        if bool(past.any()):
            last = self.blocks[-1].to(I64)
            m3 = last[5] & last[7] & FULL
            off = p & 63
            clipped = (last[3] + popcount32(m3 & _low_mask(off))
                       + popcount32(m3 & _low_mask(off - 32)))
            out = torch.where(past[..., None], clipped[..., None], out)
        return out

    def occ(self, b, p):
        """#occurrences of base b in bwt[0:p) (the sentinel is no base); b,
        p broadcastable int64 tensors (bwameme_tpu/ops/fmi_search.py:120)."""
        b, p = torch.broadcast_tensors(torch.as_tensor(b, device=p.device), p)
        return torch.gather(self.occ4(p), -1, b[..., None])[..., 0]

    def backward_ext_all(self, k, l, s):
        """All four children (kb, lb, sb), each (..., 4), of the
        bi-interval (k, l, s) (:133)."""
        occ_k = self.occ4(k)
        occ_ks = self.occ4(k + s)
        sb = occ_ks - occ_k
        kb = self.count.to(I64)[:4] + occ_k
        sent = ((k <= self.sentinel) & (k + s > self.sentinel)).to(I64)
        l3 = l + sent
        l2 = l3 + sb[..., 3]
        l1 = l2 + sb[..., 2]
        l0 = l1 + sb[..., 1]
        return kb, torch.stack([l0, l1, l2, l3], -1), sb

    def backward_ext(self, k, l, s, a):
        """The child of base a (:150)."""
        kb, lb, sb = self.backward_ext_all(k, l, s)
        a1 = a[..., None]
        return tuple(torch.gather(x, -1, a1)[..., 0] for x in (kb, lb, sb))

    def forward_ext(self, k, l, s, a):
        """Forward extension by base a (:156)."""
        nk, nl, ns = self.backward_ext(l, k, s, 3 - a)
        return nl, nk, ns

    def init_intv(self, a):
        """The bi-interval of the one-base pattern a (:160)."""
        a = a.clamp(0, 3)
        c = self.count.to(I64)
        k = c[a]
        return k, c[3 - a], c[a + 1] - k

    def bwt_base(self, p):
        """The BWT base at rank p from the planes, 4 at the sentinel."""
        _, rec = self._records(p)
        off = p & 63
        half = (off >> 5)[..., None]
        bit = off & 31
        h = torch.gather(rec[..., 4:6], -1, half)[..., 0] >> bit & 1
        l = torch.gather(rec[..., 6:8], -1, half)[..., 0] >> bit & 1
        return torch.where(p == self.sentinel, 4, 2 * h + l)

    def sa_lookup(self, rank, work=None, visited=None):
        """Text positions of suffix ranks (int64 tensor) by the LF-walk to a
        stored entry, or to the sentinel (:167). ``work``, where given, an
        (n,) int64 tensor that gets each rank's LF steps; ``visited``, where
        given, a list that gets each LF step's blocks (int64 tensors)."""
        sp = rank.to(I64).clone()
        offset = torch.zeros_like(sp)
        done = torch.zeros_like(sp, dtype=torch.bool)
        hit_sent = torch.zeros_like(done)
        count = self.count.to(I64)
        while True:
            done = done | ((sp & SA_COMPX_MASK) == 0)
            b = self.bwt_base(sp)
            sent_now = ~done & (b == 4)
            hit_sent = hit_sent | sent_now
            done = done | sent_now
            if bool(done.all()):
                break
            if visited is not None:
                visited.append(sp[~done] >> 6)
            bc = b.clamp(0, 3)
            nsp = count[bc] + self.occ(bc, sp)
            sp = torch.where(done, sp, nsp)
            offset = torch.where(done, offset, offset + 1)
        if work is not None:
            work += offset
        base = self.sa_comp.to(I64)[(sp >> SA_COMPX).clamp(
            max=self.sa_comp.shape[0] - 1)]
        return torch.where(hit_sent, offset, base + offset)


# ---------------------------------------------------------------- dispatch


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"the FM-index runs on CUDA or the CPU, not "
                         f"{x.device}")
    return False


def backward_ext(dfm: DeviceFmIndex, k, l, s, a):
    """(3, n) int32 (nk, nl, ns) of n units (k, l, s, a), each (n,) int32:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_cuda(k):
        from bwameme_tpu_torch.ops import fmi_search_cuda

        return fmi_search_cuda.backward_ext(dfm, k, l, s, a)
    return backward_ext_torch(dfm, k, l, s, a)


def sa_lookup(dfm: DeviceFmIndex, rank):
    """(n,) int32 text positions of n int32 ranks, as backward_ext
    dispatches."""
    if _on_cuda(rank):
        from bwameme_tpu_torch.ops import fmi_search_cuda

        return fmi_search_cuda.sa_lookup(dfm, rank)
    return sa_lookup_torch(dfm, rank)


def backward_ext_torch(dfm: DeviceFmIndex, k, l, s, a):
    """Plain version of fmi_search_cuda.backward_ext, in its form."""
    out = dfm.backward_ext(*(x.to(I64) for x in (k, l, s, a)))
    return torch.stack(out).to(torch.int32)


def sa_lookup_torch(dfm: DeviceFmIndex, rank, work=None, visited=None):
    """Plain version of fmi_search_cuda.sa_lookup, in its form."""
    return dfm.sa_lookup(rank, work, visited).to(torch.int32)


def block_sectors(blocks) -> int:
    """The 32-byte sectors of occ blocks (their ids, any order, repeats
    allowed): one a distinct block, its record."""
    return int(torch.unique(blocks.to(I64)).numel())


def ext_blocks(k, s):
    """The occ blocks that backward extensions of the bi-intervals (k, s)
    stand on: those of k and of k + s."""
    k = k.to(I64)
    return torch.cat([k >> 6, (k + s.to(I64)) >> 6])
