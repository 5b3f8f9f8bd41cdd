"""FM-index search primitives on PyTorch: the device index, dispatch and
plain versions.

Port of bwameme_tpu/ops/fmi_search.py (reference: src/FMI_search.cpp
backwardExt :1039-1067, GET_OCC src/FMI_search.h:66-73,
get_sa_entry_compressed src/FMI_search.cpp:1117-1180):

* ``occ(b, p)``: the checkpoint count of p's 64-base block plus the
  popcount of base b's one-hot bitmap masked to the block's first p & 63
  bases (two 32-bit words, most significant bit first);
* ``backward_ext_all``: the four child intervals of a bi-interval (k, l, s)
  with the sentinel rule for the complement side; ``backward_ext`` one of
  them, ``forward_ext`` the backward extension of the complement with k and
  l swapped (textF is its own reverse complement);
* ``sa_lookup``: the LF-walk of a rank to a stored entry of the 1/8
  compressed suffix array, or to the sentinel.

``DeviceFmIndex`` holds the planes on one explicit device, and its methods
are the plain versions: batched torch ops, the CPU path and what the CUDA
kernels (ops/fmi_search_cuda.py, csrc/fmi_search.cu) are held against. The
functions at the end dispatch: CUDA tensors go to the kernels, CPU tensors
to the plain versions, with no fallback between them.

torch has no uint32 arithmetic: the bitmap words are held as int32 storage
(the kernels read them as ``uint32_t``) and widened to int64 here; every
count, rank and interval is int64 in the plain versions and int32 in the
kernels. Like the JAX package, the index is int32 throughout, so its text
(forward + reverse complement + sentinel) must stay below 2^31 bases:
``from_host`` raises above that.
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


def _high_mask(t):
    """uint32 (in int64) with the top t bits set, t clipped to 0..32."""
    t = t.clamp(0, 32)
    return FULL ^ (FULL >> t)


@dataclasses.dataclass(frozen=True)
class DeviceFmIndex:
    count: torch.Tensor     # int32[5]; count[b] = first rank of base b
    cp_count: torch.Tensor  # int32[nb * 4] occ at block starts
    cp_bits: torch.Tensor   # int32 storage of uint32[nb * 8] (block, base, word)
    sa_comp: torch.Tensor   # int32[(n >> 3) + 1] every 8th suffix position
    sentinel: int
    n: int
    counts: tuple           # count on the host, the kernels' parameter

    @staticmethod
    def from_host(fm, device) -> "DeviceFmIndex":
        """The planes of an ``index.fmindex.FmIndex`` on ``device``
        (bwameme_tpu/ops/fmi_search.py:51). Raises if the text does not fit
        int32 ranks."""
        if fm.n + 1 >= 2**31:
            raise ValueError(
                f"FM-index text of {fm.n + 1} bases (forward, reverse "
                "complement and sentinel): the FM-index backend takes int32 "
                "ranks, as the JAX package does, so texts below 2^31 bases")
        device = torch.device(device)
        sa_comp = ((fm.sa_ms_byte.astype(np.int64) & 0xFF) << 32
                   | fm.sa_ls_word.astype(np.int64))

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a).astype(dtype)).reshape(-1)).to(device)

        return DeviceFmIndex(
            count=put(fm.count, np.int32),
            cp_count=put(fm.cp_count, np.int32),
            cp_bits=put(np.asarray(fm.cp_bits, np.uint32).view(np.int32),
                        np.int32),
            sa_comp=put(sa_comp, np.int32),
            sentinel=int(fm.sentinel_index), n=int(fm.n),
            counts=tuple(int(c) for c in fm.count))

    @property
    def device(self) -> torch.device:
        return self.count.device

    @property
    def n_blocks(self) -> int:
        return self.cp_count.shape[0] // 4

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.count, self.cp_count, self.cp_bits, self.sa_comp))

    # ------------------------------------------------------- plain versions
    def occ(self, b, p):
        """#occurrences of base b in bwt[0:p) (the sentinel is no base); b,
        p broadcastable int64 tensors (bwameme_tpu/ops/fmi_search.py:120)."""
        b, p = torch.broadcast_tensors(torch.as_tensor(b, device=p.device), p)
        blk, off = p >> 6, p & 63
        cp = self.cp_count.to(I64)[(blk * 4 + b).clamp(
            0, self.cp_count.shape[0] - 1)]
        last = self.cp_bits.shape[0] - 1
        w0 = self.cp_bits[(blk * 8 + b * 2).clamp(0, last)].to(I64) & FULL
        w1 = self.cp_bits[(blk * 8 + b * 2 + 1).clamp(0, last)].to(I64) & FULL
        return (cp + popcount32(w0 & _high_mask(off))
                + popcount32(w1 & _high_mask(off - 32)))

    def backward_ext_all(self, k, l, s):
        """All four children (kb, lb, sb), each (..., 4), of the
        bi-interval (k, l, s) (:133)."""
        b = torch.arange(4, device=k.device)
        occ_k = self.occ(b, k[..., None])
        occ_ks = self.occ(b, (k + s)[..., None])
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
        """The BWT base at rank p from the bitmaps, 4 at the sentinel."""
        blk, off = p >> 6, p & 63
        idx = (blk * 8 + (off >> 5)).clamp(0, self.cp_bits.shape[0] - 1)
        bit = 31 - (off & 31)
        words = self.cp_bits.to(I64) & FULL
        hits = torch.stack([(words[(idx + 2 * b).clamp(
            max=words.shape[0] - 1)] >> bit) & 1 for b in range(4)], -1)
        return torch.where(hits.sum(-1) == 0, 4, hits.argmax(-1))

    def sa_lookup(self, rank, work=None):
        """Text positions of suffix ranks (int64 tensor) by the LF-walk to a
        stored entry, or to the sentinel (:167). ``work``, where given, an
        (n,) int64 tensor that gets each rank's LF steps."""
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


def sa_lookup_torch(dfm: DeviceFmIndex, rank, work=None):
    """Plain version of fmi_search_cuda.sa_lookup, in its form."""
    return dfm.sa_lookup(rank, work).to(torch.int32)


def block_sectors(blocks) -> int:
    """The distinct 32-byte sectors of occ blocks (their ids, any order,
    repeats allowed): a block's checkpoint counts are 16 bytes, its bitmaps
    32."""
    blk = torch.unique(blocks.to(I64))
    return int(torch.unique(blk >> 1).numel() + blk.numel())


def ext_sectors(dfm: DeviceFmIndex, k, s) -> int:
    """The sectors of the occ blocks that backward extensions of the
    bi-intervals (k, s) stand on (the blocks of k and of k + s), each
    counted once: the least the units' answers need of the index."""
    k = k.to(I64)
    return block_sectors(torch.cat([k >> 6, (k + s.to(I64)) >> 6]))
