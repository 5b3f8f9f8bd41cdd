"""The part of the learned index that lives on the device.

Port of ``DeviceIndex`` (bwameme_tpu/ops/sa_search.py:44-300) for the default
layout: mode 4, int32 coordinates, one device.

* ``rk``     (N, 4) rank rows: (sa[r], key_hi[r], key_lo[r], bases 32..48 of
  the suffix) - one 16-byte read gives a probe its text position and the
  first 48 bases of the suffix;
* ``text32`` the packed text plus reverse complement, 16 bases a word, most
  significant bits first, followed by the all-T guard words that deep
  compares and extension windows run into;
* ``params`` (L, 6) fused P-RMI leaf records: (leaf_start, leaf_end,
  alpha bits, beta bits, err_lo, err_hi).

All three are uint32 words held as ``torch.int32`` storage (torch has no
uint32 arithmetic): the CUDA kernels read them as ``uint32_t`` and the plain
versions widen them to int64 (``words_u32``). Modes 1-3, wide (int64)
coordinates and the k-mer root are not ported (ROADMAP Queue 1 items 10-11)
and raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# device memory kept free for the query tables, emission slots, packed
# results and the extension kernels' scratch, on top of the index planes
HEADROOM_BYTES = 1 << 30


def words_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage of uint32 words, widened to their unsigned value."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _as_i32(a, shape_tail=None) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:  # a loaded index memory-maps its planes
        a = a.copy()
    if shape_tail is not None and a.shape[1:] != shape_tail:
        raise ValueError(f"expected (*, {shape_tail}) words, got {a.shape}")
    return a.view(np.int32)


def fuse_rmi_params(idx) -> np.ndarray:
    """(L, 6) uint32 leaf records (bwameme_tpu/ops/sa_search.py:122-135)."""
    ls = np.asarray(idx.rmi_leaf_start, np.int64)
    p = np.empty((len(ls) - 1, 6), np.uint32)
    p[:, 0] = ls[:-1].astype(np.uint32)
    p[:, 1] = ls[1:].astype(np.uint32)
    p[:, 2] = np.asarray(idx.rmi_alpha, np.float32).view(np.uint32)
    p[:, 3] = np.asarray(idx.rmi_beta, np.float32).view(np.uint32)
    p[:, 4] = np.asarray(idx.rmi_err_lo, np.uint32)
    p[:, 5] = np.asarray(idx.rmi_err_hi, np.uint32)
    return p


def mode4_rows(idx) -> np.ndarray:
    """(N, 4) uint32 rank rows, by the native host library or in numpy
    (bwameme_tpu/ops/sa_search.py:215-248)."""
    from bwameme_tpu_torch.align.native import build_mode4_rows_native

    rows = build_mode4_rows_native(idx.sa, idx.key_hi, idx.key_lo, idx.isa,
                                   wide=False)
    if rows is not None:
        return rows
    n = len(idx.sa)
    pos = np.asarray(idx.sa, np.int64)
    kh_t = idx.key_hi[idx.isa]  # 16 bases at text position p
    rows = np.empty((n, 4), np.uint32)
    rows[:, 0] = pos.astype(np.uint32)
    rows[:, 1] = idx.key_hi
    rows[:, 2] = idx.key_lo
    nxt = pos + 32
    rows[:, 3] = np.where(nxt < n, kh_t[np.minimum(nxt, n - 1)],
                          np.uint32(0xFFFFFFFF))
    return rows


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    rk: torch.Tensor       # int32 storage of uint32[N, 4]
    text32: torch.Tensor   # int32 storage of uint32[Wt]
    params: torch.Tensor   # int32 storage of uint32[L, 6]
    bits: int
    n_sa: int

    @classmethod
    def from_numpy(cls, rk, text32, params, bits: int, n_sa: int,
                   device) -> "DeviceIndex":
        """From the arrays of a bwameme_tpu ``DeviceIndex`` (mode 4, narrow)
        as numpy: the state that carries across from the JAX package."""
        bits, n_sa = int(bits), int(n_sa)
        if not 1 <= bits <= 31:
            raise ValueError(f"rmi bits {bits} outside 1..31")
        if n_sa >= 2**31:
            raise ValueError(
                f"n_sa={n_sa} needs wide (int64) device coordinates, not "
                "ported yet (ROADMAP Queue 1 item 10)")
        rk = _as_i32(rk, (4,))
        params = _as_i32(params, (6,))
        text32 = _as_i32(text32)
        if rk.shape[0] != n_sa or text32.ndim != 1 or params.shape[0] < 1:
            raise ValueError("rk, text32 or params has the wrong shape")
        device = torch.device(device)
        need = rk.nbytes + text32.nbytes + params.nbytes
        if device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(device)
            if need + HEADROOM_BYTES > free:
                raise RuntimeError(
                    f"the mode-4 index needs {need / 2**30:.2f} GiB plus "
                    f"{HEADROOM_BYTES / 2**30:.0f} GiB of working memory; "
                    f"{free / 2**30:.2f} GiB are free on {device} (mode 1 is "
                    "ROADMAP Queue 1 item 10)")
        # torch.from_numpy shares memory on the CPU: the arrays above are
        # fresh copies or views of the caller's, and are only read
        return cls(rk=torch.from_numpy(rk).to(device),
                   text32=torch.from_numpy(text32).to(device),
                   params=torch.from_numpy(params).to(device),
                   bits=bits, n_sa=n_sa)

    @classmethod
    def from_host(cls, idx, device, mode: int | None = None) -> "DeviceIndex":
        """Build the device planes from a ``MemeIndex``."""
        if mode not in (None, 4):
            raise NotImplementedError(
                f"index mode {mode} is not ported yet; only mode 4 is "
                "(ROADMAP Queue 1 item 10)")
        if idx.n_sa >= 2**31:
            raise ValueError(
                f"n_sa={idx.n_sa} needs wide (int64) device coordinates, not "
                "ported yet (ROADMAP Queue 1 item 10)")
        if idx.isa is None:
            raise ValueError(
                "mode 4 needs the inverse suffix array (index built with "
                "--no-isa); the modes without it are ROADMAP Queue 1 item 10")
        return cls.from_numpy(mode4_rows(idx), idx.text32,
                              fuse_rmi_params(idx), idx.rmi_bits, idx.n_sa,
                              device)

    @property
    def device(self) -> torch.device:
        return self.rk.device

    @property
    def max_width(self) -> int:
        """Widest P-RMI error window (err_lo + err_hi over the leaves)."""
        p = words_u32(self.params[:, 4:6])
        return int((p[:, 0] + p[:, 1]).max())


@dataclasses.dataclass(frozen=True)
class DeviceText:
    """The packed text alone (see ``DeviceIndex.text32``), for runs that
    seed on the host and only extend on the device."""

    text32: torch.Tensor

    @classmethod
    def from_host(cls, idx, device) -> "DeviceText":
        # copy: a loaded index memory-maps its planes read-only
        words = np.array(idx.text32, dtype=np.uint32).view(np.int32)
        return cls(torch.from_numpy(words).to(torch.device(device)))

    @property
    def device(self) -> torch.device:
        return self.text32.device
