"""The part of the learned index that lives on the device.

Port of ``DeviceIndex`` (bwameme_tpu/ops/sa_search.py:44-300) on one device,
in the four memory modes of the reference (its MODE axis) and in narrow
(int32) or wide (int64) coordinates. A mode changes only where a compare
reads a suffix's first bases, never the result of the compare:

====  ==========================================  ============  ============
mode  planes besides the text and the leaves      B a suffix    first bases
====  ==========================================  ============  ============
4     ``rk`` rank rows (sa[r], key_hi[r],         16 / 20       48, the row
      key_lo[r], bases 32..48); wide rows
      (pos_lo, pos_hi, key_hi, key_lo, b48)
3     ``sa``, ``ktext`` (N, 2) 32-base keys by    12 / 16       32, ktext
      text position                                             at sa[r]
2     ``sa``, ``key2`` (N, 2) 32-base keys by     12 / 16       32, key2[r]
      rank
1     ``sa`` only                                 4 / 8         none
====  ==========================================  ============  ============

(bytes a suffix narrow / wide). From the first base the head does not cover,
a compare reads the packed text. Every mode has

* ``text32`` the packed text plus reverse complement, 16 bases a word, most
  significant bits first, followed by the all-T guard words that deep
  compares and extension windows run into;
* ``params`` (L, 6) fused P-RMI leaf records: (leaf_start, leaf_end,
  alpha bits, beta bits, err_lo, err_hi);
* wide: ``params64`` int64[L + 1], the leaf starts, which pass 2^32 in a
  wide index (the records keep the model's bits and the error widths).

Packed words are uint32 held as ``torch.int32`` storage (torch has no uint32
arithmetic): the CUDA kernels read them as ``uint32_t`` and the plain
versions widen them to int64 (``words_u32``). ``sa`` is int32 narrow and
int64 wide. The k-mer (ERT) root is not ported (ROADMAP Queue 1 item 6) and
raises; so does a layout that does not fit the card, never moving to
another mode.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# device memory kept free for the query tables, emission slots, packed
# results and the extension kernels' scratch, on top of the index planes
HEADROOM_BYTES = 1 << 30
# the mode ladder's device memory where the device reports none (the CPU):
# the JAX package's default; BWAMEME_HBM_BYTES overrides either
DEFAULT_DEVICE_BYTES = 16 << 30
# the first bases of a suffix that a compare takes from the mode's planes
HEAD_BASES = {4: 48, 3: 32, 2: 32, 1: 0}
PLANES = ("rk", "sa", "ktext", "key2", "params64")


def words_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage of uint32 words, widened to their unsigned value."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _writable(a, dtype=None) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    # a loaded index memory-maps its planes, a JAX array reads as a view
    return a if a.flags.writeable else a.copy()


def _as_i32(a) -> np.ndarray:
    return _writable(a, np.uint32).view(np.int32)


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


def wide_rmi_params(idx) -> np.ndarray:
    """int64[L + 1] leaf starts of a wide index (le = the next ls); an error
    window of 2^31 or more is a degenerate model and raises
    (bwameme_tpu/ops/sa_search.py:137-146)."""
    if (np.asarray(idx.rmi_err_lo, np.int64).max(initial=0) >= 2**31
            or np.asarray(idx.rmi_err_hi, np.int64).max(initial=0) >= 2**31):
        raise ValueError("P-RMI error window >= 2^31: degenerate model; "
                         "retrain with more leaf bits")
    return np.asarray(idx.rmi_leaf_start, np.int64)


def mode4_rows(idx, wide: bool = False) -> np.ndarray:
    """(N, 4) uint32 rank rows, (N, 5) wide, by the native host library or
    in numpy (bwameme_tpu/ops/sa_search.py:215-248)."""
    from bwameme_tpu_torch.align.native import build_mode4_rows_native

    rows = build_mode4_rows_native(idx.sa, idx.key_hi, idx.key_lo, idx.isa,
                                   wide=wide)
    if rows is not None:
        return rows
    n = len(idx.sa)
    pos = np.asarray(idx.sa, np.int64)
    kh_t = idx.key_hi[idx.isa]  # 16 bases at text position p
    kw = 2 if wide else 1
    rows = np.empty((n, kw + 3), np.uint32)
    rows[:, 0] = (pos & 0xFFFFFFFF).astype(np.uint32)
    if wide:
        rows[:, 1] = (pos >> 32).astype(np.uint32)
    rows[:, kw] = idx.key_hi
    rows[:, kw + 1] = idx.key_lo
    nxt = pos + 32
    rows[:, kw + 2] = np.where(nxt < n, kh_t[np.minimum(nxt, n - 1)],
                               np.uint32(0xFFFFFFFF))
    return rows


def device_bytes(device: torch.device) -> int:
    """The device memory the mode ladder budgets from: BWAMEME_HBM_BYTES
    where set, else the card's total, else DEFAULT_DEVICE_BYTES."""
    env = os.environ.get("BWAMEME_HBM_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return DEFAULT_DEVICE_BYTES


def choose_mode(n_sa: int, has_isa: bool, wide: bool, hbm: int) -> int:
    """The JAX package's ladder (bwameme_tpu/ops/sa_search.py:192-214): the
    fastest layout whose planes fit three quarters of the device's memory,
    at 16 bytes a suffix for mode 4 (narrow only), 12 for modes 3 (with the
    ISA) and 2 (without), mode 1 otherwise."""
    budget = int(hbm * 0.75)
    if has_isa and not wide and n_sa * 16 <= budget:
        return 4
    if has_isa and n_sa * 12 <= budget:
        return 3
    if not has_isa and n_sa * 12 <= budget:
        return 2
    return 1


def _check(x, name: str, dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, x.shape)):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    text32: torch.Tensor   # int32 storage of uint32[Wt]
    params: torch.Tensor   # int32 storage of uint32[L, 6]
    bits: int
    n_sa: int
    mode: int = 4
    wide: bool = False
    rk: torch.Tensor | None = None        # mode 4: uint32[N, 4] / [N, 5]
    sa: torch.Tensor | None = None        # modes 1-3: int32[N] / int64[N]
    ktext: torch.Tensor | None = None     # mode 3: uint32[N, 2]
    key2: torch.Tensor | None = None      # mode 2: uint32[N, 2]
    params64: torch.Tensor | None = None  # wide: int64[L + 1]

    def __post_init__(self) -> None:
        """The planes of exactly one layout, in the dtypes and shapes the
        kernels read (raises otherwise)."""
        n, wide, mode = self.n_sa, self.wide, self.mode
        if not 1 <= self.bits <= 31:
            raise ValueError(f"rmi bits {self.bits} outside 1..31")
        if mode not in HEAD_BASES:
            raise ValueError(f"mode must be 1, 2, 3 or 4, got {mode}")
        if n >= 2**31 and not wide:
            raise ValueError(f"n_sa={n} exceeds int32 device coordinates: "
                             "upload with wide=True (int64 ranks and "
                             "positions)")
        want = {"rk": mode == 4, "sa": mode != 4, "ktext": mode == 3,
                "key2": mode == 2, "params64": wide}
        for name in PLANES:
            if (getattr(self, name) is not None) != want[name]:
                raise ValueError(f"mode {mode}{' wide' if wide else ''}: "
                                 f"{name} must be "
                                 f"{'given' if want[name] else 'absent'}")
        _check(self.text32, "text32", torch.int32, (None,))
        _check(self.params, "params", torch.int32, (None, 6))
        if self.params.shape[0] < 1:
            raise ValueError("params: no leaf record")
        if mode == 4:
            _check(self.rk, "rk", torch.int32, (n, 5 if wide else 4))
        else:
            # wide positions and ranks arrive as int64, narrow as int32
            _check(self.sa, "sa", torch.int64 if wide else torch.int32, (n,))
        for name in ("ktext", "key2"):
            if getattr(self, name) is not None:
                _check(getattr(self, name), name, torch.int32, (n, 2))
        if wide:
            _check(self.params64, "params64", torch.int64,
                   (self.params.shape[0] + 1,))

    @property
    def planes(self) -> dict:
        """Every device plane by name, the absent ones left out."""
        out = {"text32": self.text32, "params": self.params}
        out.update((k, getattr(self, k)) for k in PLANES
                   if getattr(self, k) is not None)
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.planes.values())

    @classmethod
    def from_tensors(cls, device=None, **kw) -> "DeviceIndex":
        """From planes given as tensors (on any one device, ``device`` moves
        them there): mode and width follow from the planes given. Before a
        move to a card, checks that the planes and HEADROOM_BYTES fit its
        free memory, and raises if not."""
        mode = (4 if kw.get("rk") is not None else
                3 if kw.get("ktext") is not None else
                2 if kw.get("key2") is not None else 1)
        di = cls(mode=mode, wide=kw.get("params64") is not None, **kw)
        if device is None:
            return di
        device = torch.device(device)
        if device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(device)
            if di.nbytes + HEADROOM_BYTES > free:
                raise RuntimeError(
                    f"the mode-{mode} index needs {di.nbytes / 2**30:.2f} "
                    f"GiB plus {HEADROOM_BYTES / 2**30:.0f} GiB of working "
                    f"memory; {free / 2**30:.2f} GiB are free on {device}")
        return dataclasses.replace(di, **{k: t.to(device) for k, t
                                          in di.planes.items()})

    @classmethod
    def from_numpy(cls, text32, params, bits: int, n_sa: int, device,
                   **planes) -> "DeviceIndex":
        """From the arrays of a bwameme_tpu ``DeviceIndex`` as numpy, any
        mode and width: the state that carries across from the JAX package.
        ``planes`` holds the layout's own (rk; sa and ktext or key2; and
        params64 when wide). Packed words arrive as uint32, positions and
        ranks as int32 narrow and int64 wide."""
        kw = {}
        for name, a in planes.items():
            if a is None:
                continue
            a = np.asarray(a)
            if name in ("sa", "params64"):
                # torch.from_numpy shares memory on the CPU: the planes are
                # only read
                kw[name] = torch.from_numpy(_writable(a))
            else:
                kw[name] = torch.from_numpy(_as_i32(a))
        return cls.from_tensors(
            device, text32=torch.from_numpy(_as_i32(text32)),
            params=torch.from_numpy(_as_i32(params)), bits=int(bits),
            n_sa=int(n_sa), **kw)

    @classmethod
    def from_host(cls, idx, device, mode: int | None = None,
                  wide: bool | None = None,
                  ert_bits: int | None = None) -> "DeviceIndex":
        """Build the device planes from a ``MemeIndex``. ``wide``: int64
        coordinates, by default when n_sa >= 2^31. ``mode``: by default the
        JAX package's ladder over the device's memory (``choose_mode``)."""
        if ert_bits is not None:
            raise NotImplementedError(
                "the ERT (k-mer) root is not ported yet (ROADMAP Queue 1 "
                "item 6)")
        device = torch.device(device)
        n = int(idx.n_sa)
        if wide is None:
            wide = n >= 2**31
        if mode is None:
            mode = choose_mode(n, idx.isa is not None, wide,
                               device_bytes(device))
        if mode in (3, 4) and idx.isa is None:
            raise ValueError(
                f"mode {mode} needs the inverse suffix array (the index was "
                "built with --no-isa): modes 1 and 2 serve it")
        planes = {}
        if mode == 4:
            planes["rk"] = mode4_rows(idx, wide)
        elif mode in (1, 2, 3):
            planes["sa"] = np.asarray(idx.sa).astype(
                np.int64 if wide else np.int32)
            if mode == 3:
                planes["ktext"] = np.stack([idx.key_hi[idx.isa],
                                            idx.key_lo[idx.isa]], axis=1)
            elif mode == 2:
                planes["key2"] = np.stack([idx.key_hi, idx.key_lo], axis=1)
        if wide:
            planes["params64"] = wide_rmi_params(idx)
        return cls.from_numpy(idx.text32, fuse_rmi_params(idx), idx.rmi_bits,
                              n, device, **planes)

    @property
    def device(self) -> torch.device:
        return self.text32.device

    @property
    def head_bases(self) -> int:
        return HEAD_BASES[self.mode]

    @property
    def rank_dtype(self) -> torch.dtype:
        """The dtype of ranks in the seeding kernels' results and slots."""
        return torch.int64 if self.wide else torch.int32

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
