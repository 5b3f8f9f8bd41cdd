"""ctypes wrappers of the Hopper seeding kernels (csrc/seed_smem.cu): the
three rounds and sa_query, a warp a read or job, and the window of the
index's root (prmi_window, or kmer_window for the ERT root), a thread a key,
each in the variant of the index's layout (its mode, 1-4, and its width) and
root, whose launches are counted under the variant's own name
(``ops.launch.variant``).

Checks, launch and launch counts are those of ops/launch.py. The plain
PyTorch versions live in ops/seed_smem.py and ops/sa_search.py;
ops/seed_smem.py dispatches to these wrappers for CUDA tensors only. A
kernel's optional ``counts`` output is what the warps counted of themselves
(their traffic and their dependent steps); what the data needs, whatever the
kernel's design, is the plain versions' ``work`` (ops.sa_search.Work).
"""

from __future__ import annotations

import ctypes

import torch

from bwameme_tpu_torch.index.device import DeviceIndex
from bwameme_tpu_torch.ops.launch import (check, cuda_device, entry, launch,
                                          variant)

_WHAT = "the CUDA seeding kernels"


def _declare(lib) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # mode, wide, rk, sa, keys, text32, n_text_words, params, params64,
    # n_leaf, bits, n_sa, kmer_table, kmer_bits
    index = [I, I, P, P, P, P, LL, P, P, I, I, LL, P, I]
    lib.seed_round1_launch.argtypes = index + [
        P, I, P, P, P, I, P, I, I, I, P, P, P, P, P]
    lib.seed_round2_launch.argtypes = index + [
        P, I, P, P, I, P, I, P, P, I, I, I, I, I, P, P, P, P, P]
    lib.seed_round3_launch.argtypes = index + [
        P, I, P, I, P, I, I, I, I, P, P, P, P, P]
    lib.window_launch.argtypes = index + [P, P, I, P, P, P]
    lib.sa_query_launch.argtypes = index + [P, I, P, P, P, P, I, P, P, P]
    for fn in (lib.seed_round1_launch, lib.seed_round2_launch,
               lib.seed_round3_launch, lib.window_launch,
               lib.sa_query_launch):
        fn.restype = I


def _entry(di: DeviceIndex, fn_name: str):
    """A launcher of the library of the variants of the index's mode and
    root (ops/build.py)."""
    lib = f"seed_smem_m{di.mode}{'_kmer' if di.root == 'kmer' else ''}"
    return entry(lib, fn_name, _declare)


def _variant(di: DeviceIndex, name: str) -> str:
    return variant(name, di.mode, di.wide, di.root)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _index_args(di: DeviceIndex, dev: torch.device,
                leaves_only: bool = False) -> tuple:
    """The launchers' index arguments, every plane they read checked
    (DeviceIndex checked the planes' dtypes and shapes when it was made).
    ``leaves_only``: the kernel reads the root alone (the window), and the
    rank-indexed planes go as null."""
    planes = di.planes
    if leaves_only:
        planes = {k: planes[k] for k in ("params", "params64", "kmer_table")
                  if k in planes}
    for name, x in planes.items():
        check(x, name, x.dtype, tuple(x.shape), dev)
    if "rk" in planes and not di.wide and di.rk.data_ptr() % 16:
        raise ValueError("rk: rank rows must be 16-byte aligned")
    for name in ("ktext", "key2", "params64", "sa"):
        x = planes.get(name)    # a key is one 8-byte load
        if x is not None and x.data_ptr() % (
                x.element_size() * (2 if x.dim() == 2 else 1)):
            raise ValueError(f"{name}: not aligned to its loads")
    keys = planes.get("ktext", planes.get("key2"))
    return (di.mode, int(di.wide), _ptr(planes.get("rk")),
            _ptr(planes.get("sa")), _ptr(keys), di.text32.data_ptr(),
            di.text32.numel(), di.params.data_ptr(),
            _ptr(planes.get("params64")), di.params.shape[0], di.bits,
            di.n_sa, _ptr(planes.get("kmer_table")), di.kmer_bits)


def _query_args(qbuf, tables, lens, dev) -> tuple:
    """Checks the packed query buffer (2R, W), the (R, Lp) tables and the
    read lengths; returns (R, W, Lp)."""
    check(lens, "lens", torch.int32, (None,), dev)
    R = lens.shape[0]
    check(qbuf, "qbuf", torch.int32, (2 * R, None), dev)
    Lp = tables[0].shape[1] if tables[0].dim() == 2 else None
    for t in tables:
        check(t, "table", torch.int32, (R, Lp), dev)
    return R, qbuf.shape[1], Lp


def _outputs(di: DeviceIndex, R: int, M: int, dev):
    return (torch.empty((4, R, M), dtype=di.rank_dtype, device=dev),
            torch.empty((R,), dtype=torch.int32, device=dev),
            torch.empty((R,), dtype=torch.int32, device=dev))


def _counts_ptr(counts, n: int, dev):
    """``counts``, where given, is a (2, n) int32 tensor that each warp fills
    with what it counted of itself: the 32-byte sectors of rank rows and
    packed text it brought in (the design's traffic; the work the data needs
    is the plain versions' ``work``), and its dependent steps (a leaf
    record, a probe of rank rows, 128 bases of text)."""
    if counts is None:
        return None
    check(counts, "counts", torch.int32, (2, n), dev)
    return counts.data_ptr()


def seed_round1(di: DeviceIndex, qbuf, nf, nr, nvf, lens, minseed: int,
                M: int, counts=None):
    """Kernel form of seed_smem.seed_round1_torch."""
    dev = cuda_device(qbuf, _WHAT)
    R, W, Lp = _query_args(qbuf, (nf, nr, nvf), lens, dev)
    slots, nsm, dropped = _outputs(di, R, M, dev)
    cnt = _counts_ptr(counts, R, dev)
    if R:
        launch(_variant(di, "seed_round1"),
               _entry(di, "seed_round1_launch"), dev,
               *_index_args(di, dev), qbuf.data_ptr(), W, nf.data_ptr(),
               nr.data_ptr(), nvf.data_ptr(), Lp, lens.data_ptr(), R,
               minseed, M, slots.data_ptr(), nsm.data_ptr(),
               dropped.data_ptr(), cnt)
    return slots, nsm, dropped


def seed_round2(di: DeviceIndex, qbuf, nf, nr, lens, slots1, nsm1,
                split_len: int, split_width: int, minseed: int, M: int,
                counts=None):
    """Kernel form of seed_smem.seed_round2_torch."""
    dev = cuda_device(qbuf, _WHAT)
    R, W, Lp = _query_args(qbuf, (nf, nr), lens, dev)
    check(slots1, "slots1", di.rank_dtype, (4, R, None), dev)
    check(nsm1, "nsm1", torch.int32, (R,), dev)
    slots, nsm, dropped = _outputs(di, R, M, dev)
    cnt = _counts_ptr(counts, R, dev)
    if R:
        launch(_variant(di, "seed_round2"),
               _entry(di, "seed_round2_launch"), dev,
               *_index_args(di, dev), qbuf.data_ptr(), W, nf.data_ptr(),
               nr.data_ptr(), Lp, lens.data_ptr(), R, slots1.data_ptr(),
               nsm1.data_ptr(), slots1.shape[2], split_len, split_width,
               minseed, M, slots.data_ptr(), nsm.data_ptr(),
               dropped.data_ptr(), cnt)
    return slots, nsm, dropped


def seed_round3(di: DeviceIndex, qbuf, nf, lens, min_intv: int,
                min_seed: int, M: int, counts=None):
    """Kernel form of seed_smem.seed_round3_torch."""
    dev = cuda_device(qbuf, _WHAT)
    R, W, Lp = _query_args(qbuf, (nf,), lens, dev)
    slots, nsm, dropped = _outputs(di, R, M, dev)
    cnt = _counts_ptr(counts, R, dev)
    if R:
        launch(_variant(di, "seed_round3"),
               _entry(di, "seed_round3_launch"), dev,
               *_index_args(di, dev), qbuf.data_ptr(), W, nf.data_ptr(),
               Lp, lens.data_ptr(), R, min_intv, min_seed, M,
               slots.data_ptr(), nsm.data_ptr(), dropped.data_ptr(),
               cnt)
    return slots, nsm, dropped


def prmi_window(di: DeviceIndex, khi, klo):
    """The P-RMI window alone: khi, klo (n,) int32 storage of uint32 key
    words; returns (lo, hi), (n,) int32 (int64 over a wide index)."""
    if di.root != "prmi":
        raise ValueError("prmi_window: the index has the k-mer root")
    return _window(di, khi, klo)


def kmer_window(di: DeviceIndex, khi, klo):
    """The k-mer root's window alone, as prmi_window takes and returns it,
    for an index with the ERT root."""
    if di.root != "kmer":
        raise ValueError("kmer_window: the index has no k-mer root")
    return _window(di, khi, klo)


def _window(di: DeviceIndex, khi, klo):
    dev = cuda_device(khi, _WHAT)
    check(khi, "khi", torch.int32, (None,), dev)
    n = khi.shape[0]
    check(klo, "klo", torch.int32, (n,), dev)
    lo = torch.empty((n,), dtype=di.rank_dtype, device=dev)
    hi = torch.empty_like(lo)
    if n:
        launch(_variant(di, "prmi_window"), _entry(di, "window_launch"), dev,
               *_index_args(di, dev, leaves_only=True), khi.data_ptr(),
               klo.data_ptr(), n,
               lo.data_ptr(), hi.data_ptr())
    return lo, hi


def sa_query(di: DeviceIndex, qbuf, row, pivot, v, min_intv, counts=None):
    """sa_query alone over n jobs: qbuf (rows, W) int32 storage, row, pivot,
    v, min_intv (n,) int32 with row in [0, rows) and pivot >= 0; returns
    (3, n) mlen, lb, cnt, int32 (int64 over a wide index)."""
    dev = cuda_device(qbuf, _WHAT)
    check(qbuf, "qbuf", torch.int32, (None, None), dev)
    check(row, "row", torch.int32, (None,), dev)
    n = row.shape[0]
    for name, x in (("pivot", pivot), ("v", v), ("min_intv", min_intv)):
        check(x, name, torch.int32, (n,), dev)
    out = torch.empty((3, n), dtype=di.rank_dtype, device=dev)
    cnt = _counts_ptr(counts, n, dev)
    if n:
        launch(_variant(di, "sa_query"), _entry(di, "sa_query_launch"), dev,
               *_index_args(di, dev), qbuf.data_ptr(), qbuf.shape[1],
               row.data_ptr(), pivot.data_ptr(), v.data_ptr(),
               min_intv.data_ptr(), n, out.data_ptr(), cnt)
    return out
