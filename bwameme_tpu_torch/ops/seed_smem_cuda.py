"""ctypes wrappers of the Hopper seeding kernels (csrc/seed_smem.cu): the
three rounds and sa_query, a warp a read or job, and the window of the
index's root (prmi_window, or kmer_window for the ERT root), a thread a key,
each in the variant of the index's layout (its mode, 1-4, and its width) and
root, whose launches are counted under the variant's own name
(``ops.launch.variant``).

Over a sharded index (``DeviceIndex.shards``) the rounds and sa_query
launch the sharded variants (csrc/seed_smem.cu built with SEED_SHARDED, a
library a mode), which read each rank's row through the planes' block
tables; their launches count under ``...[shard]``. A launch takes the
index's view from its own card (``DeviceIndex.on``): the text, the leaves
and the block tables there. Blocks on another card than the launch's are
read through peer pointers: the first launch enables peer access once a
pair, and a pair of cards without it raises. The window reads no
per-suffix plane and launches the whole index's variant.

Checks, launch and launch counts are those of ops/launch.py. The plain
PyTorch versions live in ops/seed_smem.py and ops/sa_search.py;
ops/seed_smem.py dispatches to these wrappers for CUDA tensors only. A
kernel's optional ``counts`` output is what the warps counted of themselves
(their traffic and their dependent steps); what the data needs, whatever the
kernel's design, is the plain versions' ``work`` (ops.sa_search.Work).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bwameme_tpu_torch.index.device import (DeviceIndex, ShardedPlane,
                                            block_reciprocal)
from bwameme_tpu_torch.ops.launch import (check, cuda_device, entry, launch,
                                          variant)

_WHAT = "the CUDA seeding kernels"
# pairs of cards (the launch's, a block's) with peer access enabled
_peers: set = set()


def _declare(lib, sharded: bool = False) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # mode, wide, rk, sa, keys, text32, n_text_words, params, params64,
    # n_leaf, bits, n_sa, kmer_table, kmer_bits; sharded: rk, sa and keys
    # are block tables, then block_rows, its reciprocal, the blocks and the
    # bits of those on another card than the launch's
    index = [I, I, P, P, P, P, LL, P, P, I, I, LL, P, I] + (
        [LL, ctypes.c_ulonglong, I, ctypes.c_uint] if sharded else [])
    lib.seed_round1_launch.argtypes = index + [
        P, I, P, P, P, I, P, I, I, I, P, P, P, P, P]
    lib.seed_round2_launch.argtypes = index + [
        P, I, P, P, I, P, I, P, P, I, I, I, I, I, P, P, P, P, P]
    lib.seed_round3_launch.argtypes = index + [
        P, I, P, I, P, I, I, I, I, P, P, P, P, P]
    lib.sa_query_launch.argtypes = index + [P, I, P, P, P, P, I, P, P, P]
    fns = [lib.seed_round1_launch, lib.seed_round2_launch,
           lib.seed_round3_launch, lib.sa_query_launch]
    if sharded:
        lib.enable_peer_access.argtypes = [I, I]
        fns.append(lib.enable_peer_access)
    else:
        lib.window_launch.argtypes = index + [P, P, I, P, P, P]
        fns.append(lib.window_launch)
    for fn in fns:
        fn.restype = I


_declare_sharded = functools.partial(_declare, sharded=True)


def _sharded(di: DeviceIndex, fn_name: str) -> bool:
    return di.shards is not None and fn_name != "window_launch"


def _entry(di: DeviceIndex, fn_name: str):
    """A launcher of the library of the variants of the index's mode and
    root (ops/build.py), the sharded variants' library a mode over a
    sharded index."""
    if _sharded(di, fn_name):
        return entry(f"seed_smem_sharded_m{di.mode}", fn_name,
                     _declare_sharded)
    lib = f"seed_smem_m{di.mode}{'_kmer' if di.root == 'kmer' else ''}"
    return entry(lib, fn_name, _declare)


def _variant(di: DeviceIndex, name: str) -> str:
    return variant(name, di.mode, di.wide, di.root,
                   di.shards is not None and name != "prmi_window")


def _ptr(x) -> int | None:
    if x is None:
        return None
    return (x.table if isinstance(x, ShardedPlane) else x).data_ptr()


def peer_access(dev: torch.device, devices, mode: int = 4) -> None:
    """Lets card ``dev`` read the memory of the cards ``devices``, once a
    pair (through the sharded library of ``mode``); raises for a pair of
    cards that cannot."""
    for d in devices:
        if d == dev or (dev, d) in _peers:
            continue
        if not torch.cuda.can_device_access_peer(dev, d):
            raise RuntimeError(f"the sharded index has a block on {d}, which "
                               f"{dev} cannot read (no peer access between "
                               "the two cards)")
        err = entry(f"seed_smem_sharded_m{mode}", "enable_peer_access",
                    _declare_sharded)(dev.index, d.index)
        if err != 0:
            raise RuntimeError(f"enabling peer access from {dev} to {d} "
                               f"failed with CUDA error {err}")
        _peers.add((dev, d))


def _check_plane(di: DeviceIndex, x, name: str, dev: torch.device) -> None:
    """A whole plane on ``dev``; a sharded one's table on ``dev`` and its
    blocks on cards that ``dev`` reads."""
    if not isinstance(x, ShardedPlane):
        check(x, name, x.dtype, tuple(x.shape), dev)
        return
    check(x.table, f"{name} block table", torch.int64, (len(x.blocks),), dev)
    for s, blk in enumerate(x.blocks):
        if blk.device.type != dev.type:
            raise ValueError(f"{name} block {s}: on {blk.device}, expected "
                             f"a {dev.type} device")
        check(blk, f"{name} block {s}", x.dtype, tuple(blk.shape),
              blk.device)
    peer_access(dev, x.devices, di.mode)


def _aligned(x, name: str, step: int | None = None) -> None:
    """Raises unless the plane (each block of a sharded one) starts at a
    multiple of ``step`` bytes, by default of its row (a key is one 8-byte
    load)."""
    for t in (x.blocks if isinstance(x, ShardedPlane) else (x,)):
        if t.data_ptr() % (step or t.element_size() * (
                2 if t.dim() == 2 else 1)):
            raise ValueError(f"{name}: not aligned to its loads")


def _index_args(di: DeviceIndex, dev: torch.device,
                leaves_only: bool = False) -> tuple:
    """The launchers' index arguments, every plane they read checked
    (DeviceIndex checked the planes' dtypes and shapes when it was made).
    ``leaves_only``: the kernel reads the root alone (the window), and the
    rank-indexed planes go as null. Over a sharded index the per-suffix
    planes go as their block tables, followed by the rows a block."""
    planes = di.planes
    if leaves_only:
        planes = {k: planes[k] for k in ("params", "params64", "kmer_table")
                  if k in planes}
    for name, x in planes.items():
        _check_plane(di, x, name, dev)
    if "rk" in planes and not di.wide:
        _aligned(planes["rk"], "rk", 16)    # rank rows are one 16-byte load
    for name in ("ktext", "key2", "params64", "sa"):
        if name in planes:
            _aligned(planes[name], name)
    keys = planes.get("ktext", planes.get("key2"))
    args = (di.mode, int(di.wide), _ptr(planes.get("rk")),
            _ptr(planes.get("sa")), _ptr(keys), di.text32.data_ptr(),
            di.text32.numel(), di.params.data_ptr(),
            _ptr(planes.get("params64")), di.params.shape[0], di.bits,
            di.n_sa, _ptr(planes.get("kmer_table")), di.kmer_bits)
    if leaves_only or di.shards is None:
        return args
    plane = planes["rk" if di.mode == 4 else "sa"]
    return args + (plane.block_rows, block_reciprocal(plane.block_rows,
                                                      di.wide),
                   len(plane.blocks), remote_blocks(plane, dev))


def remote_blocks(plane: ShardedPlane, dev: torch.device) -> int:
    """Bit s set where block s lies on another card than ``dev``: what the
    sharded kernels' counts take as a remote step."""
    return sum(1 << s for s, d in enumerate(plane.devices) if d != dev)


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


def count_rows(di: DeviceIndex) -> int:
    """The rows of a kernel's ``counts``: 3 over a sharded index, else 2."""
    return 2 if di.shards is None else 3


def _counts_ptr(di: DeviceIndex, counts, n: int, dev):
    """``counts``, where given, is a (count_rows(di), n) int32 tensor that
    each warp fills with what it counted of itself: the 32-byte sectors of
    rank rows and packed text it brought in (the design's traffic; the work
    the data needs is the plain versions' ``work``), its dependent steps (a
    leaf record, a probe of rank rows, 128 bases of text), and over a
    sharded index those of its steps that waited on a block on another card
    than the launch's (``remote_blocks``)."""
    if counts is None:
        return None
    check(counts, "counts", torch.int32, (count_rows(di), n), dev)
    return counts.data_ptr()


def seed_round1(di: DeviceIndex, qbuf, nf, nr, nvf, lens, minseed: int,
                M: int, counts=None):
    """Kernel form of seed_smem.seed_round1_torch."""
    dev = cuda_device(qbuf, _WHAT)
    R, W, Lp = _query_args(qbuf, (nf, nr, nvf), lens, dev)
    slots, nsm, dropped = _outputs(di, R, M, dev)
    cnt = _counts_ptr(di, counts, R, dev)
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
    cnt = _counts_ptr(di, counts, R, dev)
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
    cnt = _counts_ptr(di, counts, R, dev)
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
    cnt = _counts_ptr(di, counts, n, dev)
    if n:
        launch(_variant(di, "sa_query"), _entry(di, "sa_query_launch"), dev,
               *_index_args(di, dev), qbuf.data_ptr(), qbuf.shape[1],
               row.data_ptr(), pivot.data_ptr(), v.data_ptr(),
               min_intv.data_ptr(), n, out.data_ptr(), cnt)
    return out
