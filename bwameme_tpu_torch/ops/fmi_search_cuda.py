"""ctypes wrappers of the Hopper FM-index kernels (csrc/fmi_search.cu):
``fmi_backward_ext`` (a thread a unit), ``fmi_sa_lookup`` (a thread a rank)
and ``fmi_smem`` (a warp a read: the read's three SMEM rounds to their end
in one launch, each backward step's list of intervals split across the
lanes).

Checks, launch and launch counts are those of ops/launch.py. The plain
PyTorch versions are ``DeviceFmIndex``'s methods (ops/fmi_search.py) and,
for ``fmi_smem``, the wave engine of seeding/fmi_engine.py;
ops/fmi_search.py and the engine dispatch to these wrappers for CUDA tensors
only.
"""

from __future__ import annotations

import ctypes

import torch

from bwameme_tpu_torch.ops.fmi_search import DeviceFmIndex
from bwameme_tpu_torch.ops.launch import check, cuda_device, entry, launch

_WHAT = "the CUDA FM-index kernels"


def _declare(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    fmi = [P, P, P, I, I]   # count, blocks, sa_comp, nb, sentinel
    lib.fmi_backward_ext_launch.argtypes = fmi + [P, P, P, P, I, P, P]
    lib.fmi_sa_lookup_launch.argtypes = fmi + [P, I, P, P]
    lib.fmi_smem_launch.argtypes = fmi + [P, I, P, I, I, I, I, I, I, P, P, P,
                                          P, P]
    for fn in (lib.fmi_backward_ext_launch, lib.fmi_sa_lookup_launch,
               lib.fmi_smem_launch):
        fn.restype = I


def _entry(fn_name: str):
    return entry("fmi_search", fn_name, _declare)


def _fmi_args(dfm: DeviceFmIndex, dev) -> tuple:
    """The index as the launchers take it; the five counts go to the kernel
    as a parameter, from the index's host copy of them."""
    check(dfm.blocks, "blocks", torch.int32, (None, 8), dev)
    check(dfm.sa_comp, "sa_comp", torch.int32, (None,), dev)
    if dfm.blocks.data_ptr() % 32:
        raise ValueError("blocks: not 32-byte aligned")
    # the array itself rides in the arguments: it lives through the call
    counts = (ctypes.c_int * 5)(*dfm.counts)
    return (counts, dfm.blocks.data_ptr(), dfm.sa_comp.data_ptr(),
            dfm.n_blocks, dfm.sentinel)


def backward_ext(dfm: DeviceFmIndex, k, l, s, a):
    """n units (k, l, s, a), (n,) int32 on the card with 0 <= k and
    k + s <= n + 1; returns (3, n) int32 (nk, nl, ns)."""
    dev = cuda_device(k, _WHAT)
    check(k, "k", torch.int32, (None,), dev)
    n = k.shape[0]
    for name, x in (("l", l), ("s", s), ("a", a)):
        check(x, name, torch.int32, (n,), dev)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    if n:
        launch("fmi_backward_ext", _entry("fmi_backward_ext_launch"), dev,
               *_fmi_args(dfm, dev), k.data_ptr(), l.data_ptr(),
               s.data_ptr(), a.data_ptr(), n, out.data_ptr())
    return out


def sa_lookup(dfm: DeviceFmIndex, rank):
    """(n,) int32 ranks in [0, n_text + 1) -> (n,) int32 text positions."""
    dev = cuda_device(rank, _WHAT)
    check(rank, "rank", torch.int32, (None,), dev)
    n = rank.shape[0]
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        launch("fmi_sa_lookup", _entry("fmi_sa_lookup_launch"), dev,
               *_fmi_args(dfm, dev), rank.data_ptr(), n, pos.data_ptr())
    return pos


def smem(dfm: DeviceFmIndex, codes, lens, min_seed: int, split_len: int,
         split_width: int, max_mem_intv: int, M: int, steps=None):
    """The three SMEM rounds of R reads: codes (R, L) uint8 (4 for N and
    past a read's end is never read), lens (R,) int32. Returns (slots, nsm):
    slots (4, R, M) int32 start, end, k (the interval's first rank), s (its
    count) in FmiHostEngine's emission order; nsm (R,) int32, each read's
    emissions, more than M where some found no slot (the caller reruns
    those reads with more). ``steps``, where given, (3, R) int32: each
    read's forward extensions and its backward steps' chunks of 32 entries
    (the warp's dependent steps, those two), and its backward extensions."""
    dev = cuda_device(codes, _WHAT)
    check(lens, "lens", torch.int32, (None,), dev)
    R = lens.shape[0]
    check(codes, "codes", torch.uint8, (R, None), dev)
    L = codes.shape[1]
    if steps is not None:
        check(steps, "steps", torch.int32, (3, R), dev)
    slots = torch.empty((4, R, M), dtype=torch.int32, device=dev)
    nsm = torch.empty((R,), dtype=torch.int32, device=dev)
    # each read's intervals in flight (k, l, s, end): at most one a base,
    # and one more
    scratch = torch.empty((R, L + 1, 4), dtype=torch.int32, device=dev)
    if R:
        launch("fmi_smem", _entry("fmi_smem_launch"), dev,
               *_fmi_args(dfm, dev), codes.data_ptr(), L, lens.data_ptr(), R,
               min_seed, split_len, split_width, max_mem_intv, M,
               slots.data_ptr(), nsm.data_ptr(), scratch.data_ptr(),
               None if steps is None else steps.data_ptr())
    return slots, nsm
