"""ctypes wrapper of the Hopper banded global alignment kernel
(csrc/sw_global.cu).

Checks, launch and launch counts are those of ops/launch.py: a call is one
launch, counted under ``sw_global_coord``. The plain PyTorch version lives
in ops/sw_global.py, which dispatches to this wrapper for CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from bwameme_tpu_torch.ops.launch import check as _check
from bwameme_tpu_torch.ops.launch import cuda_device, entry
from bwameme_tpu_torch.ops.launch import launch as _launch


def _declare(lib) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sw_global_coord_launch.argtypes = [
        P, LL, P, P, I, LL, P, I, I, I, I, I, I, P, P]
    lib.sw_global_coord_launch.restype = I


def sw_global_coord(text32, codes, jobs, mat, l_pac: int, o_del: int,
                    e_del: int, o_ins: int, e_ins: int, slots: int,
                    budget_words: int):
    """Kernel form of sw_global.sw_global_coord_torch: text32 int32 view of
    the packed text words, codes (n,) uint8 the batch's read codes, jobs
    (5,N) int64 rows rb, qstart, qlen, rlen, w, mat (5,5) int32. Returns
    (N, 2 + slots) int32: score, runs (or a flag), the runs."""
    dev = cuda_device(jobs, "the CUDA global-alignment kernel")
    _check(text32, "text32", torch.int32, (None,), dev)
    _check(codes, "codes", torch.uint8, (None,), dev)
    _check(jobs, "jobs", torch.int64, (5, None), dev)
    _check(mat, "mat", torch.int32, (5, 5), dev)
    if text32.numel() == 0:
        raise ValueError("text32 must be non-empty")
    N = jobs.shape[1]
    out = torch.empty((N, 2 + slots), dtype=torch.int32, device=dev)
    if N:
        _launch("sw_global_coord",
                entry("sw_global", "sw_global_coord_launch", _declare), dev,
                text32.data_ptr(), text32.numel(), codes.data_ptr(),
                jobs.data_ptr(), N, l_pac, mat.data_ptr(), o_del, e_del,
                o_ins, e_ins, slots, budget_words, out.data_ptr())
    return out
