"""ctypes wrappers of the Hopper full Smith-Waterman kernel
(csrc/sw_full.cu), both forms.

Checks, launch and launch counts are those of ops/launch.py: a call is one
launch, counted under ``sw_full``, whose warps run each job's forward pass
and, with_start, its reverse pass. The plain PyTorch versions live in
ops/sw_full.py, which dispatches to these wrappers for CUDA tensors only.
The wrapper allocates what the kernel writes beside its result (each job's
row maxima for score2, and the row state of jobs whose query passes
SHARED_CELLS, which the kernel keeps in device memory instead of shared
memory) and the order the warps take the jobs in, longest target first.
``steps``, when given, is a (2, n) int32 tensor the kernel fills with the
wavefront steps each job's passes ran (the reverse pass stops at the
forward score; 0 where it did not run).
"""

from __future__ import annotations

import ctypes

import torch

from bwameme_tpu_torch.ops.launch import check as _check
from bwameme_tpu_torch.ops.launch import cuda_device, entry
from bwameme_tpu_torch.ops.launch import launch as _launch

RESULT_ORDER = ("score", "te", "qe", "score2", "te2", "tb", "qb")
# query cells a warp keeps in shared memory, for the jobs whose columns are
# not in registers (queries past 256 bases, or scores past 6 bits); a
# launch with longer queries keeps those jobs' rows in a slice of device
# memory each
SHARED_CELLS = 1024
LANES = 32


def _declare(lib) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sw_full_pairs_launch.argtypes = [
        P, P, I, I, I, P, P, P, P, I, I, I, I, I, P, I, P, P, P, P, P]
    lib.sw_full_pairs_launch.restype = I
    lib.sw_full_coord_launch.argtypes = [
        P, LL, P, I, I, I, P, P, P, I, I, I, I, I, P, I, P, P, P, P, P]
    lib.sw_full_coord_launch.restype = I


def _entry(fn_name: str):
    return entry("sw_full", fn_name, _declare)


def _cuda_device(x) -> torch.device:
    return cuda_device(x, "the CUDA full-SW kernel")


def state_words(cells: int) -> int:
    """int32 words of a warp's row state for queries of up to ``cells``
    bases: H and E a cell, the query's codes a byte, in slots of LANES."""
    slots = -(-cells // LANES) * LANES
    return 2 * slots + slots // 4


def _scratch(n: int, Q: int, T: int, tlen, dev):
    """The launch's order (longest target first), cap and scratch."""
    order = torch.argsort(tlen, descending=True, stable=True).to(torch.int32)
    rowmax = torch.empty((n, max(T, 1)), dtype=torch.int32, device=dev)
    cap = -(-min(max(Q, 1), SHARED_CELLS) // LANES) * LANES
    overflow = (torch.empty(n * state_words(Q), dtype=torch.int32, device=dev)
                if Q > cap else None)
    return order, cap, overflow, rowmax


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _steps(steps, n: int, dev):
    if steps is not None:
        _check(steps, "steps", torch.int32, (2, n), dev)
    return steps


def sw_full_pairs(q, t, qlen, tlen, mat, min_sc, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, with_start: bool = True,
                  steps=None):
    """Kernel form of sw_full.sw_full_torch: q (B,Q) and t (B,T) int32 codes,
    (B,) int32 qlen, tlen and min_sc, mat (5,5) int32. Returns (7,B) int32,
    rows RESULT_ORDER. qlen and tlen are clamped to [0, Q] and [0, T]."""
    dev = _cuda_device(q)
    _check(q, "q", torch.int32, (None, None), dev)
    B, Q = q.shape
    _check(t, "t", torch.int32, (B, None), dev)
    T = t.shape[1]
    for name, x in (("qlen", qlen), ("tlen", tlen), ("min_sc", min_sc)):
        _check(x, name, torch.int32, (B,), dev)
    _check(mat, "mat", torch.int32, (5, 5), dev)
    steps = _steps(steps, B, dev)
    out = torch.empty((7, B), dtype=torch.int32, device=dev)
    if B:
        order, cap, overflow, rowmax = _scratch(B, Q, T, tlen, dev)
        _launch("sw_full", _entry("sw_full_pairs_launch"), dev, q.data_ptr(),
                t.data_ptr(), B, Q, T, qlen.data_ptr(), tlen.data_ptr(),
                min_sc.data_ptr(), mat.data_ptr(), o_del, e_del, o_ins,
                e_ins, int(with_start), order.data_ptr(), cap,
                _ptr(overflow), rowmax.data_ptr(), out.data_ptr(),
                _ptr(steps))
    return out


def sw_full_coord(text32, q, jobs, mat, min_sc, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, T: int, with_start: bool = True,
                  steps=None):
    """Kernel form of sw_full.sw_full_coord_torch: text32 int32 view of the
    packed text words, q (N,Q) uint8 codes, jobs (3,N) int32 rows qlen,
    tstart, tlen, (N,) int32 min_sc, mat (5,5) int32; targets of up to T
    rows. Returns (7,N) int32, rows RESULT_ORDER."""
    dev = _cuda_device(jobs)
    _check(text32, "text32", torch.int32, (None,), dev)
    _check(q, "q", torch.uint8, (None, None), dev)
    N, Q = q.shape
    _check(jobs, "jobs", torch.int32, (3, N), dev)
    _check(min_sc, "min_sc", torch.int32, (N,), dev)
    _check(mat, "mat", torch.int32, (5, 5), dev)
    if text32.numel() == 0:
        raise ValueError("text32 must be non-empty")
    steps = _steps(steps, N, dev)
    out = torch.empty((7, N), dtype=torch.int32, device=dev)
    if N:
        order, cap, overflow, rowmax = _scratch(N, Q, T, jobs[2], dev)
        _launch("sw_full", _entry("sw_full_coord_launch"), dev,
                text32.data_ptr(), text32.numel(), q.data_ptr(), N, Q, T,
                jobs.data_ptr(), min_sc.data_ptr(), mat.data_ptr(), o_del,
                e_del, o_ins, e_ins, int(with_start), order.data_ptr(), cap,
                _ptr(overflow), rowmax.data_ptr(), out.data_ptr(),
                _ptr(steps))
    return out
