"""ctypes wrappers of the Hopper banded-SW kernels (csrc/banded_sw.cu).

Checks, launch and launch counts are those of ops/launch.py (``stats`` is
re-exported here). The plain PyTorch versions live in ops/banded_sw.py, which
dispatches to these wrappers for CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from bwameme_tpu_torch.ops.launch import check as _check
from bwameme_tpu_torch.ops.launch import cuda_device, entry
from bwameme_tpu_torch.ops.launch import launch as _launch
from bwameme_tpu_torch.ops.launch import stats  # noqa: F401

SW_RESULT_ORDER = ("score", "qle", "tle", "gtle", "gscore", "max_off")


def _declare(lib) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.banded_sw_pairs_launch.argtypes = [
        P, P, I, I, I, P, P, P, P, P, I, I, I, I, I, I, P, P]
    lib.banded_sw_pairs_launch.restype = I
    lib.banded_sw_coord_launch.argtypes = [
        P, LL, P, I, I, P, I, P, I, I, I, P, I, I, I, I, I, I, P, P]
    lib.banded_sw_coord_launch.restype = I


def _entry(fn_name: str):
    return entry("banded_sw", fn_name, _declare)


def _cuda_device(x) -> torch.device:
    return cuda_device(x, "the CUDA banded-SW kernels")


def banded_sw_pairs(q, t, qlen, tlen, h0, ws, mat, o_del: int, e_del: int,
                    o_ins: int, e_ins: int, end_bonus: int, zdrop: int):
    """Kernel form of banded_sw.banded_sw_extend_batch: q (B,Q) and t (B,T)
    int32 codes, per-pair int32 (B,) lengths, h0 and band widths, mat (5,5)
    int32. Returns {score, qle, tle, gtle, gscore, max_off} of (B,) int32.
    A pair with qlen outside [0, Q] is outside the contract."""
    dev = _cuda_device(q)
    _check(q, "q", torch.int32, (None, None), dev)
    B, Q = q.shape
    _check(t, "t", torch.int32, (B, None), dev)
    T = t.shape[1]
    for name, x in (("qlen", qlen), ("tlen", tlen), ("h0", h0), ("ws", ws)):
        _check(x, name, torch.int32, (B,), dev)
    _check(mat, "mat", torch.int32, (5, 5), dev)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    if B:
        _launch("banded_sw_pairs", _entry("banded_sw_pairs_launch"), dev,
                q.data_ptr(), t.data_ptr(), B, Q, T, qlen.data_ptr(),
                tlen.data_ptr(), h0.data_ptr(), ws.data_ptr(),
                mat.data_ptr(), o_del, e_del, o_ins, e_ins, end_bonus,
                zdrop, out.data_ptr())
    return dict(zip(SW_RESULT_ORDER, out.unbind(0)))


def banded_sw_coord(text32, codes, jobs, score_reg, mat, o_del: int,
                    e_del: int, o_ins: int, e_ins: int, end_bonus: int,
                    zdrop: int, reverse: bool, write_scores: bool):
    """Kernel form of banded_sw.extend_side_round: text32 int32 view of the
    packed text words, codes (R,L) uint8 read codes, jobs (7,N) int32 rows
    reg,row,qstart,qlen,tstart,tlen,ws, score_reg (Gp,) int32 per-alnreg h0
    (updated in place with write_scores). Returns (8,N) int32: score, qle,
    tle, gtle, gscore, max_off, ws, h0. A job with qlen outside [0, L] is
    outside the contract; each alnreg may have at most one job per launch."""
    dev = _cuda_device(jobs)
    _check(text32, "text32", torch.int32, (None,), dev)
    _check(codes, "codes", torch.uint8, (None, None), dev)
    _check(jobs, "jobs", torch.int32, (7, None), dev)
    _check(score_reg, "score_reg", torch.int32, (None,), dev)
    _check(mat, "mat", torch.int32, (5, 5), dev)
    R, L = codes.shape
    N = jobs.shape[1]
    Gp = score_reg.shape[0]
    if R == 0 or Gp == 0 or text32.numel() == 0:
        raise ValueError("codes, score_reg and text32 must be non-empty")
    out = torch.empty((8, N), dtype=torch.int32, device=dev)
    if N:
        _launch("banded_sw_coord", _entry("banded_sw_coord_launch"), dev,
                text32.data_ptr(), text32.numel(), codes.data_ptr(), R, L,
                jobs.data_ptr(), N, score_reg.data_ptr(), Gp,
                int(write_scores), int(reverse), mat.data_ptr(), o_del,
                e_del, o_ins, e_ins, end_bonus, zdrop, out.data_ptr())
    return out
