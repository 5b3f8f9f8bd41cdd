"""ctypes wrappers of the Hopper banded-SW kernels (csrc/banded_sw.cu).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates outputs and scratch with ``torch.empty``, launches on
the current CUDA stream without synchronising, and raises if the launch was
refused. ``stats.launches`` counts launches per kernel, so a run can show
that its main path went through the kernels; with ``stats.events`` set to a
list, each launch also appends a (start, end) pair of CUDA events.

The plain PyTorch versions live in ops/banded_sw.py, which dispatches to
these wrappers for CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from bwameme_tpu_torch.ops import build

SW_RESULT_ORDER = ("score", "qle", "tle", "gtle", "gscore", "max_off")


@dataclasses.dataclass
class KernelStats:
    launches: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"banded_sw_pairs": 0, "banded_sw_coord": 0})
    events: list | None = None

    def reset(self) -> None:
        for k in self.launches:
            self.launches[k] = 0
        if self.events is not None:
            self.events.clear()

    def device_ms(self) -> float:
        """Summed device time of the recorded launches (synchronises)."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events or ())


stats = KernelStats()
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build.build().path)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.banded_sw_pairs_launch.argtypes = [
            P, P, I, I, I, P, P, P, P, P, I, I, I, I, I, I, P, P, P, P]
        lib.banded_sw_pairs_launch.restype = I
        lib.banded_sw_coord_launch.argtypes = [
            P, LL, P, I, I, P, I, P, I, I, I, P, I, I, I, I, I, I, P, P, P, P]
        lib.banded_sw_coord_launch.restype = I
        _lib = lib
    return _lib


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if len(shape) != x.dim() or any(
            s is not None and s != d for s, d in zip(shape, x.shape)):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(name: str, fn, *args) -> None:
    ev = None
    if stats.events is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    if ev is not None:
        ev[1].record()
        stats.events.append(ev)
    stats.launches[name] += 1


def _cuda_device(x: torch.Tensor) -> torch.device:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("the CUDA banded-SW kernels take CUDA tensors only")
    return x.device


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
        eh_h = torch.empty(((Q + 1) * B,), dtype=torch.int32, device=dev)
        eh_e = torch.empty_like(eh_h)
        with torch.cuda.device(dev):
            _launch("banded_sw_pairs", _load().banded_sw_pairs_launch,
                    q.data_ptr(), t.data_ptr(), B, Q, T, qlen.data_ptr(),
                    tlen.data_ptr(), h0.data_ptr(), ws.data_ptr(),
                    mat.data_ptr(), o_del, e_del, o_ins, e_ins, end_bonus,
                    zdrop, out.data_ptr(), eh_h.data_ptr(), eh_e.data_ptr())
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
        eh_h = torch.empty(((L + 1) * N,), dtype=torch.int32, device=dev)
        eh_e = torch.empty_like(eh_h)
        with torch.cuda.device(dev):
            _launch("banded_sw_coord", _load().banded_sw_coord_launch,
                    text32.data_ptr(), text32.numel(), codes.data_ptr(), R, L,
                    jobs.data_ptr(), N, score_reg.data_ptr(), Gp,
                    int(write_scores), int(reverse), mat.data_ptr(), o_del,
                    e_del, o_ins, e_ins, end_bonus, zdrop, out.data_ptr(),
                    eh_h.data_ptr(), eh_e.data_ptr())
    return out
