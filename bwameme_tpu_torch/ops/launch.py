"""What every ctypes kernel wrapper of the port shares: the loaded
libraries, argument checks, the launch itself and the launch counts.

A wrapper checks device, dtype, shape and contiguity and raises on anything
else, allocates outputs and scratch with ``torch.empty``, launches on the
current CUDA stream without synchronising, and raises if the launch was
refused. ``stats.launches`` counts launches per kernel, and only launches,
so a run can show that its main path went through the kernels; with
``stats.events`` set to a list, each launch also appends a
(name, start, end) triple of CUDA events.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from bwameme_tpu_torch.ops import build

KERNELS = ("banded_sw_pairs", "banded_sw_coord", "gather_flat",
           "gather_window", "gather_chain", "prmi_window", "sa_query",
           "seed_round1", "seed_round2", "seed_round3")


@dataclasses.dataclass
class KernelStats:
    launches: dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0))
    events: list | None = None

    def reset(self) -> None:
        for k in self.launches:
            self.launches[k] = 0
        if self.events is not None:
            self.events.clear()

    def device_ms(self) -> dict[str, float]:
        """Summed device time of the recorded launches, per kernel
        (synchronises)."""
        torch.cuda.synchronize()
        out: dict[str, float] = {}
        for name, s, e in self.events or ():
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


stats = KernelStats()
_libs: dict = {}


def library(name: str, declare) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu, loaded once;
    ``declare(lib)`` sets the argument types of its entry points."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build.build().paths[name])
        declare(lib)
        _libs[name] = lib
    return lib


def check(x, name: str, dtype: torch.dtype, shape: tuple,
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


def cuda_device(x, what: str) -> torch.device:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what} take CUDA tensors only")
    return x.device


def launch(name: str, fn, *args) -> None:
    """Call a C launcher (its last argument is the stream) and count it."""
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
        stats.events.append((name, *ev))
    stats.launches[name] += 1
