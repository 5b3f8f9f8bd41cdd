"""What every ctypes kernel wrapper of the port shares: the loaded
libraries, argument checks, the launch itself and the launch counts.

A wrapper checks device, dtype, shape and contiguity and raises on anything
else, allocates outputs with ``torch.empty``, launches on the current CUDA
stream of its tensors' device without synchronising, and raises if the
launch was refused. What a launch costs on the host is kept short: the C
function is bound once (``entry``), the stream is read as a raw handle, and
the device guard is entered only when another device is current.
``stats.launches`` counts launches per kernel, and only launches, so a run
can show that its main path went through the kernels; a seeding kernel
counts each variant (the index's layout) under its own name (``variant``).
With ``stats.events`` set to a list, each launch also appends a (name,
start, end) triple of CUDA events.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from bwameme_tpu_torch.ops import build

SEEDING = ("prmi_window", "sa_query", "seed_round1", "seed_round2",
           "seed_round3")


def variant(name: str, mode: int, wide: bool) -> str:
    """The launch-count name of a seeding kernel's variant for an index of
    ``mode`` (1-4) and width: the kernel's own name for mode 4 narrow,
    ``name[m<mode>]`` or ``name[m<mode>,wide]`` for the others;
    prmi_window, the same code in every mode, ``prmi_window[wide]``."""
    if name == "prmi_window":
        return name + ("[wide]" if wide else "")
    if mode == 4 and not wide:
        return name
    return f"{name}[m{mode}{',wide' if wide else ''}]"


def variants(name: str) -> list[str]:
    """Every variant's name of a seeding kernel, mode 4 narrow first."""
    return list(dict.fromkeys(variant(name, m, w) for w in (False, True)
                              for m in (4, 1, 2, 3)))


KERNELS = ("banded_sw_pairs", "banded_sw_coord", "gather_flat",
           "gather_window", "gather_chain", *(v for k in SEEDING
                                              for v in variants(k)),
           "sw_full")


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
_entries: dict = {}


def library(name: str, declare) -> ctypes.CDLL:
    """The shared library ``name`` (ops/build.py LIBRARIES), loaded once;
    ``declare(lib)`` sets the argument types of its entry points."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(build.build().paths[name])
        declare(lib)
    return lib


def entry(lib_name: str, fn_name: str, declare):
    """The C launcher ``fn_name`` of a library, bound once: a launch pays
    one dictionary lookup for it."""
    fn = _entries.get((lib_name, fn_name))
    if fn is None:
        fn = _entries[lib_name, fn_name] = getattr(
            library(lib_name, declare), fn_name)
    return fn


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


def raw_stream(index) -> int:
    """The current stream of CUDA device ``index`` as the integer a C
    launcher takes. torch._C._cuda_getCurrentRawStream is private to
    PyTorch (its own extensions' launch path): it saves building a Stream
    object, which is what a PyTorch without it gets."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def launch(name: str, fn, dev: torch.device, *args) -> None:
    """Call a C launcher (its last argument is the stream) on ``dev``'s
    current stream and count it. The device guard is entered only when
    ``dev`` is not the current device."""
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return launch(name, fn, dev, *args)
    events = stats.events
    if events is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    err = fn(*args, raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    if events is not None:
        end.record()
        events.append((name, start, end))
    stats.launches[name] += 1
