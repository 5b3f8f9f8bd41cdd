"""Row-gather microbenchmarks: the seeding probe's access patterns.

Port of the three Pallas DMA kernels of tools/microbench_pallas_gather.py
(``dma_flat``, ``dma_window``, ``dma_chain``) as CUDA kernels
(csrc/gather_bench.cu) with their plain PyTorch versions beside them. Each
public function takes tensors on one device: CUDA tensors go to the kernel,
CPU tensors to the plain version, any other device raises; there is no
fallback from a kernel to its plain version.

``src`` is (N, width) uint32 words held as int32 storage, ``idx`` (L,) int32
row numbers. The width is a runtime argument: 128 words are the TPU tool's
512-byte rows, 4 words the 16-byte rank rows of the seeding kernel.
"""

from __future__ import annotations

import ctypes

import torch

from bwameme_tpu_torch.ops.launch import check, entry, launch


def _declare(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gather_rows_launch.argtypes = [P, P, P, I, I, I, P]
    lib.gather_rows_launch.restype = I
    lib.gather_chain_launch.argtypes = [P, P, P, I, I, I, I, P]
    lib.gather_chain_launch.restype = I


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"the gathers run on CUDA or the CPU, not {x.device}")
    return False


def _check_args(src, idx, device=None) -> None:
    check(src, "src", torch.int32, (None, None), src.device)
    check(idx, "idx", torch.int32, (None,), device or src.device)
    if src.shape[0] == 0 or src.numel() >= 2**40:
        raise ValueError("src must have rows, and fewer than 2^40 words")


# ----------------------------------------------------------- plain versions


def gather_flat_torch(src, idx):
    return src[idx.long()]


def gather_window_torch(src, idx, rows: int):
    return src[idx.long()[:, None] + torch.arange(rows, device=src.device)]


def gather_chain_torch(src, idx, rounds: int):
    """The walk of tools/microbench_pallas_gather.py:276-283 in int32 wrap
    arithmetic, emulated in int64: x <- (src[x, 0] ^ (x << 1)) mod N, made
    non-negative."""
    n = src.shape[0]
    col0 = src[:, 0].long()
    x = idx.long()
    for _ in range(rounds):
        y = ((x << 1) + 2**31) % 2**32 - 2**31      # int32 wrap of x << 1
        x = torch.remainder(col0[x] ^ y, n)         # floored: non-negative
    return x.to(torch.int32)


# ------------------------------------------------------------ CUDA wrappers


def _gather_rows_cuda(name: str, src, idx, rows: int, flat: bool = False):
    """(L, rows, width), or (L, width) for the flat gather (rows == 1)."""
    _check_args(src, idx)
    L, width = idx.shape[0], src.shape[1]
    out = src.new_empty((L, width) if flat else (L, rows, width))
    if L:
        launch(name, entry("gather_bench", "gather_rows_launch", _declare),
               src.device, src.data_ptr(), idx.data_ptr(), out.data_ptr(), L,
               rows, width)
    return out


def gather_chain_cuda(src, idx, rounds: int, device=None):
    """K4 launched on ``device`` (by default src's card), where idx lies and
    the result is made; a src on another card is read through a peer
    pointer (the caller enables peer access)."""
    device = device or src.device
    _check_args(src, idx, device)
    L = idx.shape[0]
    out = torch.empty((L,), dtype=torch.int32, device=device)
    if L:
        launch("gather_chain",
               entry("gather_bench", "gather_chain_launch", _declare),
               device, src.data_ptr(), idx.data_ptr(), out.data_ptr(), L,
               src.shape[0], src.shape[1], rounds)
    return out


# ----------------------------------------------------------------- dispatch


def gather_flat(src, idx):
    """K2: out[i] = src[idx[i]], (L, width). Rows in [0, N)."""
    if _on_cuda(src):
        return _gather_rows_cuda("gather_flat", src, idx, 1, flat=True)
    return gather_flat_torch(src, idx)


def gather_window(src, idx, rows: int):
    """K3: out[i] = src[idx[i] : idx[i] + rows], (L, rows, width); every
    window must lie inside src."""
    if _on_cuda(src):
        return _gather_rows_cuda("gather_window", src, idx, rows)
    return gather_window_torch(src, idx, rows)


def gather_chain(src, idx, rounds: int):
    """K4: ``rounds`` dependent rounds of the walk a lane, (L,) int32."""
    fn = gather_chain_cuda if _on_cuda(src) else gather_chain_torch
    return fn(src, idx, rounds)


# ------------------------------------------------------------ the benchmark


def make_table(n_rows: int, width: int, device, seed: int = 0):
    """A random (n_rows, width) table made on the device from a seed (values
    below 2^30, as the TPU tool's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1 << 30, (n_rows, width), dtype=torch.int32,
                         device=device, generator=gen)


def make_lanes(n_rows: int, lanes: int, device, seed: int = 0):
    """``lanes`` random row numbers, made on the device from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, n_rows, (lanes,), dtype=torch.int32,
                         device=device, generator=gen)


def microbench(src, idx, window: int = 16, rounds: int = 15, reps: int = 20):
    """The port of tools/microbench_pallas_gather.py:main for one table: the
    three gathers through their public functions (the kernels on a CUDA
    device), ``reps`` times each after a warm-up, timed with CUDA events.
    Returns ms per call and what it means per row and per dependent round.
    A call's time includes its launch, which dominates the small cases, so
    the time of one dependent round is taken from the difference between a
    long chain (64 times the rounds) and the short one. Needs a CUDA
    device."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError("the gather microbenchmark times a CUDA device")
    L, width = idx.shape[0], src.shape[1]
    idxw = idx.clamp(max=src.shape[0] - window)

    def timed(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    flat_ms = timed(lambda: gather_flat(src, idx))
    window_ms = timed(lambda: gather_window(src, idxw, window))
    chain_ms = timed(lambda: gather_chain(src, idx, rounds))
    long_rounds = 64 * rounds
    long_ms = timed(lambda: gather_chain(src, idx, long_rounds))
    row_bytes = 4 * width
    return {
        "rows": src.shape[0], "width_words": width, "lanes": L,
        "window_rows": window, "rounds": rounds,
        "flat_ms": flat_ms, "flat_ns_per_row": flat_ms * 1e6 / L,
        "flat_gbs": 2 * L * row_bytes / (flat_ms * 1e6),
        "window_ms": window_ms,
        "window_ns_per_row": window_ms * 1e6 / (L * window),
        "window_gbs": 2 * L * window * row_bytes / (window_ms * 1e6),
        "chain_ms": chain_ms,
        "chain_long_ms": long_ms,
        "chain_us_per_round": (long_ms - chain_ms) * 1e3
        / (long_rounds - rounds),
    }
