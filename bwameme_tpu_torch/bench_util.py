"""What the port's on-card scripts share (chip_smoke.py at the root of the
repository, kernel_bench.py beside this file): timers of a call on a CUDA
device and the banded-SW workloads at the main path's shapes. Imports
nothing of the package before a function runs, so kernel_bench.py can time
the package of another checkout with these timers.
"""

from __future__ import annotations

import statistics
import time


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n: int = 1000) -> float:
    """Host time of one fn() call: n calls between two drains of the
    stream, the clock stopped before the second (fn only enqueues)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def queued_us(fn, n: int = 400) -> float:
    """Device time of one fn() call with the host out of the way: n calls
    queued behind a kernel that spins for some tens of ms, timed by CUDA
    events on the stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def random_pairs(rng, B: int, Q: int, T: int, w: int):
    """Extension pairs at the main path's shapes: queries up to Q, targets
    a noisy copy of the query plus the gap allowance (up to 2w), a quarter
    of them uniform up to T; h0 a seed score; band w or 2w."""
    import numpy as np

    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    q[rng.random((B, Q)) < 0.01] = 4
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    t[:, :Q] = np.where(rng.random((B, Q)) < 0.03,
                        rng.integers(0, 4, (B, Q)), q)
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 2 * w + 1, B), T).astype(np.int32)
    wide = rng.random(B) < 0.25
    tlen[wide] = rng.integers(0, T + 1, int(wide.sum()))
    h0 = rng.integers(19, 152, B).astype(np.int32)
    ws = rng.choice([w, 2 * w], B).astype(np.int32)
    return q, t, qlen, tlen, h0, ws


def coord_workload(opt, rng, n_reads: int, n_regs: int, read_len: int):
    """A 4 Mbp random text, reads copied from it with substitutions and N
    codes, and one left and one right job per alnreg, shaped as the flat
    path makes them (target window = query part + cal_max_gap)."""
    import numpy as np

    from bwameme_tpu_torch.align.chain import cal_max_gap
    from bwameme_tpu_torch.index.packing import pack_words

    n = 4_000_000
    text = rng.integers(0, 4, n).astype(np.uint8)
    text32 = np.concatenate([pack_words(text, pad_code=3),
                             np.full(12, 0xFFFFFFFF, np.uint32)])
    src = rng.integers(400, n - read_len - 400, n_reads)
    codes = text[src[:, None] + np.arange(read_len)]
    codes = np.where(rng.random(codes.shape) < 0.01,
                     rng.integers(0, 4, codes.shape), codes).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4
    row = rng.integers(0, n_reads, n_regs)
    qbeg = rng.integers(0, read_len - 19, n_regs)
    slen = np.minimum(rng.integers(19, read_len + 1, n_regs), read_len - qbeg)
    qe = qbeg + slen
    rbeg = src[row] + qbeg
    lgap = np.array([cal_max_gap(opt, int(x)) for x in qbeg])
    rgap = np.array([cal_max_gap(opt, int(read_len - x)) for x in qe])
    left = np.zeros((7, n_regs), np.int64)
    left[0] = np.arange(n_regs)
    left[1] = row
    left[3] = qbeg
    left[5] = qbeg + lgap
    left[4] = rbeg - left[5]
    left[6] = opt.w
    right = np.zeros((7, n_regs), np.int64)
    right[0] = np.arange(n_regs)
    right[1] = row
    right[2] = qe
    right[3] = read_len - qe
    right[4] = rbeg + slen
    right[5] = read_len - qe + rgap
    right[6] = opt.w
    h0 = (slen * opt.a).astype(np.int32)
    return (text32.view(np.int32), codes, left.astype(np.int32),
            right.astype(np.int32), h0)


def run_coord_round(fn, opt, text32, codes, left, right, h0, mat, **kw):
    """Left launch (writes its scores), then right launch reading them."""
    score_reg = h0.clone()
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    lres = fn(text32, codes, left, score_reg, mat, *gaps, opt.pen_clip5,
              opt.zdrop, True, True, **kw)
    rres = fn(text32, codes, right, score_reg, mat, *gaps, opt.pen_clip3,
              opt.zdrop, False, False, **kw)
    return lres, rres, score_reg
