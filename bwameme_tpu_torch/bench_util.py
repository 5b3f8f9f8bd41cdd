"""What the port's on-card scripts share (chip_smoke.py at the root of the
repository, kernel_bench.py beside this file): timers of a call on a CUDA
device, the banded-SW workloads at the main path's shapes, and the seeding
workload: the bench genome's index, simulated reads, and a batch of them
with the three rounds over it. Imports
nothing of the package before a function runs, so kernel_bench.py can time
the package of another checkout with these timers.
"""

from __future__ import annotations

import os
import statistics
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


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


def get_index(mbp: float) -> str:
    """The bench genome (bench.py:get_index: seed 2024, 200 planted
    repeats), built once and cached under .bench_cache/. The index is
    written into a directory of its own and moved into place file by file,
    its .meme directory last: a build killed half way leaves no .meme
    directory, which is what marks an index as cached."""
    import shutil
    import tempfile

    import numpy as np

    from bwameme_tpu_torch.index import bntseq
    from bwameme_tpu_torch.index.build import build_index, save_index

    prefix = os.path.join(CACHE, f"bench_{mbp:g}mbp")
    if os.path.isdir(prefix + ".meme"):
        print(f"index: cached {os.path.relpath(prefix, ROOT)}", flush=True)
        return prefix
    os.makedirs(CACHE, exist_ok=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    n = int(mbp * 1e6)
    code = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(200):
        src = int(rng.integers(0, n - 5000))
        dst = int(rng.integers(0, n - 5000))
        ln = int(rng.integers(300, 3000))
        code[dst: dst + ln] = code[src: src + ln]
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("chrB", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns)
    tmp = tempfile.mkdtemp(prefix=".building.", dir=CACHE)
    try:
        name = os.path.basename(prefix)
        save_index(idx, os.path.join(tmp, name))
        for f in sorted(os.listdir(tmp), key=lambda f: f.endswith(".meme")):
            os.replace(os.path.join(tmp, f), os.path.join(CACHE, f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"index: built {mbp:g} Mbp in {time.perf_counter() - t0:.1f} s "
          f"(n_sa={idx.n_sa}, rmi_bits={idx.rmi_bits})", flush=True)
    return prefix


def simulated_reads(text, l_pac: int, n: int, read_len: int, rng,
                    repeats=()):
    """Reads as users send them: Poisson(1) substitutions, every other one
    reverse-complemented, one in eight with an N, one in sixteen from a
    planted repeat where ``repeats`` lists any. Returns the code arrays."""
    import numpy as np

    reads = []
    for i in range(n):
        if repeats and i % 16 == 7:
            lo, ln = repeats[int(rng.integers(0, len(repeats)))]
            st = int(lo + rng.integers(0, max(ln - read_len, 1)))
            st = min(st, l_pac - read_len - 1)
        else:
            st = int(rng.integers(0, l_pac - read_len - 1))
        c = np.array(text[st: st + read_len])
        for _ in range(rng.poisson(1.0)):
            p = int(rng.integers(0, read_len))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 8 == 3:
            c[int(rng.integers(0, read_len))] = 4
        if i % 2:
            c = np.where(c < 4, 3 - c, c)[::-1].astype(np.uint8)
        reads.append(c)
    return reads


def planted_repeats(mbp: float):
    """(destination, length) of the bench genome's planted repeats: the
    generator of get_index, replayed."""
    import numpy as np

    rng = np.random.default_rng(2024)
    n = int(mbp * 1e6)
    rng.integers(0, 4, n)
    out = []
    for _ in range(200):
        int(rng.integers(0, n - 5000))
        dst = int(rng.integers(0, n - 5000))
        out.append((dst, int(rng.integers(300, 3000))))
    return out


class Rounds:
    """One batch of reads, prepared on the card as the engine prepares it,
    and the three rounds over it through either implementation."""

    def __init__(self, eng, reads, dev):
        import numpy as np
        import torch

        from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda

        self.eng, self.R = eng, len(reads)
        mat, lens_np, _ = eng._batch_matrix(reads)
        self.lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
        self.prep = seed_smem.prepare_reads(torch.from_numpy(mat).to(dev),
                                            self.lens)
        self.kernels = (seed_smem_cuda.seed_round1,
                        seed_smem_cuda.seed_round2,
                        seed_smem_cuda.seed_round3)
        self.plain = (seed_smem.seed_round1_torch,
                      seed_smem.seed_round2_torch,
                      seed_smem.seed_round3_torch)
        # round 1's slots and counts, which round 2 reads
        self.slots1 = self.run(0, self.kernels[0])[:2]

    def run(self, k: int, fn, **kw):
        eng, opt, di = self.eng, self.eng.opt, self.eng.di
        qbuf, nf, nr, nvf = self.prep
        if k == 0:
            return fn(di, qbuf, nf, nr, nvf, self.lens, opt.min_seed_len,
                      eng.max_smems, **kw)
        if k == 1:
            return fn(di, qbuf, nf, nr, self.lens, *self.slots1,
                      opt.split_len, opt.split_width, opt.min_seed_len,
                      eng.max_reseeds, **kw)
        return fn(di, qbuf, nf, self.lens, opt.max_mem_intv,
                  opt.min_seed_len + 1, eng.max_smems, **kw)


# ------------------------------------------------- the analytic wide index
# A port-owned copy of the JAX package's periodic index (its tests,
# test_wide.py: periodic_index, expected_hit): a text whose suffix array and
# whose answers have closed forms, so that an index of more than 2^31
# suffixes is searched and checked without a suffix sort. Built on the
# device: the host never holds its suffix array.


def periodic_block(p: int, m: int, seed: int = 0):
    """A block of p bases in {A, C, G} whose p rotations differ within m
    bases, drawn as the JAX generator draws it: (block, wins, rot_order),
    wins[k] the m-base window of rotation k, rot_order[k] the rotation of
    the k-th smallest window."""
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        block = rng.integers(0, 3, p).astype(np.uint8)
        wins = np.stack([np.roll(block, -i)[:m] for i in range(p)])
        if len(np.unique(wins, axis=0)) == p:
            break
    return block, wins, np.lexsort(wins.T[::-1])


def _short_key(block, j: int, m: int) -> tuple:
    """The first 2m bases of the suffix of j < m bases, T past the text."""
    import numpy as np

    key = np.full(2 * m, 3, np.uint8)
    key[:j] = block[len(block) - j:]
    return tuple(key)


def periodic_ranks(n: int, p: int, m: int, block, wins, rot_order):
    """The closed form of the suffix array of block tiled n / p times: the
    suffixes of m bases or more sort by (rotation, position), a rotation's
    block of long_cnt[k] suffixes starting at rank starts[k]; the m - 1
    short ones (j < m bases before the text's end) sit between rotation
    blocks, after every rotation whose first j bases are at most theirs
    (on a tie the T after the short suffix is larger), in the order of
    their keys among each other. Returns (long_cnt, starts, short_pos,
    short_rank), all int64."""
    import numpy as np

    assert n % p == 0 and p % 16 == 0
    long_cnt = (n - m - rot_order.astype(np.int64)) // p + 1
    ordered = wins[rot_order]
    shorts = np.arange(1, m, dtype=np.int64)          # bases before the end
    keys = [_short_key(block, int(j), m) for j in shorts]
    # rotations at or below each short suffix on its j bases
    below = np.array([
        int(sum(tuple(w[:j]) <= key[:j] for w in ordered))
        for j, key in zip(shorts, keys)], np.int64)
    order = sorted(range(len(keys)), key=keys.__getitem__)
    among = np.empty(len(keys), np.int64)
    among[order] = np.arange(len(keys))
    cum = np.concatenate([[0], np.cumsum(long_cnt)])
    short_rank = cum[below] + among
    starts = cum[:-1] + np.searchsorted(np.sort(below), np.arange(p),
                                        side="right")
    return long_cnt, starts, n - shorts, short_rank


def periodic_index(n: int, p: int, m: int, seed: int = 0, device="cpu"):
    """The periodic index's device planes in mode 1, wide
    (index/device.DeviceIndex), built on ``device`` a rotation block at a
    time, and (block, rot_order) for expected_hit. The P-RMI is the JAX
    generator's stub: 4 leaves by first base, a flat model whose window is
    the widest leaf."""
    import numpy as np
    import torch

    from bwameme_tpu_torch.index.device import DeviceIndex, fuse_rmi_params
    from bwameme_tpu_torch.index.packing import pack_words

    block, wins, rot_order = periodic_block(p, m, seed)
    long_cnt, starts, short_pos, short_rank = periodic_ranks(
        n, p, m, block, wins, rot_order)
    dev = torch.device(device)
    sa = torch.empty(n, dtype=torch.int64, device=dev)
    for k in range(p):
        phase, cnt = int(rot_order[k]), int(long_cnt[k])
        sa[int(starts[k]): int(starts[k]) + cnt] = torch.arange(
            phase, phase + p * cnt, p, dtype=torch.int64, device=dev)
    sa[torch.from_numpy(short_rank).to(dev)] = torch.from_numpy(
        short_pos).to(dev)
    words = torch.from_numpy(pack_words(block).view(np.int32)).to(dev)
    text32 = torch.cat([words.repeat(n // p),
                        torch.full((4,), -1, dtype=torch.int32, device=dev)])
    counts = np.bincount(block, minlength=4).astype(np.int64) * (n // p)
    stub = _PrmiStub(counts)
    params = torch.from_numpy(fuse_rmi_params(stub).view(np.int32)).to(dev)
    di = DeviceIndex.from_tensors(
        text32=text32, params=params, bits=2, n_sa=n, sa=sa,
        params64=torch.from_numpy(stub.rmi_leaf_start).to(dev))
    return di, block, rot_order


class _PrmiStub:
    """The JAX generator's 4-leaf P-RMI: leaf = first base, alpha = beta =
    0, and an error window as wide as the widest leaf."""

    def __init__(self, counts) -> None:
        import numpy as np

        self.rmi_leaf_start = np.concatenate([[0], np.cumsum(counts)])
        width = int(counts.max())
        self.rmi_alpha = np.zeros(4, np.float32)
        self.rmi_beta = np.zeros(4, np.float32)
        self.rmi_err_lo = np.full(4, width, np.int64)
        self.rmi_err_hi = np.full(4, width + 1, np.int64)


def expected_hit(block, rot_order, n: int, p: int, m: int, k: int, L: int):
    """Closed-form (mlen, lb, cnt) of sa_query at min_intv 1 for the pattern
    of the k-th rotation's first L bases (m <= L <= p)."""
    import numpy as np

    phase = int(rot_order[k])
    pat = np.tile(block, 2)[phase: phase + L]
    cnt = (n - L - phase) // p + 1
    long_cnt = (n - m - rot_order.astype(np.int64)) // p + 1
    before = 0          # short suffixes sorting strictly before the pattern
    for j in range(1, m):
        t = block[p - j:]
        jj = min(j, L)
        d = np.flatnonzero(t[:jj] != pat[:jj])
        if len(d) and t[d[0]] < pat[d[0]]:
            before += 1
    return L, int(long_cnt[:k].sum()) + before, cnt


def periodic_reads(block, n_reads: int, read_len: int, rng):
    """Reads cut from the periodic text at random phases, one in two with a
    T (a base the text never has) put in: the T splits the read's SMEMs."""
    import numpy as np

    p = len(block)
    text = np.tile(block, -(-read_len // p) + 1)
    reads = []
    for i in range(n_reads):
        c = text[int(rng.integers(0, p)):][:read_len].copy()
        if i % 2:
            c[int(rng.integers(0, read_len))] = 3
        reads.append(c)
    return reads
