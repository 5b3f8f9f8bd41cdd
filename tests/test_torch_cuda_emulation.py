"""The port's CUDA sources, run on the CPU.

There is no nvcc and no card here, so g++ compiles csrc/*.cu as C++ behind a
stand-in for <cuda_runtime.h> (SHIM_HEADER below). The threads of the gather
kernels do not cooperate (one thread a unit), so every thread of a launch
runs in turn. The banded-SW and full-SW kernels are a warp a job and the seeding
kernels a warp a read: their build (EMU_FIBERS) runs the threads of a block as fibers
that advance in lock step, every warp primitive (__shfl_*_sync,
__ballot_sync, __reduce_*_sync, __syncwarp) and __syncthreads being a point
where a fiber waits for the others of its warp or block and then reads what
they brought.
The real ctypes wrappers then launch these builds on CPU tensors, and each
kernel is held against its plain PyTorch version, all values equal. This
checks the kernels' arithmetic, control flow and lane cooperation, the
wrappers' argument lists and the counts of sectors and steps; what only the
card can show
(that nvcc accepts the source, the float intrinsics' rounding, races between
lanes that a lock-step run cannot have, timing) is chip_smoke.py's."""

import dataclasses
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwameme_tpu.ops import banded_sw as jbsw
from bwameme_tpu_torch.align.sw_scalar import sw_extend
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.index.packing import pack_words
from bwameme_tpu_torch.ops import banded_sw as bsw
from bwameme_tpu_torch.ops import banded_sw_cuda, build, gather_bench, launch
from bwameme_tpu_torch.ops import fmi_search, fmi_search_cuda
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda
from bwameme_tpu_torch.ops import sw_full, sw_full_cuda
from bwameme_tpu_torch.index.fmindex import build_fm_index
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.fmi_engine import FmiDeviceEngine, FmiHostEngine
from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine, Smem
from bwameme_tpu_torch.utils.config import MemOptions

SHIM_HEADER = r"""// A stand-in for <cuda_runtime.h> that lets g++ compile the port's CUDA
// sources as C++ that runs on the host. Without EMU_FIBERS every thread of a
// launch runs in turn (kernels whose threads do not cooperate). With it the
// threads of a block are fibers run round-robin: a warp primitive or
// __syncthreads parks a fiber until every live fiber of its warp or block
// has reached the same point. The <<<grid, block, shared, stream>>> launches
// are rewritten into EMU_LAUNCH calls before the compile.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
using std::max;
using std::min;
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct int4 { int x, y, z, w; };
struct EmuDim { unsigned x; };
static EmuDim blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> static inline int cudaFuncSetAttribute(K, int, int) {
    return 0;
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __clz(int x) {
    return x == 0 ? 32 : __builtin_clz((unsigned)x);
}
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
// separately rounded float steps (the file is built with -ffp-contract=off)
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
static inline float __uint2float_rn(uint32_t x) { return (float)x; }
static inline float __int2float_rn(int x) { return (float)x; }
static inline int __float2int_rz(float x) { return (int)x; }
static inline long long __float2ll_rz(float x) { return (long long)x; }
static inline float __ll2float_rn(long long x) { return (float)x; }
static inline float __uint_as_float(uint32_t x) {
    float f;
    memcpy(&f, &x, 4);
    return f;
}
static inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
static inline int __viaddmax_s32_relu(int a, int b, int c) {
    return max(max(a + b, c), 0);
}
static inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
static inline int cudaGetLastError() { return 0; }
// a launch here has run to its end when it returns, so stream order holds
static inline int cudaMallocAsync(void** p, size_t n, cudaStream_t) {
    *p = malloc(n);
    return *p == nullptr;
}
static inline int cudaFreeAsync(void* p, cudaStream_t) {
    free(p);
    return 0;
}

#ifndef EMU_FIBERS
#define EMU_LAUNCH(kern, grid, block, ...)                               \
    do {                                                                 \
        blockDim.x = (block);                                            \
        for (unsigned b_ = 0; b_ < (unsigned)(grid); ++b_)               \
            for (unsigned t_ = 0; t_ < (unsigned)(block); ++t_) {        \
                blockIdx.x = b_;                                         \
                threadIdx.x = t_;                                        \
                kern(__VA_ARGS__);                                       \
            }                                                            \
    } while (0)
#else
#include <functional>
#include <ucontext.h>
#include <vector>
#define __shared__ static

// a warp's or a block's meeting point: the values its fibers brought
struct EmuGroup {
    int alive, arrived, gen;
    int in[32], out[32];
};
struct EmuFiber {
    ucontext_t ctx;
    std::vector<char> stack;
    bool done;
};
static ucontext_t emu_main;
static std::vector<EmuFiber> emu_fibers;
static std::vector<EmuGroup> emu_warps;
static EmuGroup emu_block;
static const std::function<void()>* emu_body;

static inline void emu_release(EmuGroup& g) {
    if (g.alive > 0 && g.arrived == g.alive) {
        g.arrived = 0;
        memcpy(g.out, g.in, sizeof g.out);
        ++g.gen;
    }
}
// bring v to the group's meeting point and wait there for the others
static inline const int* emu_meet(EmuGroup& g, int slot, int v) {
    const unsigned me = threadIdx.x;
    g.in[slot] = v;
    const int gen = g.gen;
    ++g.arrived;
    emu_release(g);
    while (g.gen == gen) {
        swapcontext(&emu_fibers[me].ctx, &emu_main);
        threadIdx.x = me;
    }
    return g.out;
}
static inline EmuGroup& emu_warp() { return emu_warps[threadIdx.x / 32]; }
static inline int emu_lane() { return threadIdx.x % 32; }
static inline void __syncthreads() { emu_meet(emu_block, 0, 0); }
static inline void __syncwarp(unsigned = 0xffffffffu) {
    emu_meet(emu_warp(), emu_lane(), 0);
}
static inline int __shfl_sync(unsigned, int v, int src) {
    return emu_meet(emu_warp(), emu_lane(), v)[src & 31];
}
static inline int __shfl_up_sync(unsigned, int v, int d) {
    const int lane = emu_lane();
    const int* all = emu_meet(emu_warp(), lane, v);
    return lane >= d ? all[lane - d] : v;
}
static inline unsigned __ballot_sync(unsigned, bool p) {
    const int* all = emu_meet(emu_warp(), emu_lane(), p);
    unsigned bits = 0;
    for (int k = 0; k < 32; ++k) bits |= (unsigned)(all[k] != 0) << k;
    return bits;
}
static inline int __reduce_max_sync(unsigned, int v) {
    const int* all = emu_meet(emu_warp(), emu_lane(), v);
    return *std::max_element(all, all + 32);
}
static inline int __reduce_min_sync(unsigned, int v) {
    const int* all = emu_meet(emu_warp(), emu_lane(), v);
    return *std::min_element(all, all + 32);
}
static inline int __reduce_add_sync(unsigned, int v) {
    const int* all = emu_meet(emu_warp(), emu_lane(), v);
    int sum = 0;
    for (int k = 0; k < 32; ++k) sum += all[k];
    return sum;
}
static void emu_trampoline() {
    (*emu_body)();
    const unsigned me = threadIdx.x;
    emu_fibers[me].done = true;
    EmuGroup& w = emu_warps[me / 32];
    --w.alive;
    emu_release(w);
    --emu_block.alive;
    emu_release(emu_block);
}
// one block after the other; inside a block, every live fiber in turn
static inline void emu_run_grid(unsigned grid, unsigned block,
                                const std::function<void()>& body) {
    blockDim.x = block;
    emu_body = &body;
    if (emu_fibers.size() < block) emu_fibers.resize(block);
    for (unsigned b = 0; b < grid; ++b) {
        blockIdx.x = b;
        emu_warps.assign((block + 31) / 32, EmuGroup());
        emu_block = EmuGroup();
        emu_block.alive = (int)block;
        for (unsigned t = 0; t < block; ++t) {
            EmuFiber& f = emu_fibers[t];
            f.stack.resize(256 * 1024);
            f.done = false;
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = f.stack.data();
            f.ctx.uc_stack.ss_size = f.stack.size();
            f.ctx.uc_link = &emu_main;
            makecontext(&f.ctx, emu_trampoline, 0);
            ++emu_warps[t / 32].alive;
        }
        for (unsigned left = block; left;) {
            left = 0;
            for (unsigned t = 0; t < block; ++t) {
                if (emu_fibers[t].done) continue;
                threadIdx.x = t;
                swapcontext(&emu_main, &emu_fibers[t].ctx);
                left += !emu_fibers[t].done;
            }
        }
    }
}
#define EMU_LAUNCH(kern, grid, block, ...) \
    emu_run_grid((grid), (block), [&] { kern(__VA_ARGS__); })
#endif
"""
LAUNCH = re.compile(
    r"(\w+(?:<[\w ,]+>)?)<<<(.*?),\s*(\w+),\s*\w+,\s*\(cudaStream_t\)stream>>>\(",
    re.S)
DYNAMIC_SHARED = re.compile(r"extern __shared__ int (\w+)\[\];")
# name -> (launches in the source, extra g++ flags)
EMULATED = {"seed_smem": (5, ("-DEMU_FIBERS",)), "gather_bench": (2, ()),
            "fmi_search": (3, ("-DEMU_FIBERS",)),
            "banded_sw": (2, ("-DEMU_FIBERS",)),
            "sw_full": (2, ("-DEMU_FIBERS",))}


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the CUDA sources as C++")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_runtime.h").write_text(SHIM_HEADER)
    paths = {}
    for name, (n_launches, flags) in EMULATED.items():
        with open(build.source_path(name)) as f:
            src, n = LAUNCH.subn(
                lambda m: f"EMU_LAUNCH(({m[1]}), {m[2]}, {m[3]}, ", f.read())
        assert n == n_launches
        # a block's dynamic shared memory: the most a block may ask for
        src = DYNAMIC_SHARED.sub(r"static int \1[232448 / 4];", src)
        cpp = out / f"{name}.cpp"
        cpp.write_text(src)
        paths[name] = str(out / f"lib{name}.so")
        subprocess.run(["g++", "-O1", "-ffp-contract=off", "-std=c++17",
                        *flags, "-shared", "-fPIC", f"-I{out}", "-o",
                        paths[name], str(cpp)], check=True,
                       capture_output=True)
    # the card's build makes a library of each mode's variants; this one
    # holds all of them
    paths.update((f"seed_smem_m{m}{root}", paths["seed_smem"])
                 for m in (1, 2, 3, 4) for root in ("", "_kmer"))
    return paths


@pytest.fixture
def on_emulation(emulated_libs, monkeypatch):
    """The wrappers launch the emulated builds: no stream, no CUDA device
    guard, CPU tensors accepted."""
    monkeypatch.setattr(launch, "_libs", {})
    monkeypatch.setattr(launch, "_entries", {})
    monkeypatch.setattr(
        build, "build", lambda: build.BuildResult(emulated_libs, 0.0, ""))
    monkeypatch.setattr(launch, "raw_stream", lambda index: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    for mod in (seed_smem_cuda, banded_sw_cuda, sw_full_cuda,
                fmi_search_cuda):
        monkeypatch.setattr(mod, "cuda_device", lambda x, what: x.device)
    before = dict(launch.stats.launches)
    yield
    for k, v in before.items():     # other tests read the counts as zero
        launch.stats.launches[k] = v


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(52)
    n = 26000
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[9000:9400] = np.tile(code[9000:9050], 8)
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=11)
    opt = MemOptions()
    eng = DeviceSeedingEngine(idx, opt, device="cpu")
    text = idx.text
    reads = []
    for i in range(24):
        st = int(rng.integers(0, n - 151))
        c = text[st: st + 151].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, 151))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 4 == 0:
            c[int(rng.integers(0, 151))] = 4
        if i % 2:
            c = np.where(c < 4, 3 - c, c)[::-1].astype(np.uint8)
        reads.append(c)
    reads += [text[9000 + 29 * k: 9120 + 29 * k].copy() for k in range(4)]
    reads += [text[n - 70: n + 81].copy(), text[2 * n - 151:].copy(),
              text[100:118].copy(), np.zeros(40, np.uint8),
              np.full(25, 4, np.uint8), text[9010:9490].copy()]
    mat, lens_np, _ = eng._batch_matrix(reads)
    lens = torch.from_numpy(lens_np.astype(np.int32))
    prep = seed_smem.prepare_reads(torch.from_numpy(mat), lens)
    return dict(idx=idx, opt=opt, eng=eng, reads=reads, lens=lens, prep=prep,
                rng=rng, bns=bns)


def _prepared(idx, reads):
    """A world of its own: an engine on the CPU and the reads as it prepares
    them."""
    eng = DeviceSeedingEngine(idx, MemOptions(), device="cpu")
    mat, lens_np, _ = eng._batch_matrix(reads)
    lens = torch.from_numpy(lens_np.astype(np.int32))
    return dict(idx=idx, opt=MemOptions(), eng=eng, reads=reads, lens=lens,
                prep=seed_smem.prepare_reads(torch.from_numpy(mat), lens))


def _same_round(a, b):
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    used = torch.arange(a[0].shape[2])[None, :] < a[1][:, None]
    assert torch.equal(a[0][:, used], b[0][:, used])


def test_prmi_window_kernel_on_every_key(world, on_emulation):
    idx, di = world["idx"], world["eng"].di
    khi, klo = idx.key_hi.astype(np.uint32), idx.key_lo.astype(np.uint32)
    m = np.uint32(0xFFFFF000)
    kh = np.concatenate([khi, khi & m, khi | ~m, khi])
    kl = np.concatenate([klo, np.zeros_like(klo), ~np.zeros_like(klo),
                         klo & m])
    args = (torch.from_numpy(kh.view(np.int32)),
            torch.from_numpy(kl.view(np.int32)))
    got = seed_smem_cuda.prmi_window(di, *args)
    want = ss.prmi_window(di, ss.words_u32(args[0]), ss.words_u32(args[1]))
    assert torch.equal(got[0].long(), want[0])
    assert torch.equal(got[1].long(), want[1])
    assert launch.stats.launches["prmi_window"] == 1


def test_sa_query_kernel(world, on_emulation):
    di, rng, lens = world["eng"].di, world["rng"], world["lens"]
    qbuf, nf, nr, _ = world["prep"]
    R = lens.shape[0]
    rows, pivs, vs = [], [], []
    for i in range(R):
        for _ in range(16 if lens[i] else 0):
            p = int(rng.integers(0, int(lens[i])))
            rev = int(rng.integers(0, 2))
            full = int((nr if rev else nf)[i, p]) - p
            rows.append(i + rev * R)
            pivs.append(p)
            vs.append(full if rng.random() < 0.6
                      else int(rng.integers(0, full + 1)))
    mi = rng.choice([1, 1, 2, 3, 9, 21, 1000], len(rows))
    jobs = [torch.tensor(np.asarray(a), dtype=torch.int32)
            for a in (rows, pivs, vs, mi)]
    counts = torch.zeros((2, len(rows)), dtype=torch.int32)
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs, counts=counts)
    work = ss.Work(len(rows), "cpu")
    assert torch.equal(got, seed_smem.sa_query_torch(di, qbuf, *jobs,
                                                     work=work))
    assert int(got[0].max()) > 112 and int((jobs[2] == 0).sum()) > 0
    # a job with a pattern took at least a leaf record and a probe of its
    # window's ranks; one without took nothing
    sectors, steps = counts
    assert bool((steps[jobs[2] > 0] >= 2).all())
    assert bool((sectors[jobs[2] > 0] >= 1).all())
    assert bool((counts[:, jobs[2] == 0] == 0).all())
    # the probes of the scalar contract's searches: a pin of the plain
    # version's count (recorded when it equalled, job for job, what a kernel
    # of one thread a job counted while it read; that kernel is gone)
    probes = work.probes
    assert (int(probes.sum()), int(probes.max())) == (16279, 250)
    assert bool((probes[jobs[2] == 0] == 0).all())
    # what the answers stand on, held against the scalar HostSeedingEngine
    # made to note the rows beside its insertion points and borders
    noting = _NotingHostEngine(world["idx"], world["opt"])
    for row, piv, v, m in zip(*(j.tolist() for j in jobs)):
        noting.sa_query(_pattern(world, row, piv, v), m)
    ids = work.answer_ids()
    assert ids[ids < ss.IN_PARAMS].tolist() == sorted(noting.sectors)
    # no floor unless the kernel read at least that
    assert int(sectors.sum()) >= work.answer_sectors(leaves=False)


def _pattern(w, row: int, piv: int, v: int):
    """pattern[:v] of query row ``row`` from ``piv`` as the device packs it:
    the read or its reverse complement, N as A, T past its end."""
    R = len(w["reads"])
    c = w["reads"][row % R]
    c = np.where(c < 4, 3 - c, c)[::-1] if row >= R else c
    c = np.concatenate([np.where(c >= 4, 0, c), np.full(v, 3)])
    return c[piv: piv + v].astype(np.uint8)


class _NotingHostEngine(HostSeedingEngine):
    """The scalar engine, noting the 32-byte index sectors its answers stand
    on: for each compare at ip - 1 and ip of a match shorter than the
    pattern (a match of the whole pattern stands on its interval's first
    row) and on both sides of both borders of an interval, the rank row (16
    bytes: rank >> 1) and, where the first 48 bases tie and the pattern is
    longer, the packed text (128 bases a sector) from the 49th base to the
    first that differs or the pattern's last, as far as the text goes."""

    def __init__(self, idx, opt) -> None:
        super().__init__(idx, opt)
        self.sectors = set()

    def _note(self, rank: int, pat) -> None:
        if not 0 <= rank < self.n:
            return
        self.sectors.add(rank >> 1)
        pos, lcp = int(self.sa[rank]), self._lcp(rank, pat)
        end = min(pos + min(lcp + 1, len(pat)), self.n)
        for base in range(pos + 48, end):
            self.sectors.add(ss.IN_TEXT + (base >> 7))

    def find_longest(self, pat):
        mlen = super().find_longest(pat)
        if mlen < len(pat):
            ip = self._lower_bound(pat)
            self._note(ip - 1, pat), self._note(ip, pat)
        return mlen

    def interval_at(self, pat, length):
        lb, cnt = super().interval_at(pat, length)
        for rank in (lb - 1, lb, lb + cnt - 1, lb + cnt):
            self._note(rank, pat[:length])
        return lb, cnt


PLAIN_ROUNDS = (seed_smem.seed_round1_torch, seed_smem.seed_round2_torch,
                seed_smem.seed_round3_torch)
KERNEL_ROUNDS = (seed_smem_cuda.seed_round1, seed_smem_cuda.seed_round2,
                 seed_smem_cuda.seed_round3)


def _three_rounds(w, fns, M=96, extra=({}, {}, {})):
    """The three rounds of the world ``w`` through one implementation;
    extra[k] holds round k's counter (the plain versions' ``work``, the
    kernels' ``counts``)."""
    di, opt, lens = w["eng"].di, w["opt"], w["lens"]
    qbuf, nf, nr, nvf = w["prep"]
    k1 = fns[0](di, qbuf, nf, nr, nvf, lens, opt.min_seed_len, M, **extra[0])
    k2 = fns[1](di, qbuf, nf, nr, lens, k1[0], k1[1], opt.split_len,
                opt.split_width, opt.min_seed_len, min(M, 16), **extra[1])
    k3 = fns[2](di, qbuf, nf, lens, opt.max_mem_intv, opt.min_seed_len + 1,
                M, **extra[2])
    return k1, k2, k3


def _three_rounds_equal(w, M=96):
    plain = _three_rounds(w, PLAIN_ROUNDS, M)
    kern = _three_rounds(w, KERNEL_ROUNDS, M)
    for k, p in zip(kern, plain):
        _same_round(k, p)
    return kern


@pytest.mark.parametrize("M", [96, 2], ids=["M96", "M2_overflows"])
def test_round_kernels(world, on_emulation, M):
    """The three rounds at the engine's capacities, and at 2 slots a read,
    where the emissions that find no slot are counted, not lost."""
    k1, k2, k3 = _three_rounds_equal(world, M)
    dropped = sum(int(k[2].sum()) for k in (k1, k2, k3))
    if M == 96:
        assert dropped == 0 and int(k1[1].sum()) > 0 and int(k3[1].sum()) > 0
        assert int(k2[1].sum()) > 0
    else:
        assert dropped > 0


def test_engine_over_the_kernels_equals_the_host_oracle(world, on_emulation,
                                                        monkeypatch):
    """The engine's whole path - prep, the three kernels, pack, the host's
    stable sort - with the dispatch taking the kernel route."""
    monkeypatch.setattr(seed_smem, "_on_cuda", lambda x: True)
    eng, reads = world["eng"], world["reads"]
    host = HostSeedingEngine(world["idx"], world["opt"])
    want = [[(s.start, s.end, s.sa_lo, s.hitcount)
             for s in host.sorted_smems(c)] for c in reads]
    flat = eng.sorted_smems_batch_flat(reads)
    assert [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
            for lst in flat.to_lists()] == want
    assert [launch.stats.launches[f"seed_round{k}"] for k in (1, 2, 3)] == [
        1, 1, 1]


@pytest.mark.parametrize("R", [1, 31, 33])
def test_round_kernels_on_batches_that_fill_no_block(world, on_emulation, R):
    """A warp a read, four warps a block: one read, and counts that leave
    the last block one and three warps short."""
    kern = _three_rounds_equal(_prepared(world["idx"], world["reads"][:R]))
    assert all(k[1].shape[0] == R for k in kern)
    assert int(kern[0][1].sum()) > 0


@pytest.mark.parametrize("case", ["one_tree_step", "two_tree_steps"])
def test_round_kernels_on_windows_wider_than_a_warp(world, on_emulation,
                                                     case):
    """A coarse P-RMI gives windows of more ranks than a warp has lanes: the
    search narrows them five levels of the scalar search a step before the
    last, consecutive probe. On the world's text at rmi_bits=6 the windows
    are 20 to 62 ranks wide; on a text of skewed composition at rmi_bits=3,
    479 to 3503: wider than 32 x 30, two such steps."""
    if case == "one_tree_step":
        idx = build_index(world["bns"], rmi_bits=6)
        reads = world["reads"][:10] + world["reads"][24:]
        wider_than = 30
    else:
        rng = np.random.default_rng(53)
        n = 12000
        code = rng.choice(4, n, p=[0.7, 0.1, 0.1, 0.1]).astype(np.uint8)
        bns = bntseq.BntSeq(l_pac=n,
                            contigs=[bntseq.Contig("c", "", 0, n, 0)],
                            ambs=[], code=code)
        idx = build_index(bns, rmi_bits=3)
        reads = []
        for i in range(8):
            st = int(rng.integers(0, n - 100))
            c = idx.text[st: st + 100].copy()
            c[int(rng.integers(0, 100))] ^= 1
            reads.append(c if i % 2 else (3 - c[::-1]).astype(np.uint8))
        wider_than = 32 * 30
    w = _prepared(idx, reads)
    assert w["eng"].di.max_width > wider_than
    kern = _three_rounds_equal(w)
    assert int(kern[0][1].sum()) > 0 and int(kern[2][1].sum()) > 0


def test_sa_query_kernel_at_the_array_ends_and_on_deep_ties(world,
                                                            on_emulation):
    """Poly-A and poly-T patterns, whose windows start at rank 0 and end at
    n_sa (the probe's margin reaches past both ends of the array), and
    patterns from the tiled repeat cut at and around 48, 112 and 176 bases
    and beyond: ties that the rank row cannot break go to the packed text
    128 bases a step."""
    idx = world["idx"]
    reads = [np.zeros(60, np.uint8), np.full(60, 3, np.uint8),
             idx.text[9010:9490].copy()]
    w = _prepared(idx, reads)
    di, qbuf = w["eng"].di, w["prep"][0]
    rows, pivs, vs, mis = [], [], [], []
    for row in (0, 1, 3, 4):            # both reads, both strands
        for v in (1, 5, 19, 31, 32, 40, 60):
            for mi in (1, 3, 1000):
                rows.append(row), pivs.append(0), vs.append(v), mis.append(mi)
    for piv in (0, 7, 50):
        for v in (47, 48, 49, 60, 111, 112, 113, 120, 175, 176, 177, 200,
                  240, 241, 300, 430):
            for mi in (1, 2, 9, 1000):
                rows.append(2), pivs.append(piv), vs.append(v), mis.append(mi)
    jobs = [torch.tensor(a, dtype=torch.int32) for a in (rows, pivs, vs, mis)]
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs)
    assert torch.equal(got, seed_smem.sa_query_torch(di, qbuf, *jobs))
    assert int(got[0].max()) > 400
    ones = torch.full((1,), ss.FULL)
    lo_a, _ = ss.prmi_window(di, torch.zeros(1, dtype=torch.int64) | 0x3FF,
                             ones)
    _, hi_t = ss.prmi_window(di, ones, ones)
    assert int(lo_a) == 0 and int(hi_t) == di.n_sa


# A pin of the plain versions' count of the scalar contract's probes (one a
# rank row in range, one a 64-base text segment) for each read of ``world``
# in rounds 1, 2 and 3. Recorded when it equalled, read for read, what the
# kernels of one thread a read counted while they read; those kernels are
# gone, so this now holds the counter to what it was, not to a second
# implementation (the answers' sectors below are held to one).
WORLD_PROBES = (
    [33, 241, 19, 20, 193, 19, 21, 180, 456, 391, 308, 249, 33, 153, 510, 168,
     21, 20, 19, 20, 284, 190, 349, 296, 33, 29, 33, 34, 20, 22, 0, 418, 0,
     66],
    [85, 88, 49, 46, 128, 47, 50, 89, 132, 89, 78, 49, 89, 49, 125, 54, 50,
     56, 48, 48, 83, 88, 90, 49, 158, 151, 158, 175, 53, 54, 0, 0, 0, 430],
    [100, 94, 130, 132, 88, 129, 127, 106, 90, 77, 92, 105, 113, 119, 85, 112,
     117, 129, 133, 131, 78, 108, 91, 100, 240, 187, 215, 253, 134, 139, 0, 8,
     0, 2995])


def test_plain_sector_count_is_the_work(world, on_emulation):
    """The plain versions count the probes the scalar contract makes, read
    for read, and the distinct sectors the answers stand on; the kernels
    count their own traffic and steps: whole windows a step, so fewer steps
    than probes, and never fewer sectors than the answers need."""
    R = world["lens"].shape[0]
    work = [ss.Work(R, "cpu") for _ in range(3)]
    _three_rounds(world, PLAIN_ROUNDS, extra=[{"work": w} for w in work])
    assert [w.probes.tolist() for w in work] == [list(w) for w in WORLD_PROBES]
    counts = [torch.zeros((2, R), dtype=torch.int32) for _ in range(3)]
    _three_rounds(world, KERNEL_ROUNDS, extra=[{"counts": c} for c in counts])
    for w, c in zip(work, counts):
        sectors, steps = c
        assert bool(((sectors > 0) == (w.probes > 0)).all())
        assert bool(((steps > 0) == (w.probes > 0)).all())
        # a shorter chain than one load a probe
        assert bool((steps <= w.probes).all())
        assert 0 < w.answer_sectors(leaves=False) <= int(sectors.sum())
        assert w.answer_sectors() < int(w.probes.sum())


LAYOUTS = [(1, False), (2, False), (3, False), (1, True), (2, True),
           (3, True), (4, True)]


@pytest.mark.parametrize("mode,wide", LAYOUTS,
                         ids=[f"mode{m}{'_wide' if w else ''}"
                              for m, w in LAYOUTS])
def test_kernel_variants_of_every_layout(world, on_emulation, monkeypatch,
                                         mode, wide):
    """Every variant of the seeding kernels (modes 1-3, and 1-4 wide; mode 4
    narrow is every test above): prmi_window on every stored key, sa_query
    on jobs of every length and min_intv, the three rounds, each against its
    plain version, and the engine's whole path against the host oracle. The
    variant's launches are counted under its own name."""
    idx, opt = world["idx"], world["opt"]
    w = dict(world, eng=DeviceSeedingEngine(idx, opt, device="cpu",
                                            mode=mode, wide=wide))
    di = w["eng"].di
    assert (di.mode, di.wide) == (mode, wide)
    rank = torch.int64 if wide else torch.int32
    kh = torch.from_numpy(idx.key_hi.astype(np.uint32).view(np.int32))
    kl = torch.from_numpy(idx.key_lo.astype(np.uint32).view(np.int32))
    got = seed_smem_cuda.prmi_window(di, kh, kl)
    want = seed_smem.prmi_window_torch(di, kh, kl)
    assert got[0].dtype == rank and torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])

    rng = np.random.default_rng(mode + 10 * wide)
    qbuf, nf, nr, _ = world["prep"]
    R = world["lens"].shape[0]
    rd = rng.integers(0, R, 300)
    piv = rng.integers(0, np.maximum(world["lens"].numpy()[rd], 1))
    rev = rng.integers(0, 2, 300)
    full = np.where(rev == 1, nr.numpy()[rd, piv], nf.numpy()[rd, piv]) - piv
    v = np.where(rng.random(300) < 0.6, full,
                 (rng.random(300) * (full + 1)).astype(np.int64))
    jobs = [torch.from_numpy(a.astype(np.int32)) for a in
            (rd + rev * R, piv, v, rng.choice([1, 2, 3, 9, 21, 1000], 300))]
    counts = torch.zeros((2, 300), dtype=torch.int32)
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs, counts=counts)
    assert got.dtype == rank
    assert torch.equal(got, seed_smem.sa_query_torch(di, qbuf, *jobs))
    assert int(got[0].max()) > 112
    assert bool((counts[:, jobs[2] > 0] > 0).all())

    k1, k2, k3 = _three_rounds_equal(w)
    assert all(k[0].dtype == rank for k in (k1, k2, k3))
    assert int(k1[1].sum()) > 0 and int(k2[1].sum()) > 0
    monkeypatch.setattr(seed_smem, "_on_cuda", lambda x: True)
    host = HostSeedingEngine(idx, opt)
    want = [[(s.start, s.end, s.sa_lo, s.hitcount)
             for s in host.sorted_smems(c)] for c in world["reads"]]
    flat = w["eng"].sorted_smems_batch_flat(world["reads"])
    assert [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
            for lst in flat.to_lists()] == want
    for name in ("prmi_window", "sa_query", "seed_round1", "seed_round2",
                 "seed_round3"):
        assert launch.stats.launches[launch.variant(name, mode, wide)] >= 1
        if name != "prmi_window" or wide:
            assert launch.stats.launches[name] == 0


KMER_LAYOUTS = [(4, False, 3), (1, False, 5), (2, False, 9), (3, False, 6),
                (4, True, 7), (1, True, 4), (2, True, 8), (3, True, 3)]


@pytest.mark.parametrize("mode,wide,bits", KMER_LAYOUTS,
                         ids=[f"mode{m}{'_wide' if w else ''}_k{b}"
                              for m, w, b in KMER_LAYOUTS])
def test_kmer_root_variants_of_every_layout(world, on_emulation, monkeypatch,
                                            mode, wide, bits):
    """The k-mer (ERT) root's variant of every seeding kernel in every
    layout: kmer_window on every stored key and on cut ones, sa_query on
    jobs of every length and min_intv, the three rounds, each against its
    plain version, and the engine's whole path against the host oracle. A
    3-base root gives windows of some 800 ranks (two tree steps before the
    last probe), a 9-base root windows of a few. Launches are counted under
    the variant's own name."""
    idx, opt = world["idx"], world["opt"]
    w = dict(world, eng=DeviceSeedingEngine(idx, opt, device="cpu",
                                            mode=mode, wide=wide,
                                            root="kmer", ert_bits=bits))
    di = w["eng"].di
    assert (di.mode, di.wide, di.root, di.kmer_bits) == (mode, wide, "kmer",
                                                         bits)
    widest = int((di.kmer_table[1:] - di.kmer_table[:-1]).max())
    assert widest > 32 * 20 if bits == 3 else widest < 300
    m = np.uint32(0xFFFF0000)
    khi = idx.key_hi.astype(np.uint32)
    kh = torch.from_numpy(np.concatenate([khi, khi & m, khi | ~m]).view(
        np.int32))
    kl = torch.from_numpy(np.concatenate(
        [idx.key_lo.astype(np.uint32)] * 3).view(np.int32))
    got = seed_smem_cuda.kmer_window(di, kh, kl)
    want = seed_smem.kmer_window_torch(di, kh, kl)
    assert got[0].dtype == di.rank_dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    rng = np.random.default_rng(100 + mode + 10 * wide)
    qbuf, nf, nr, _ = world["prep"]
    R = world["lens"].shape[0]
    n = 160
    rd = rng.integers(0, R, n)
    piv = rng.integers(0, np.maximum(world["lens"].numpy()[rd], 1))
    rev = rng.integers(0, 2, n)
    full = np.where(rev == 1, nr.numpy()[rd, piv], nf.numpy()[rd, piv]) - piv
    v = np.where(rng.random(n) < 0.6, full,
                 (rng.random(n) * (full + 1)).astype(np.int64))
    jobs = [torch.from_numpy(a.astype(np.int32)) for a in
            (rd + rev * R, piv, v, rng.choice([1, 2, 3, 9, 21, 1000], n))]
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs)
    assert torch.equal(got, seed_smem.sa_query_torch(di, qbuf, *jobs))
    k1, k2, k3 = _three_rounds_equal(w)
    assert int(k1[1].sum()) > 0 and int(k3[1].sum()) > 0
    monkeypatch.setattr(seed_smem, "_on_cuda", lambda x: True)
    host = HostSeedingEngine(idx, opt)
    want = [[(s.start, s.end, s.sa_lo, s.hitcount)
             for s in host.sorted_smems(c)] for c in world["reads"]]
    flat = w["eng"].sorted_smems_batch_flat(world["reads"])
    assert [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
            for lst in flat.to_lists()] == want
    for name in ("prmi_window", "sa_query", "seed_round1", "seed_round2",
                 "seed_round3"):
        assert launch.stats.launches[launch.variant(name, mode, wide,
                                                    "kmer")] >= 1
        assert launch.stats.launches[launch.variant(name, mode, wide)] == 0


@pytest.fixture(scope="module")
def fmi_world(world):
    """The world's genome under its FM-index, and reads with N, mutations,
    both strands, repeats, a long read and reads shorter than a seed."""
    idx = world["idx"]
    fm = build_fm_index(idx.bns.code)
    reads = list(world["reads"]) + [idx.text[9000:9600].copy(),
                                    idx.text[50:60].copy()]
    return idx, fm, reads


def test_fmi_primitive_kernels(fmi_world, on_emulation):
    """fmi_backward_ext on units of every base and interval size, up to the
    whole text and across the sentinel, and fmi_sa_lookup on every rank,
    each against its plain version; the ranks' positions are the index's
    sa."""
    idx, fm, _ = fmi_world
    dfm = fmi_search.DeviceFmIndex.from_host(fm, "cpu")
    rng = np.random.default_rng(61)
    n1, B = fm.n + 1, 4000
    k = np.concatenate([rng.integers(0, n1, B), [0, fm.sentinel_index, 1]])
    s = np.concatenate([np.minimum(rng.integers(0, 100, B), n1 - k[:B]),
                        [n1, 1, n1 - 1]])
    units = [torch.from_numpy(x.astype(np.int32)) for x in
             (k, rng.integers(0, n1, B + 3), s, rng.integers(0, 4, B + 3))]
    got = fmi_search_cuda.backward_ext(dfm, *units)
    assert torch.equal(got, fmi_search.backward_ext_torch(dfm, *units))
    ranks = torch.arange(n1, dtype=torch.int32)
    got = fmi_search_cuda.sa_lookup(dfm, ranks)
    assert torch.equal(got, fmi_search.sa_lookup_torch(dfm, ranks))
    assert np.array_equal(got.numpy(), fm.sa)
    assert launch.stats.launches["fmi_backward_ext"] == 1
    assert launch.stats.launches["fmi_sa_lookup"] == 1


class CountingHostEngine(FmiHostEngine):
    """FmiHostEngine that counts its extensions (a forward extension is one
    backward extension of the complement) and records each backward step of
    its round-1/2 passes as (prev, base, min_intv, emitted, curr)."""

    def backward_ext(self, k, l, s, a):
        self.extensions += 1
        return super().backward_ext(k, l, s, a)

    def _one_pos(self, codes, x, min_intv, min_seed, out):
        """FmiHostEngine._one_pos (a copy of it), recording its backward
        steps."""
        l_seq = len(codes)
        a = int(codes[x])
        next_x = x + 1
        if a >= 4:
            return next_x
        k, l, s = self._init_intv(a)
        m, n = x, x
        prev = []
        j = x + 1
        while j < l_seq:
            a = int(codes[j])
            next_x = j + 1
            if a >= 4:
                break
            nk, nl, ns = self.forward_ext(k, l, s, a)
            if ns != s:
                prev.append((k, l, s, m, n))
            if ns < min_intv:
                next_x = j
                break
            k, l, s, n = nk, nl, ns, j
            j += 1
        if s >= min_intv:
            prev.append((k, l, s, m, n))
        prev.reverse()
        for j in range(x - 1, -1, -1):
            a = int(codes[j])
            if a >= 4:
                break
            curr = []
            curr_s = -1
            p = 0
            emitted = False
            while p < len(prev):
                pk, pl, ps, pm, pn = prev[p]
                nk, nl, ns = self.backward_ext(pk, pl, ps, a)
                if ns < min_intv and (pn - pm + 1) >= min_seed:
                    out.append(Smem(pm, pn + 1, pk, ps))
                    emitted = True
                    p += 1
                    break
                if ns >= min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((nk, nl, ns, j, pn))
                    p += 1
                    break
                p += 1
            while p < len(prev):
                pk, pl, ps, pm, pn = prev[p]
                nk, nl, ns = self.backward_ext(pk, pl, ps, a)
                if ns >= min_intv and ns != curr_s:
                    curr_s = ns
                    curr.append((nk, nl, ns, j, pn))
                p += 1
            self.trace.append((prev, a, min_intv, emitted, curr))
            prev = curr
            if not prev:
                break
        if prev:
            pk, pl, ps, pm, pn = prev[0]
            if pn - pm + 1 >= min_seed:
                out.append(Smem(pm, pn + 1, pk, ps))
        return next_x

    def run(self, reads):
        """Each read's SMEMs in emission order, its extensions, and the
        backward steps."""
        lists, ext, self.trace = [], [], []
        for c in reads:
            self.extensions = 0
            lists.append([(s.start, s.end, s.sa_lo, s.hitcount)
                          for s in self.collect_smems(np.asarray(c))])
            ext.append(self.extensions)
        return lists, np.array(ext), self.trace


def check_fmi_smem(idx, fm, reads, slots, opt=MemOptions()):
    """fmi_smem through the engine against FmiHostEngine: each read's SMEMs
    in emission order (at a few slots a read, with the reruns of the reads
    that outgrow them, and the flat path then handing the batch to the
    whole-plane one); the warp's steps at most, and its extensions exactly,
    the host's extensions. Returns the host's lists and trace."""
    eng = FmiDeviceEngine(idx, opt, fm=fm, device="cpu")
    eng.max_smems = slots
    want, ext, trace = CountingHostEngine(idx, opt, fm=fm).run(reads)
    got = eng.collect_smems_batch(reads)
    assert [[(s.start, s.end, s.sa_lo, s.hitcount) for s in x]
            for x in got] == want
    flat = eng.sorted_smems_batch_flat(reads)
    if slots < 128:
        assert eng.reruns == 1 and flat is None
    else:
        assert eng.reruns == 0
        assert [[(s.start, s.end, s.sa_lo, s.hitcount) for s in x]
                for x in flat.to_lists()] == [sorted(x) for x in want]
    steps = eng._launch(reads, 128, steps=True)[2].numpy()
    assert np.array_equal(steps[0] + steps[2], ext)
    assert (steps[0] + steps[1] <= ext).all() and (steps[1] > 0).any()
    assert launch.stats.launches["fmi_smem"] >= 2
    return want, trace


@pytest.mark.parametrize("slots", [128, 3], ids=["M128", "M3_overflows"])
def test_fmi_smem_kernel_in_the_host_engines_order(fmi_world, on_emulation,
                                                   monkeypatch, slots):
    """fmi_smem, a warp a read, through the engine on the world's reads (a
    600-base one among them)."""
    idx, fm, reads = fmi_world
    monkeypatch.setattr(fmi_search, "_on_cuda", lambda x: True)
    want, _ = check_fmi_smem(idx, fm, reads, slots)
    assert sum(map(len, want)) > 100 and max(map(len, want)) > 2 * 3


@pytest.fixture(scope="module")
def fmi_family():
    """A genome with a repeat family, 40 copies of a 200 bp unit, copy i
    mutated at offset i, so that a forward pass over the unit's first 40
    bases loses one hit a base, and three copies in four also at offset
    127, so that a backward step over it gives runs of four equal counts.
    Reads: the unit's reverse complement from offsets 0 to 7 with a
    substitution 20 or 30 bases in (round 1 pivots past it, and its
    backward steps take lists of some 45 intervals across offset 127, or
    back to the substitution, where all of them die), and unit reads of
    both strands with up to two substitutions."""
    rng = np.random.default_rng(53)
    n, unit_len, copies = 20000, 200, 40
    code = rng.integers(0, 4, n).astype(np.uint8)
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    for i in range(copies):
        st = 2000 + 400 * i
        code[st:st + unit_len] = unit
        for q in (i, 127) if i % 4 else (i,):
            code[st + q] = (unit[q] + rng.integers(1, 4)) % 4
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("f", "", 0, n, 0)],
                        ambs=[], code=code)
    reads = []
    for o in range(8):
        for sub in (20, 30):
            c = (3 - unit[o:o + 151])[::-1].copy()
            c[sub] = (c[sub] + 1) % 4
            reads.append(c)
    for r in range(4):
        o = int(rng.integers(0, unit_len - 151 + 1))
        c = unit[o:o + 151].copy()
        for _ in range(int(rng.integers(0, 3))):
            q = int(rng.integers(0, 151))
            c[q] = (c[q] + 1) % 4
        reads.append((3 - c)[::-1].copy() if r % 2 else c)
    return build_index(bns, rmi_bits=8), build_fm_index(code), reads


@pytest.mark.parametrize("slots", [128, 3], ids=["M128", "M3_overflows"])
@pytest.mark.parametrize("rounds", ["all", "no_round2"])
def test_fmi_smem_kernel_on_lists_longer_than_a_warp(fmi_family, on_emulation,
                                                     monkeypatch, slots,
                                                     rounds):
    """fmi_smem on the repeat family's reads, with every round and with
    round 2 off by its options (as chip_smoke.py splits the warp's steps by
    round): FmiHostEngine's SMEMs in emission order. The host's own backward steps show what the lanes must get
    right: lists of more than 32 intervals, a first event that is an
    emission followed by kept survivors, survivors of equal counts on both
    sides of entry 32 (the second is dropped), and steps in which entry 32,
    past the first event, dies long enough to be an SMEM (and is not
    emitted)."""
    idx, fm, reads = fmi_family
    monkeypatch.setattr(fmi_search, "_on_cuda", lambda x: True)
    opt = MemOptions()
    if rounds == "no_round2":
        opt = dataclasses.replace(opt, split_width=-1)
    _, trace = check_fmi_smem(idx, fm, reads, slots, opt)
    host = FmiHostEngine(idx, MemOptions(), fm=fm)
    assert max(len(prev) for prev, *_ in trace) > 32
    assert any(emitted and curr for *_, emitted, curr in trace)
    counts = [(prev, [host.backward_ext(*e[:3], a)[2] for e in prev[:33]],
               min_intv) for prev, a, min_intv, *_ in trace if len(prev) > 32]
    assert any(ns[31] == ns[32] >= min_intv for _, ns, min_intv in counts)
    min_seed = MemOptions().min_seed_len
    assert any(ns[32] < min_intv and prev[32][4] - prev[32][3] + 1 >= min_seed
               for prev, ns, min_intv in counts)


def test_wide_prmi_window_on_a_human_scale_leaf_table(on_emulation):
    """The wide window on a synthetic leaf table of 6.2e9 suffixes (a human
    text and its reverse complement): leaf starts past 2^31 and 2^32, where
    the fused records' uint32 starts wrap, and a leaf whose predictions pass
    2^31 (a __float2int_rz would saturate); against numpy's separately
    rounded float32 on every key, 8 a leaf and each leaf's ends. The
    kernel reads the leaf records alone, so the suffix array is a stand-in
    of no memory."""
    rng = np.random.default_rng(71)
    bits, n_sa = 12, 6_200_000_000
    L = 1 << bits
    # leaves of ~1.5e6 suffixes, and one of 3e9 (a skewed leaf, whose
    # predictions pass 2^31)
    sizes = rng.integers(1, 2 * (n_sa - 3 * 10**9) // L, L)
    sizes = (sizes * ((n_sa - 3 * 10**9) / sizes.sum())).astype(np.int64)
    sizes[5] = 3 * 10**9
    ls = np.zeros(L + 1, np.int64)
    ls[1:] = np.cumsum(sizes)
    ls[-1] = n_sa
    cnt = (ls[1:] - ls[:-1]).astype(np.float32)
    alpha = (rng.random(L) * 50 - 25).astype(np.float32)
    beta = (cnt / np.float32(2.0**(64 - bits))
            * rng.uniform(0.9, 1.1, L)).astype(np.float32)
    elo = rng.integers(0, 3000, L).astype(np.int64)
    ehi = rng.integers(0, 3000, L).astype(np.int64)
    ehi[::97] = 2**31 - 1                   # the widest window a record holds
    params = np.empty((L, 6), np.uint32)
    params[:, 0] = ls[:-1].astype(np.uint32)
    params[:, 1] = ls[1:].astype(np.uint32)
    params[:, 2], params[:, 3] = alpha.view(np.uint32), beta.view(np.uint32)
    params[:, 4], params[:, 5] = elo, ehi
    di = ss.DeviceIndex(
        text32=torch.full((8,), -1, dtype=torch.int32),
        params=torch.from_numpy(params.view(np.int32)), bits=bits,
        n_sa=n_sa, mode=1, wide=True,
        sa=torch.zeros(1, dtype=torch.int64).expand(n_sa),
        params64=torch.from_numpy(ls))
    leaf = np.repeat(np.arange(L, dtype=np.uint64), 8)
    rel = rng.integers(0, 1 << (64 - bits), len(leaf), dtype=np.uint64)
    rel[::8] = 0
    rel[1::8] = (1 << (64 - bits)) - 1
    key = (leaf << np.uint64(64 - bits)) | rel
    khi = (key >> np.uint64(32)).astype(np.uint32)
    klo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    args = [torch.from_numpy(k.view(np.int32)) for k in (khi, klo)]
    got = seed_smem_cuda.prmi_window(di, *args)
    assert launch.stats.launches["prmi_window[wide]"] == 1
    # numpy: every float32 step rounded on its own, as models/prmi.py's
    # windows assume
    lf = leaf.astype(np.int64)
    relf = ((khi & np.uint32((1 << (32 - bits)) - 1)).astype(np.float32)
            * np.float32(4294967296.0) + klo.astype(np.float32))
    predf = np.minimum(np.maximum(alpha[lf] + beta[lf] * relf,
                                  np.float32(0)), cnt[lf])
    pred = ls[lf] + predf.astype(np.int64)
    lo = np.maximum(pred - elo[lf], 0)
    hi = np.minimum(pred + ehi[lf], n_sa)
    assert (got[0].numpy() == lo).all() and (got[1].numpy() == hi).all()
    assert torch.equal(got[0], ss.prmi_window(di, *map(ss.words_u32, args))[0])
    assert lo.max() > 2**32 and (pred - ls[lf]).max() > 2**31
    assert (params[:, 0].astype(np.int64) != ls[:-1]).any()


@pytest.mark.parametrize("width", [4, 128])
def test_gather_kernels(on_emulation, width):
    rng = np.random.default_rng(width)
    n, L, W, K = 3000, 200, 16, 15
    src = torch.from_numpy(rng.integers(0, 1 << 32, (n, width),
                                        dtype=np.int64).astype(
                                            np.uint32).view(np.int32))
    idx = torch.from_numpy(rng.integers(0, n - W, L).astype(np.int32))
    assert torch.equal(
        gather_bench._gather_rows_cuda("gather_flat", src, idx, 1)[:, 0],
        gather_bench.gather_flat_torch(src, idx))
    assert torch.equal(
        gather_bench._gather_rows_cuda("gather_window", src, idx, W),
        gather_bench.gather_window_torch(src, idx, W))
    assert torch.equal(gather_bench.gather_chain_cuda(src, idx, K),
                       gather_bench.gather_chain_torch(src, idx, K))
    assert launch.stats.launches["gather_chain"] >= 1


def test_launch_refused_raises(world, on_emulation, monkeypatch):
    """A launcher that reports a CUDA error makes the wrapper raise: no
    fallback to the plain version."""
    di = world["eng"].di
    seed_smem_cuda._entry(di, "window_launch")  # bound, then replaced
    monkeypatch.setitem(launch._entries, ("seed_smem_m4", "window_launch"),
                        lambda *a: 9)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        seed_smem_cuda.prmi_window(di, z, z)
    assert launch.stats.launches["prmi_window"] == 0


# ------------------------------------------------- the warp-a-job banded SW

SW_KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
LANE_EDGES = (0, 1, 31, 32, 33, 63, 64, 65)


def _sw_pairs(seed, B, Q, T, alphabet=5, w=100):
    """Extension pairs as the main path makes them (the target a noisy copy
    of the query plus its gap allowance), every other one unrelated."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alphabet, (B, Q)).astype(np.int32)
    t = rng.integers(0, alphabet, (B, T)).astype(np.int32)
    n = min(Q, T)
    noisy = np.where(rng.random((B, n)) < 0.05,
                     rng.integers(0, 4, (B, n)), q[:, :n])
    t[::2, :n] = noisy[::2]
    t[::8, 15: n - 3] = noisy[::8, 18:]         # and a 3-base gap in some
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 40, B), T).astype(np.int32)
    tlen[1::4] = rng.integers(0, T + 1, len(tlen[1::4]))
    h0 = rng.integers(1, 80, B).astype(np.int32)
    ws = rng.choice([w, 2 * w], B).astype(np.int32)
    return q, t, qlen, tlen, h0, ws


def _sw_both(arrays, opt, zdrop, end_bonus=5):
    """The emulated kernel and the plain version on the same pairs."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    args = (*ts, torch.from_numpy(opt.mat.astype(np.int32)), opt.o_del,
            opt.e_del, opt.o_ins, opt.e_ins, end_bonus, zdrop)
    got = banded_sw_cuda.banded_sw_pairs(*args)
    want = bsw.sw_core_torch(*args)
    return ({k: got[k].numpy() for k in SW_KEYS},
            {k: want[k].numpy() for k in SW_KEYS})


def _assert_same(got, want):
    for k in SW_KEYS:
        assert np.array_equal(got[k], want[k]), (
            k, np.flatnonzero(got[k] != want[k])[:8])


def _assert_scalar(arrays, opt, zdrop, got, jobs, end_bonus=5):
    q, t, qlen, tlen, h0, ws = arrays
    for b in jobs:
        r = sw_extend(q[b, : qlen[b]], t[b, : tlen[b]], opt.mat, opt.o_del,
                      opt.e_del, opt.o_ins, opt.e_ins, int(ws[b]), end_bonus,
                      zdrop, int(h0[b]))
        assert [getattr(r, k) for k in SW_KEYS] == [
            int(got[k][b]) for k in SW_KEYS], b


@pytest.mark.parametrize("zdrop", [100, 0], ids=["zdrop100", "zdrop0"])
def test_banded_sw_kernel_at_the_lane_boundaries(on_emulation, zdrop):
    """Query lengths around multiples of the 32 lanes and at Q, the retry ladder's
    bands and a negative one, h0 = 0, all-N queries, empty and one-row
    targets, in a batch that does not fill its last block: the emulated
    kernel == the plain version == the JAX package's XLA kernel, and == the
    scalar contract wherever h0 > 0."""
    opt = MemOptions()
    Q, T, B = 70, 120, 61
    arrays = _sw_pairs(3, B, Q, T)
    q, t, qlen, tlen, h0, ws = arrays
    qlen[: len(LANE_EDGES)] = LANE_EDGES
    qlen[8:10] = Q
    tlen[:10] = np.minimum(qlen[:10] + 30, T)
    q[:10:2] = t[:10:2, :Q]                       # related, so they run long
    ws[10:24] = [1, 2, 100, 200, 400, 800, -1] * 2
    qlen[10:24] = [40, 66] * 7
    tlen[10:24] = [70, 100] * 7
    h0[24:28] = 0
    q[28:32] = 4
    tlen[32:34] = 0
    tlen[34:36] = 1
    got, want = _sw_both(arrays, opt, zdrop)
    _assert_same(got, want)
    jx = jbsw.banded_sw_extend_batch(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(opt.mat.astype(np.int32)),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, 5, zdrop)
    _assert_same(got, {k: np.asarray(jx[k]) for k in SW_KEYS})
    _assert_scalar(arrays, opt, zdrop, got, np.flatnonzero(h0 > 0))
    assert launch.stats.launches["banded_sw_pairs"] == 1
    assert int(got["score"].max()) > 100 and int(got["max_off"].max()) > 0


def test_banded_sw_kernel_tie_rule(on_emulation):
    """Few letters, unit gap costs, a small z-drop: rows whose maximum ties
    between cells decide where the extension stops. Narrow bands tie between
    neighbouring lanes; wide ones inside a lane's run of cells too."""
    rng = np.random.default_rng(10)
    B = 192
    arrays = (rng.integers(0, 3, (B, 80)).astype(np.int32),
              rng.integers(0, 3, (B, 90)).astype(np.int32),
              rng.integers(2, 81, B).astype(np.int32),
              rng.integers(2, 91, B).astype(np.int32),
              rng.integers(1, 24, B).astype(np.int32),
              rng.integers(1, 8, B).astype(np.int32))
    arrays[5][::2] = rng.integers(30, 70, B // 2)
    arrays[0][::4] %= 2
    arrays[1][::4] %= 2
    opt = MemOptions(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1)
    for zdrop in (5, 30):
        got, want = _sw_both(arrays, opt, zdrop)
        _assert_same(got, want)
        _assert_scalar(arrays, opt, zdrop, got, range(B))


@pytest.mark.parametrize("run", [17, 18])   # one of them ends in one lane
@pytest.mark.parametrize("Q,apart", [(60, 32), (60, 1), (230, 1)],
                         ids=["lanes_apart", "in_a_lane", "in_a_lane_looped"])
def test_banded_sw_kernel_tie_between_two_paths(on_emulation, Q, apart, run):
    """Two equal paths ``apart`` columns apart, so every row's maximum ties
    between two cells: of lanes far from each other, or neighbours in one
    lane's run (two cells a lane at Q = 60, seven in the looped form at
    Q = 230). A made-up matrix lifts query columns c and c + apart to the
    same score in row 0 and kills every other cell (a gap open costs more
    than a path gains back), then both paths run down the same letters. The
    larger column must win each row."""
    mat = np.full((5, 5), -1000, np.int32)
    mat[1, 0] = mat[1, 2] = 1   # rows 1.. (target letter 1) extend the runs
    mat[4, 4] = 1000            # only widens the f32 band clamp
    h0, c = 400, 5
    T = run + 1                 # the target ends both paths in one row
    gaps = (300, 1, 300, 1)
    q = np.full((1, Q), 3, np.int32)
    q[0, c + 1: c + apart + 1 + run] = 0
    q[0, c], q[0, c + apart] = 1, 2
    t = np.ones((1, T), np.int32)
    t[0, 0] = 0                 # row 0 alone sees the lifting scores
    first_row = h0 - 301 - (np.arange(1, Q + 1) - 1)   # H(-1, j-1), j >= 1
    mat[0, 1] = 600 - first_row[c - 1]
    mat[0, 2] = 600 - first_row[c + apart - 1]
    ts = [torch.from_numpy(a) for a in (
        q, t, np.array([Q], np.int32), np.array([T], np.int32),
        np.array([h0], np.int32), np.array([300], np.int32), mat)]
    got = banded_sw_cuda.banded_sw_pairs(*ts, *gaps, 5, 0)
    want = bsw.sw_core_torch(*ts, *gaps, 5, 0)
    for k in SW_KEYS:
        assert int(got[k][0]) == int(want[k][0]), k
    r = sw_extend(q[0], t[0], mat, *gaps, 300, 5, 0, h0)
    assert [getattr(r, k) for k in SW_KEYS] == [int(got[k][0])
                                                for k in SW_KEYS]
    assert int(got["score"][0]) == 600 + run
    assert int(got["qle"][0]) == c + apart + run + 1    # not c + run + 1
    assert int(got["tle"][0]) == run + 1


@pytest.mark.parametrize("gap", [20, 33, 45, 70])
def test_banded_sw_kernel_long_insertions(on_emulation, gap):
    """A query with ``gap`` bases the target lacks: F decays across many
    lanes' cells, so it must come out of the scan across the lanes and not
    only from a lane's own cells, and the alignment picks up again past the
    gap."""
    opt = MemOptions()
    rng = np.random.default_rng(gap)
    B, Q, T = 4, 200, 220
    base = rng.integers(0, 4, (B, T)).astype(np.int32)
    q = np.zeros((B, Q), np.int32)
    cut = np.array([40, 57, 64, 31])
    for b in range(B):
        junk = (base[b, cut[b]: cut[b] + gap] + 2) % 4
        q[b] = np.concatenate([base[b, : cut[b]], junk, base[b, cut[b]:]])[:Q]
    arrays = (q, base, np.full(B, Q, np.int32), np.full(B, T, np.int32),
              np.array([60, 90, 120, 150], np.int32),
              np.full(B, 100, np.int32))
    got, want = _sw_both(arrays, opt, 0)
    _assert_same(got, want)
    _assert_scalar(arrays, opt, 0, got, range(B))
    if gap <= 45:   # the gap costs less than the bases past it score
        assert (got["qle"] - got["tle"] == gap).all(), (got["qle"], got["tle"])


def test_banded_sw_kernel_long_queries(on_emulation):
    """The 1 kbp path's shape: Q > 1000, T > 1200, rows of 7 to 13 cells a
    lane (the widest unrolled rows and the looped form), with inexact gap
    costs in the f32 band clamp."""
    opt = MemOptions(o_del=5, e_del=3, o_ins=7, e_ins=2)
    arrays = _sw_pairs(5, 3, 1030, 1250, alphabet=4)
    q, t, qlen, tlen, h0, ws = arrays
    qlen[:] = (1030, 1001, 517)
    tlen[:] = (1250, 1100, 700)
    t[:, :1030] = np.where(np.random.default_rng(6).random((3, 1030)) < 0.03,
                           (q + 1) % 4, q)
    t[0, 300:1240] = t[0, 290:1230].copy()        # a 10-base insertion
    got, want = _sw_both(arrays, opt, 100)
    _assert_same(got, want)
    _assert_scalar(arrays, opt, 100, got, range(3))
    assert int(got["qle"].max()) > 1000 and int(got["tle"].min()) > 500


@pytest.mark.parametrize("n_jobs", [37, 64])
def test_banded_sw_coord_round(on_emulation, n_jobs):
    """A round in coordinates: the left launch writes the scores the right
    launch starts from; pad jobs with the sentinel reg write nothing."""
    opt = MemOptions()
    rng = np.random.default_rng(n_jobs)
    text = rng.integers(0, 4, 6000).astype(np.uint8)
    text32 = np.concatenate([pack_words(text, pad_code=3),
                             np.full(12, 0xFFFFFFFF, np.uint32)])
    R, L = 16, 151
    src = rng.integers(300, 5000, R)
    codes = text[src[:, None] + np.arange(L)]
    codes = np.where(rng.random(codes.shape) < 0.03,
                     rng.integers(0, 5, codes.shape), codes).astype(np.uint8)
    G = n_jobs - 3
    row = rng.integers(0, R, n_jobs)
    qbeg = rng.integers(0, L - 19, n_jobs)
    qe = qbeg + np.minimum(rng.integers(19, L + 1, n_jobs), L - qbeg)
    left = np.zeros((7, n_jobs), np.int32)
    left[0] = np.arange(n_jobs)
    left[0, G:] = G + 4                             # pad jobs: no scatter
    left[1], left[3], left[5], left[6] = row, qbeg, qbeg + 30, opt.w
    left[4] = src[row] + qbeg - left[5]
    left[3:6, G:] = 0
    right = left.copy()
    right[2], right[3] = qe, L - qe
    right[4], right[5] = src[row] + qe, L - qe + 30
    right[3:6, G:] = 0
    h0 = np.zeros(G + 4, np.int32)
    h0[:G] = qe[:G] - qbeg[:G]
    t32, cd, lj, rj, mat = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in (
            text32.view(np.int32), codes, left, right,
            opt.mat.astype(np.int32)))
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    results = []
    for fn in (banded_sw_cuda.banded_sw_coord, bsw.extend_side_round_torch):
        reg = torch.from_numpy(h0.copy())
        lres = fn(t32, cd, lj, reg, mat, *gaps, opt.pen_clip5, opt.zdrop,
                  True, True)
        rres = fn(t32, cd, rj, reg, mat, *gaps, opt.pen_clip3, opt.zdrop,
                  False, False)
        results.append((lres, rres, reg))
    for got, want in zip(*results):
        assert torch.equal(got, want)
    lres, rres, reg = results[0]
    assert torch.equal(rres[7, :G], lres[0, :G])    # right h0 = left score
    assert int(reg[G:].sum()) == 0 and int(lres[0, :G].min()) > 0
    assert launch.stats.launches["banded_sw_coord"] == 2


def _long_jobs(seed, Q, T, qlen, tlen, ws, gap_at):
    """Jobs whose target is the query with a few substitutions and, from
    ``gap_at`` on, 7 bases fewer, so that they run on off the diagonal."""
    rng = np.random.default_rng(seed)
    B = len(qlen)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    n = min(Q, T) - 7
    t[:, :n] = np.where(rng.random((B, n)) < 0.02, (q[:, :n] + 1) % 4,
                        q[:, :n])
    t[:, gap_at:n] = q[:, gap_at + 7: n + 7]
    return (q, t, np.asarray(qlen, np.int32), np.asarray(tlen, np.int32),
            np.full(B, 60, np.int32), np.asarray(ws, np.int32))


def test_banded_sw_kernel_sliding_state(on_emulation):
    """Queries past the 4095 bases that get a slot a cell keep their rows
    in a window of 4096 slots that slides along the query with the band
    (more than once here), the cells ahead filled in as it moves, and the
    result is that of a slot a cell. A band of 1023 just fits the window's
    half; a short query in the same launch never slides."""
    opt = MemOptions()
    Q, T = 9000, 9100
    arrays = _long_jobs(1, Q, T, (Q, 5300, 4096, 33, 0), (T, 5400, 4200, 60, 5),
                        (100, 800, 1023, 100, 100), 900)
    got, want = _sw_both(arrays, opt, 100)
    _assert_same(got, want)
    assert got["qle"][:3].tolist() == [Q, 5300, 4096]
    _assert_scalar(arrays, opt, 100, got, [3, 4])


def test_banded_sw_kernel_overflow_state(on_emulation):
    """A band with more live cells than half the window (a query past 4095
    bases under a band past 1023) runs on device memory that the launcher
    allocates, beside jobs of the same launch that stay in shared memory;
    no length is refused."""
    opt = MemOptions()
    Q, T = 30000, 120
    arrays = _long_jobs(2, Q, T, (Q, 5000, 4100, Q, 64), (T, 100, 110, 90, 70),
                        (1 << 20, 1024, 5000, 100, 1 << 20), 40)
    got, want = _sw_both(arrays, opt, 0)
    _assert_same(got, want)
    assert int(got["tle"].min()) > 50 and int(got["max_off"].max()) > 0
    _assert_scalar(arrays, opt, 0, got, [4])


@pytest.mark.parametrize("width", [3, 4, 6, 12])
def test_gather_rows_of_any_width(on_emulation, width):
    """Widths that are no multiple of four words take the word path, the
    others 16 bytes a thread; a lane's span that is no power of two is
    divided, not shifted. A view whose storage is not 16-byte aligned falls
    back to words."""
    rng = np.random.default_rng(width)
    n, L, W = 500, 77, 3
    base = torch.from_numpy(rng.integers(0, 1 << 31, n * width + 1,
                                         dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, n - W, L).astype(np.int32))
    for src in (base[:-1].reshape(n, width), base[1:].reshape(n, width)):
        assert torch.equal(gather_bench._gather_rows_cuda(
            "gather_flat", src, idx, 1, flat=True),
            gather_bench.gather_flat_torch(src, idx))
        assert torch.equal(gather_bench._gather_rows_cuda(
            "gather_window", src, idx, W),
            gather_bench.gather_window_torch(src, idx, W))


# ------------------------------------------------------ the warp-a-job full SW


def _full_sw_jobs(seed, B, Q, T):
    """Rescue-like jobs: queries cut from their targets with substitutions,
    every other target also holding a second copy (a score2 row), and the
    edge cases: lane-boundary query lengths, qlen 1, all-N queries and
    targets, targets shorter than their queries, empty jobs."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = rng.integers(Q // 2, T + 1, B).astype(np.int32)
    for b in range(B):
        n = int(qlen[b])
        st = int(rng.integers(0, max(1, int(tlen[b]) - n)))
        src = t[b, st: st + n]
        q[b, : len(src)] = np.where(rng.random(len(src)) < 0.05,
                                    (src + 1) % 4, src)
        if b % 2 and tlen[b] > 2 * n + 20:
            t[b, tlen[b] - n - 5: tlen[b] - 5] = src
    qlen[:9] = (1, 31, 32, 33, 63, 64, 65, Q, 2)
    q[9:11] = 4
    t[11, :] = 4
    tlen[12:15] = (1, 5, 20)
    tlen[15], qlen[16] = 0, 0
    return q, t, qlen, tlen


def _full_sw_both(arrays, opt, with_start=True, min_sc=19, steps=None):
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    B = ts[0].shape[0]
    args = (*ts, torch.from_numpy(opt.mat.astype(np.int32)),
            torch.full((B,), min_sc, dtype=torch.int32), opt.o_del,
            opt.e_del, opt.o_ins, opt.e_ins, with_start)
    return (sw_full_cuda.sw_full_pairs(*args, steps=steps),
            sw_full.sw_full_torch(*args))


@pytest.mark.parametrize("with_start", [True, False],
                         ids=["with_start", "forward_only"])
def test_sw_full_kernel_pair_form(on_emulation, with_start):
    """The pair form, both passes, in a batch that leaves its last block
    short: the emulated kernel == the plain version on all seven outputs,
    and == the scalar ksw_align2 contract."""
    from bwameme_tpu_torch.align.sw_scalar import sw_align

    opt = MemOptions()
    arrays = _full_sw_jobs(1, 61, 100, 260)
    got, want = _full_sw_both(arrays, opt, with_start)
    assert torch.equal(got, want)
    assert launch.stats.launches["sw_full"] == 1
    q, t, qlen, tlen = arrays
    for b in range(61):
        ref = sw_align(q[b, : qlen[b]], t[b, : tlen[b]], opt.mat, opt.o_del,
                       opt.e_del, opt.o_ins, opt.e_ins, xtra_start=True,
                       min_sc=19)
        assert [int(x) for x in got[:4, b]] == [ref.score, ref.te, ref.qe,
                                                ref.score2], b
        if with_start and ref.score > 0:
            assert (int(got[5, b]), int(got[6, b])) == (ref.tb, ref.qb), b
    assert int((got[3] > 0).sum()) > 5 and int((got[0] > 40).sum()) > 10


def test_sw_full_kernel_row_max_ties(on_emulation):
    """Two letters and unit costs: rows whose maximum several columns of
    one lane and of different lanes share. qe is the smallest such column,
    te the first row that raised the best, te2 the first maximal row."""
    rng = np.random.default_rng(11)
    B, Q, T = 40, 90, 200
    q = rng.integers(0, 2, (B, Q)).astype(np.int32)
    t = np.tile(q, 3)[:, :T]
    t = np.where(rng.random((B, T)) < 0.1, 1 - t, t).astype(np.int32)
    arrays = (q, t, rng.integers(2, Q + 1, B).astype(np.int32),
              rng.integers(2, T + 1, B).astype(np.int32))
    opt = MemOptions(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1)
    got, want = _full_sw_both(arrays, opt, min_sc=3)
    assert torch.equal(got, want)
    assert int((got[3] > 0).sum()) > 10


def test_sw_full_kernel_coordinate_form_past_the_shared_cells(on_emulation):
    """The coordinate form against the packed text, the reverse pass
    reading the forward pass's te/qe on the device, in a launch with one
    query past sw_full_cuda.SHARED_CELLS (its rows in device memory, the
    others' in shared memory) and targets past a thousand rows."""
    opt = MemOptions()
    rng = np.random.default_rng(12)
    text = rng.integers(0, 4, 20000).astype(np.uint8)
    text32 = torch.from_numpy(np.concatenate(
        [pack_words(text, pad_code=3),
         np.full(12, 0xFFFFFFFF, np.uint32)]).view(np.int32))
    N, Q = 9, sw_full_cuda.SHARED_CELLS + 40
    qlen = np.array([Q, 151, 151, 1, 60, 151, 0, 151, 33], np.int32)
    tlen = np.array([Q + 150, 530, 1300, 40, 0, 530, 50, 100, 90], np.int32)
    tstart = rng.integers(0, 18000 - int(tlen.max()), N).astype(np.int32)
    q = np.zeros((N, Q), np.uint8)
    for b in range(N):
        src = text[tstart[b] + 50: tstart[b] + 50 + qlen[b]]
        q[b, : len(src)] = np.where(rng.random(len(src)) < 0.04,
                                    (src + 1) % 4, src)
    q[7, :151] = 4
    jobs = torch.from_numpy(np.stack([qlen, tstart, tlen]))
    args = (text32, torch.from_numpy(q), jobs,
            torch.from_numpy(opt.mat.astype(np.int32)),
            torch.full((N,), 19, dtype=torch.int32), opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, int(tlen.max()))
    got = sw_full_cuda.sw_full_coord(*args)
    assert torch.equal(got, sw_full.sw_full_coord_torch(*args))
    assert launch.stats.launches["sw_full"] == 1
    assert int(got[0, 0]) > 700 and int(got[6, 0]) == 0


def _lanes_before_last(qlen):
    """The wavefront's last lane holding columns: K = ceil(qlen / 32)
    columns a lane."""
    k = -(-qlen // 32)
    return -(-qlen // k) - 1


def _assert_steps(got, steps, qlen, tlen, with_start=True):
    """The forward pass runs tlen + (lanes holding columns) - 1 steps; the
    reverse pass stops at the step whose last lane reaches the forward
    score, on row te_rev = te - tb of the reversed prefix."""
    for b in range(got.shape[1]):
        score, te, qe, tb = (int(got[k, b]) for k in (0, 1, 2, 5))
        fwd = (int(tlen[b]) + _lanes_before_last(int(qlen[b]))
               if qlen[b] > 0 and tlen[b] > 0 else 0)
        rev = (te - tb + 1 + _lanes_before_last(qe + 1)
               if with_start and score > 0 else 0)
        assert (int(steps[0, b]), int(steps[1, b])) == (fwd, rev), b


@pytest.mark.parametrize("with_start", [True, False],
                         ids=["with_start", "forward_only"])
@pytest.mark.parametrize("qlen", [1, 31, 32, 33, 151, 256, 300])
def test_sw_full_wavefront_shapes(on_emulation, qlen, with_start):
    """Query lengths at and around the lanes' multiples, up to the register
    columns' 256 and past them (300: the columns in shared memory), against
    targets of 0, 1 and 5 rows (fewer rows than lanes: the wavefront only
    fills and drains), 40 and longer ones holding the query: kernel ==
    plain on all seven outputs, and the steps each pass ran."""
    rng = np.random.default_rng(qlen)
    tlens = [0, 1, 5, 40, qlen + 60, 2 * qlen + 40, 2 * qlen + 40, 7]
    B, T = len(tlens), max(tlens)
    q = rng.integers(0, 4, (B, qlen)).astype(np.int32)
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    for b, n in enumerate(tlens):
        if n >= qlen:       # the query, with substitutions, in the target
            st = int(rng.integers(0, n - qlen + 1))
            t[b, st: st + qlen] = np.where(rng.random(qlen) < 0.04,
                                           (q[b] + 1) % 4, q[b])
    t[6, : qlen] = q[6]     # the alignment starts on the prefix's last row
    q[7, :] = 4
    arrays = (q, t, np.full(B, qlen, np.int32), np.array(tlens, np.int32))
    opt = MemOptions()
    steps = torch.zeros((2, B), dtype=torch.int32)
    got, want = _full_sw_both(arrays, opt, with_start, steps=steps)
    assert torch.equal(got, want)
    assert launch.stats.launches["sw_full"] == 1
    _assert_steps(got, steps, arrays[2], arrays[3], with_start)
    if with_start:
        assert int(got[5, 6]) == 0 and int(got[0, 6]) >= qlen - 8


def test_sw_full_reverse_pass_reaches_the_score_on_several_rows(
        on_emulation):
    """Under match = mismatch = 1, a mismatch and a match before the core
    of each alignment give its start a second choice of equal score: the
    reverse pass reaches the forward score on its row te_rev and again two
    rows later. tb/qb take the first (te_rev moves only on a strictly
    larger maximum), which is where the kernel stops; the plain version
    runs the whole prefix."""
    rng = np.random.default_rng(21)
    B, m, Q, T = 24, 40, 60, 120
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(m + 2, Q + 1, B).astype(np.int32)
    tlen = np.full(B, T, np.int32)
    for b in range(B):
        core = rng.integers(0, 4, m)
        st = int(rng.integers(2, T - Q))
        t[b, st - 2: st + m] = np.concatenate([[0, 1], core])
        q[b, : m + 2] = np.concatenate([[0, 2], core])
        q[b, m + 2:] = (t[b, st + m: st + m + Q - m - 2] + 2) % 4
    opt = MemOptions(a=1, b=1)
    steps = torch.zeros((2, B), dtype=torch.int32)
    got, want = _full_sw_both((q, t, qlen, tlen), opt, steps=steps)
    assert torch.equal(got, want)
    _assert_steps(got, steps, qlen, tlen)
    assert int((got[6] == 2).sum()) > B // 2    # the later start not taken


@pytest.mark.parametrize("a,b", [(31, 32), (32, 4), (1, 40)],
                         ids=["6_bit_edges", "match_past_6_bits",
                              "mismatch_past_6_bits"])
def test_sw_full_scores_at_and_past_the_register_profile(on_emulation, a, b):
    """Scores in [-32, 31] ride in the registers' 6-bit query profile;
    larger ones send short queries to the columns in memory. Both == the
    plain version."""
    opt = MemOptions(a=a, b=b)
    got, want = _full_sw_both(_full_sw_jobs(5, 20, 70, 150), opt,
                              min_sc=a * 19)
    assert torch.equal(got, want)
    assert int((got[0] > 10 * a).sum()) > 5
