"""The CUDA sources of the seeding and gather kernels, run on the CPU.

There is no nvcc and no card here, but the kernels' threads do not
cooperate (one thread a read, a job or a word; no shared memory, no
barriers), so g++ can compile csrc/seed_smem.cu and csrc/gather_bench.cu as
serial C++ behind a stand-in for <cuda_runtime.h> (SHIM_HEADER below):
every thread of a launch runs in turn.
The real ctypes wrappers then launch these builds on CPU tensors, and each
kernel is held against its plain PyTorch version, all values equal. This
checks the kernels' arithmetic and control flow, the wrappers' argument
lists and the sector counts; what only the card can show (that nvcc accepts
the source, the float intrinsics' rounding, timing) is chip_smoke.py's."""

import contextlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.ops import build, gather_bench, launch
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine
from bwameme_tpu_torch.utils.config import MemOptions

SHIM_HEADER = r"""// A stand-in for <cuda_runtime.h> that lets g++ compile the port's CUDA
// sources as serial C++: every thread of a launch runs in turn on the host.
// Only for kernels whose threads do not cooperate (no shared memory, no
// barriers). The <<<grid, block, 0, stream>>> launches are rewritten into
// EMU_LAUNCH calls before the compile.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
struct uint4 { uint32_t x, y, z, w; };
struct EmuDim { unsigned x; };
static thread_local EmuDim blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __clz(int x) {
    return x == 0 ? 32 : __builtin_clz((unsigned)x);
}
// separately rounded float steps (the file is built with -ffp-contract=off)
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __uint2float_rn(uint32_t x) { return (float)x; }
static inline float __int2float_rn(int x) { return (float)x; }
static inline int __float2int_rz(float x) { return (int)x; }
static inline float __uint_as_float(uint32_t x) {
    float f;
    memcpy(&f, &x, 4);
    return f;
}
static inline int cudaGetLastError() { return 0; }
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
"""
LAUNCH = re.compile(
    r"(\w+)<<<(.*?),\s*(\w+),\s*0,\s*\(cudaStream_t\)stream>>>\(", re.S)


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the CUDA sources as serial C++")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_runtime.h").write_text(SHIM_HEADER)
    paths = {}
    for name in ("seed_smem", "gather_bench"):
        with open(build.source_path(name)) as f:
            src, n = LAUNCH.subn(
                lambda m: f"EMU_LAUNCH({m[1]}, {m[2]}, {m[3]}, ", f.read())
        assert n >= 2
        cpp = out / f"{name}.cpp"
        cpp.write_text(src)
        paths[name] = str(out / f"lib{name}.so")
        subprocess.run(["g++", "-O1", "-ffp-contract=off", "-std=c++17",
                        "-shared", "-fPIC", f"-I{out}", "-o", paths[name],
                        str(cpp)], check=True, capture_output=True)
    return paths


@pytest.fixture
def on_emulation(emulated_libs, monkeypatch):
    """The wrappers launch the serial builds: no stream, no CUDA device
    guard, CPU tensors accepted."""
    monkeypatch.setattr(launch, "_libs", {})
    monkeypatch.setattr(
        build, "build", lambda: build.BuildResult(emulated_libs, 0.0, ""))
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda *a: type("S", (), {"cuda_stream": None})())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(seed_smem_cuda, "cuda_device",
                        lambda x, what: x.device)
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
                rng=rng)


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
    sectors = torch.zeros(len(rows), dtype=torch.int32)
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs, sectors=sectors)
    assert torch.equal(got, seed_smem.sa_query_torch(di, qbuf, *jobs))
    assert int(got[0].max()) > 112 and int((jobs[2] == 0).sum()) > 0
    # a job with a pattern read at least its window's binary search
    assert bool((sectors[jobs[2] > 0] >= 2).all())
    assert bool((sectors[jobs[2] == 0] == 0).all())


@pytest.mark.parametrize("M", [96, 2], ids=["M96", "M2_overflows"])
def test_round_kernels(world, on_emulation, M):
    """The three rounds at the engine's capacities, and at 2 slots a read,
    where the emissions that find no slot are counted, not lost."""
    di, opt, lens = world["eng"].di, world["opt"], world["lens"]
    qbuf, nf, nr, nvf = world["prep"]
    k1 = seed_smem_cuda.seed_round1(di, qbuf, nf, nr, nvf, lens,
                                    opt.min_seed_len, M)
    _same_round(k1, seed_smem.seed_round1_torch(di, qbuf, nf, nr, nvf, lens,
                                                opt.min_seed_len, M))
    args2 = (di, qbuf, nf, nr, lens, k1[0], k1[1], opt.split_len,
             opt.split_width, opt.min_seed_len, min(M, 16))
    k2 = seed_smem_cuda.seed_round2(*args2)
    _same_round(k2, seed_smem.seed_round2_torch(*args2))
    args3 = (di, qbuf, nf, lens, opt.max_mem_intv, opt.min_seed_len + 1, M)
    k3 = seed_smem_cuda.seed_round3(*args3)
    _same_round(k3, seed_smem.seed_round3_torch(*args3))
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
    lib = seed_smem_cuda._load()
    monkeypatch.setattr(lib, "prmi_window_launch", lambda *a: 9,
                        raising=False)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        seed_smem_cuda.prmi_window(di, z, z)
    assert launch.stats.launches["prmi_window"] == 0
