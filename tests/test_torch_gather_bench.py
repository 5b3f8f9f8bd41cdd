"""The plain versions of the gather microbenchmarks (K2-K4) against
tools/microbench_pallas_gather.py. Tolerance zero (integer words).

The tool's own ``xla_chain`` and ``xla_while`` are imported (the module reads
its sizes from the environment when it is imported, so the fixture sets them)
and run on the same arrays: a change of the tool's walk shows here. Its numpy
references sit inline in ``main`` between device timings and cannot be
called, so ``_numpy_walk`` repeats lines 276-283 and is itself held against
``xla_chain``; the flat and window references are the tool's one-line
``src[idx]`` and ``np.stack`` of slices. The Pallas kernels themselves are
TPU DMA programs with no interpret mode.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from bwameme_tpu_torch.ops import gather_bench as gb

N, L, K, W = 4096, 257, 16, 16


def _src(width: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 1 << 30, (N, width), dtype=np.int64).astype(
        np.uint32)
    idx = rng.integers(0, N, L).astype(np.int32)
    return src, idx


@pytest.fixture(scope="module")
def tool():
    """tools/microbench_pallas_gather.py imported at this file's sizes."""
    sizes = {"MB_N": N, "MB_L": L, "MB_K": K - 1, "MB_W": W}
    old = {k: os.environ.get(k) for k in sizes}
    os.environ.update({k: str(v) for k, v in sizes.items()})
    try:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "microbench_pallas_gather.py")
        spec = importlib.util.spec_from_file_location(
            "microbench_pallas_gather_small", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert (mod.N, mod.L, mod.K, mod.W) == (N, L, K - 1, W)
    return mod


def _t(src, idx):
    return (torch.from_numpy(src.view(np.int32)), torch.from_numpy(idx))


@pytest.mark.parametrize("width", [4, 128])
def test_gather_flat(width):
    src, idx = _src(width)
    got = gb.gather_flat(*_t(src, idx))
    assert got.shape == (L, width)
    assert (got.numpy().view(np.uint32) == src[idx]).all()


@pytest.mark.parametrize("width", [4, 128])
def test_gather_window(width):
    src, idx = _src(width)
    idxw = np.minimum(idx, N - W)
    got = gb.gather_window(*_t(src, idxw), W)
    want = np.stack([src[i: i + W] for i in idxw])
    assert got.shape == (L, W, width)
    assert (got.numpy().view(np.uint32) == want).all()


def _numpy_walk(src, idx, rounds):
    # tools/microbench_pallas_gather.py:276-283 (int32 wrap)
    s0 = src[:, 0].astype(np.int32)
    x = idx.astype(np.int32)
    with np.errstate(over="ignore"):
        for _ in range(rounds):
            rows = s0[x]
            x = ((rows ^ (x << np.int32(1))) % np.int32(N)).astype(np.int32)
            x = np.where(x < 0, x + N, x)
    return x


@pytest.mark.parametrize("width", [4, 128])
def test_gather_chain(width):
    src, idx = _src(width)
    got = gb.gather_chain(*_t(src, idx), K - 1)
    assert got.dtype == torch.int32
    assert (got.numpy() == _numpy_walk(src, idx, K - 1)).all()


def test_chain_wraps_like_int32():
    """Values with the top bits set: x << 1 overflows int32 and the xor goes
    negative, so the modulo's sign handling shows."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, 1 << 32, (N, 4), dtype=np.int64).astype(np.uint32)
    idx = rng.integers(0, N, L).astype(np.int32)
    got = gb.gather_chain(*_t(src, idx), 5)
    want = _numpy_walk(src, idx, 5)
    assert (got.numpy() == want).all() and (want >= 0).all()


@pytest.mark.parametrize("fn", ["xla_chain", "xla_while"])
@pytest.mark.parametrize("top_bits", [False, True])
def test_gather_chain_is_the_tools_walk(tool, fn, top_bits):
    """K - 1 rounds against the tool's own jitted walks on the same arrays,
    and the copied numpy emulation against them too. With ``top_bits`` the
    words use all 32 bits, so x << 1 wraps and the xor goes negative."""
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    src = rng.integers(0, 1 << (32 if top_bits else 30), (N, 4),
                       dtype=np.int64).astype(np.uint32)
    idx = rng.integers(0, N, L).astype(np.int32)
    want = np.asarray(getattr(tool, fn)(jnp.asarray(src), jnp.asarray(idx)))
    got = gb.gather_chain(*_t(src, idx), K - 1)
    assert (got.numpy() == want).all()
    assert (_numpy_walk(src, idx, K - 1) == want).all()


def test_one_round_is_xla_chains_update():
    """One round against xla_chain's rule (tools/microbench_pallas_gather.py
    :61-67) written in jax.numpy: take, xor with x << 1, modulo N."""
    import jax.numpy as jnp

    src, idx = _src(4, seed=3)
    rows = jnp.take(jnp.asarray(src), jnp.asarray(idx), axis=0, mode="clip")
    want = (rows[:, 0].astype(jnp.int32) ^ (jnp.asarray(idx) << 1)) % N
    got = gb.gather_chain(*_t(src, idx), 1)
    assert (got.numpy() == np.asarray(want)).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    src, idx = _t(*_src(4))
    with pytest.raises(TypeError):
        gb._check_args(src.long(), idx)
    with pytest.raises(ValueError):
        gb._check_args(src.t(), idx)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        gb.gather_flat(src.to("meta"), idx.to("meta"))


def test_kernel_bench_times_the_smokes_shapes():
    """kernel_bench.py states chip_smoke.py's shapes itself (a module of the
    package does not import the script above it): the two must agree."""
    import chip_smoke
    from bwameme_tpu_torch import kernel_bench

    for name in ("BATCH", "GATHER_BYTES", "PAIRS_SHAPE", "LONG_PAIRS_SHAPE",
                 "COORD_SHAPE"):
        assert getattr(kernel_bench, name) == getattr(chip_smoke, name), name
