"""The learned index in every memory mode (1-4) and width (int32, int64), on
the CPU, against the JAX package, with zero tolerance: the device planes
(its DeviceIndex.from_host of the same layout), the search primitives
(make_search_fns), the SMEM sets (its engine and the port's host oracle),
the mode ladder under a fixed BWAMEME_HBM_BYTES, the analytic periodic index
that the card's jumbo phase builds (against brute force and the JAX
package's test generator), and the CLI's SAM in modes 1-3 and on an index
built without the ISA (byte for byte the mode-4 SAM).

The index is tests/test_wide.py's small one (24 kbp with a tiled repeat,
rmi_bits=10). The JAX search programs are compiled once a layout, for
patterns of 64 bases (compile time grows with the pattern's length): every
head and the first text segment of every layout. The deeper ties of every
layout are held against the kernels on 480-base reads by
tests/test_torch_cuda_emulation.py. As in the JAX package's tests, the
wide compiles of modes 3 and 4 are marked slow."""

import dataclasses
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq
from bwameme_tpu.index.build import build_index
from bwameme_tpu.ops.sa_search import DeviceIndex as JaxDeviceIndex
from bwameme_tpu.ops.sa_search import make_search_fns
from bwameme_tpu.seeding.engine import DeviceSeedingEngine as JaxEngine
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch import bench_util, cli
from bwameme_tpu_torch.index.device import DeviceIndex
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine
from bwameme_tpu_torch.utils.config import MemOptions

GOLD = os.path.join(os.path.dirname(__file__), "golden")
PLAIN = ("text32", "params")
LAYOUTS = [
    pytest.param(m, w, id=f"mode{m}{'_wide' if w else ''}",
                 marks=[pytest.mark.slow] if w and m >= 3 else [])
    for m in (1, 2, 3, 4) for w in (False, True)]
# the same layouts where no JAX program is compiled
ALL_LAYOUTS = [pytest.param(m, w, id=f"mode{m}{'_wide' if w else ''}")
               for m in (1, 2, 3, 4) for w in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """tests/test_wide.py's index and reads (10 of 110 bp, mutated, every
    third reverse-complemented), the 64-base patterns of the search
    comparisons (from the text, from the tiled repeat, whose suffixes tie
    past 64 bases, reverse-complemented, with an N, and random), their jobs
    and the JAX engine, built once."""
    rng = np.random.default_rng(123)
    n = 24000
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[8000:8600] = np.tile(code[8000:8075], 8)  # repeats
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    reads = []
    for i in range(10):
        st = int(rng.integers(0, idx.l_pac - 150))
        c = idx.text[st: st + 110].copy()
        for _ in range(int(rng.integers(0, 3))):
            pp = int(rng.integers(0, 110))
            c[pp] = (c[pp] + rng.integers(1, 4)) % 4
        if i % 3 == 0:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(c)
    pats = []
    for i in range(16):
        st = int(rng.integers(0, 2 * n - 64))
        c = idx.text[st: st + 64].copy()
        if i % 4 == 1:
            c[int(rng.integers(0, 64))] ^= 1
        if i % 4 == 2:
            c[int(rng.integers(0, 64))] = 4
        pats.append(c)
    pats += [idx.text[8000 + 11 * k: 8064 + 11 * k].copy() for k in range(6)]
    pats += [rng.integers(0, 4, 64).astype(np.uint8), np.zeros(64, np.uint8)]
    mat = np.stack(pats)
    qbuf, nf, nr, _ = seed_smem.prepare_reads(
        torch.from_numpy(mat), torch.full((len(pats),), 64))
    R = len(pats)
    rows, pivs, vs = [], [], []
    for i in range(R):
        for _ in range(10):
            p = int(rng.integers(0, 64))
            rev = int(rng.integers(0, 2))
            full = int((nr if rev else nf)[i, p]) - p
            rows.append(i + rev * R)
            pivs.append(p)
            vs.append(full if rng.random() < 0.6
                      else int(rng.integers(0, full + 1)))
    jobs = tuple(np.asarray(a, np.int32) for a in (rows, pivs, vs))
    mi = rng.choice([1, 1, 2, 3, 9, 21, 500], len(rows)).astype(np.int32)
    # the JAX engine's SMEM sets are those of every layout (its own tests):
    # mode 1 wide, rounds driven from the host
    jeng = JaxEngine(idx, JaxMemOptions(), mode=1, wide=True)
    jeng.use_fused = False
    return dict(idx=idx, reads=reads, qbuf=qbuf, jobs=jobs, mi=mi,
                jax_smems=_tuples(jeng.sorted_smems_batch(reads)),
                host_smems=_tuples([HostSeedingEngine(idx, MemOptions())
                                    .sorted_smems(c) for c in reads]))


def _tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in sm]
            for sm in lists]


def _t(a):
    return torch.from_numpy(np.asarray(a)).to(torch.int64)


def _same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g.numpy()), np.asarray(w)
        assert g.shape == w.shape
        assert (g.astype(np.int64) == w.astype(np.int64)).all()


@pytest.mark.parametrize("mode,wide", ALL_LAYOUTS)
def test_planes_equal_jax(small, mode, wide):
    idx = small["idx"]
    jd = JaxDeviceIndex.from_host(idx, mode=mode, wide=wide)
    di = DeviceIndex.from_host(idx, "cpu", mode=mode, wide=wide)
    assert (di.mode, di.wide, di.bits, di.n_sa) == (mode, wide, jd.bits,
                                                    jd.n_sa)
    assert sorted(di.planes) == sorted(
        k for k in ("rk", "sa", "ktext", "key2", "params64", *PLAIN)
        if getattr(jd, k) is not None)
    for name, t in di.planes.items():
        want = np.asarray(getattr(jd, name))
        assert t.numpy().shape == want.shape
        assert t.numpy().tobytes() == want.tobytes(), name
    # the bytes a suffix of the layout, and the wide leaf starts
    per_suffix = ({4: 20, 3: 16, 2: 16, 1: 8} if wide
                  else {4: 16, 3: 12, 2: 12, 1: 4})[mode]
    assert di.nbytes - sum(t.numel() * 4 for t in (di.text32, di.params)) \
        == per_suffix * idx.n_sa + wide * 8 * (di.params.shape[0] + 1)


@pytest.mark.parametrize("mode,wide", LAYOUTS)
def test_search_primitives_equal_jax(small, mode, wide):
    """rmi_window on every stored key and on keys padded as the searches pad
    them, suffix_cmp on ranks inside, beside and past the array,
    find_longest, and sa_query from min_intv 1 up (its widening fixed point
    over the two searches of interval_at): one JAX program a layout."""
    idx, qbuf, mi = small["idx"], small["qbuf"], small["mi"]
    rows, pivs, vs = small["jobs"]
    jd = JaxDeviceIndex.from_host(idx, mode=mode, wide=wide)
    di = DeviceIndex.from_host(idx, "cpu", mode=mode, wide=wide)
    mw = int((idx.rmi_err_lo.astype(np.int64)
              + idx.rmi_err_hi.astype(np.int64)).max())
    raw = make_search_fns(jd, max_read_words=qbuf.shape[1] - 3,
                          max_width=mw)["raw"]
    khi, klo = idx.key_hi.astype(np.uint32), idx.key_lo.astype(np.uint32)
    m = np.uint32(0xFFFFFC00)
    kh = np.concatenate([khi, khi & m, khi | ~m])
    kl = np.concatenate([klo, np.zeros_like(klo), ~np.zeros_like(klo)])
    rng = np.random.default_rng(mode + 10 * wide)
    n = di.n_sa
    sa_idx = rng.integers(0, n, len(rows))
    sa_idx[::9] = -1
    sa_idx[4::9] = n
    sa_idx[7::11] = n + 3
    v1 = np.maximum(vs, 1)
    idt = np.int64 if wide else np.int32

    @jax.jit
    def programs(d, q, r, p, v, v1, s, m, kh, kl):
        f = raw(d)
        return (f["rmi_window"](kh, kl), f["suffix_cmp"](q, r, p, v, s),
                f["find_longest"](q, r, p, v1), f["sa_query"](q, r, p, v, m))

    win, cmp_, longest, query = programs(
        jd, *(jnp.asarray(a) for a in (
            qbuf.numpy().view(np.uint32), rows, pivs, vs, v1,
            sa_idx.astype(idt), mi.astype(idt), kh, kl)))
    _same(ss.rmi_window(di, _t(kh), _t(kl)), win)
    _same(ss.suffix_cmp(di, qbuf, _t(rows), _t(pivs), _t(vs), _t(sa_idx)),
          cmp_)
    _same(ss.find_longest(di, qbuf, _t(rows), _t(pivs), _t(v1)), longest)
    _same(ss.sa_query(di, qbuf, _t(rows), _t(pivs), _t(vs), _t(mi)), query)
    # the storage forms the kernels' wrappers take and give
    got = seed_smem.prmi_window_torch(
        di, *(torch.from_numpy(k.view(np.int32)) for k in (kh, kl)))
    got_q = seed_smem.sa_query_torch(di, qbuf, *(torch.from_numpy(a) for a in
                                                 (rows, pivs, vs, mi)))
    rank = torch.int64 if wide else torch.int32
    assert got[0].dtype == got_q.dtype == rank
    _same(got, win)
    _same(list(got_q), query)
    # the compares reached past every head (ties of all 64 bases), and the
    # widening ran (a job ended shorter than its longest match)
    assert int(np.asarray(longest[0]).max()) == 64
    assert (np.asarray(query[0]) < np.asarray(longest[0])).any()


@pytest.mark.parametrize("mode,wide", ALL_LAYOUTS)
def test_smems_equal_jax_and_host(small, mode, wide):
    """The port's engine (the plain rounds) in the layout: its SMEM sets
    equal the JAX engine's and the host oracle's, through the packed buffer
    (a wide sa_lo rides int64) and through the slot planes."""
    eng = DeviceSeedingEngine(small["idx"], MemOptions(), device="cpu",
                              mode=mode, wide=wide)
    assert (eng.di.mode, eng.di.wide) == (mode, wide)
    flat = eng.sorted_smems_batch_flat(small["reads"])
    assert _tuples(flat.to_lists()) == small["host_smems"]
    assert _tuples(flat.to_lists()) == small["jax_smems"]
    assert _tuples(eng.sorted_smems_batch(small["reads"])) == small[
        "host_smems"]


@pytest.mark.parametrize("hbm", [2_000_000, 900_000, 500_000],
                         ids=["mode4_fits", "mode3_fits", "mode1_only"])
def test_auto_mode_follows_the_jax_ladder(small, monkeypatch, hbm):
    """The mode chosen with no --mode, with and without the ISA, narrow and
    wide, under a fixed device size: the JAX package's choice."""
    idx = small["idx"]
    monkeypatch.setenv("BWAMEME_HBM_BYTES", str(hbm))
    no_isa = dataclasses.replace(idx, isa=None)
    seen = set()
    for index in (idx, no_isa):
        for wide in (False, True):
            jd = JaxDeviceIndex.from_host(index, wide=wide)
            want = (4 if jd.rk is not None else 3 if jd.ktext is not None
                    else 2 if jd.key2 is not None else 1)
            di = DeviceIndex.from_host(index, "cpu", wide=wide)
            assert di.mode == want
            seen.add(want)
    assert seen == {2_000_000: {4, 3, 2}, 900_000: {3, 2},
                    500_000: {1}}[hbm]


def test_periodic_index_equals_bruteforce_and_jax():
    """The analytic index of the card's jumbo phase (bench_util), at a size
    a sort can check: its suffix array equals brute force and the JAX
    package's test generator, its text the generator's; the wide mode-1
    search on it answers the closed form."""
    from test_wide import periodic_index as jax_periodic

    n, p, m = 4096, 64, 16
    di, block, rot = bench_util.periodic_index(n, p, m, seed=5)
    full = np.concatenate([np.tile(block, n // p), np.full(64, 3, np.uint8)])
    brute = sorted(range(n), key=lambda i: tuple(full[i:]))
    assert di.sa.tolist() == brute
    jidx, jrot, _, text = jax_periodic(n, p, m, seed=5)
    assert (di.sa.numpy() == jidx.sa).all() and (rot == jrot).all()
    assert (di.text32.numpy().view(np.uint32) == jidx.text32).all()
    assert (di.mode, di.wide) == (1, True)
    ks = np.arange(p)
    pats = np.stack([np.tile(block, 2)[int(rot[k]): int(rot[k]) + 48]
                     for k in ks])
    qbuf, _, _, _ = seed_smem.prepare_reads(torch.from_numpy(pats),
                                            torch.full((p,), 48))
    got = ss.sa_query(di, qbuf, torch.arange(p), torch.zeros(p, dtype=torch.int64),
                      torch.full((p,), 48), torch.ones(p, dtype=torch.int64))
    want = np.array([bench_util.expected_hit(block, rot, n, p, m, int(k), 48)
                     for k in ks]).T
    assert (np.stack([g.numpy() for g in got]) == want).all()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden SE fixtures indexed twice, with and without the ISA, and
    the mode-4 SAM of the device engine (== the golden se_default SAM)."""
    d = tmp_path_factory.mktemp("golden_modes")
    for name in ("ref.fa", "reads_se.fq"):
        with gzip.open(os.path.join(GOLD, name + ".gz"), "rt") as f:
            (d / name).write_text(f.read())
    assert cli.main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    assert cli.main(["index", str(d / "ref.fa"), "-p", str(d / "noisa"),
                     "--no-isa"]) == 0
    os.environ["BWAMEME_PLATFORM"] = "cpu"
    try:
        assert cli.main(["mem", str(d / "idx"), str(d / "reads_se.fq"),
                         "--mode", "4", "-o", str(d / "m4.sam")]) == 0
    finally:
        del os.environ["BWAMEME_PLATFORM"]
    with gzip.open(os.path.join(GOLD, "se_default.sam.gz"), "rt") as f:
        assert _records(d / "m4.sam") == f.read().splitlines()
    return d


def _records(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@")]


@pytest.mark.parametrize("prefix,flags", [
    ("idx", ["--mode", "1"]), ("idx", ["--mode", "2"]),
    ("idx", ["--mode", "3"]), ("noisa", []), ("noisa", ["--mode", "1"])],
    ids=["mode1", "mode2", "mode3", "no_isa_auto", "no_isa_mode1"])
def test_cli_modes_give_the_mode4_sam(golden, tmp_path, monkeypatch, prefix,
                                      flags):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    out = tmp_path / "o.sam"
    assert cli.main(["mem", str(golden / prefix),
                     str(golden / "reads_se.fq"), *flags, "-o",
                     str(out)]) == 0
    assert _records(out) == _records(golden / "m4.sam")
    sq = [ln for ln in out.read_text().splitlines() if ln.startswith("@SQ")]
    assert sq == [ln for ln in (golden / "m4.sam").read_text().splitlines()
                  if ln.startswith("@SQ")]
