"""The port's FM-index backend (``--backend fmi``) on the CPU against the JAX
package: the index's planes and files, the search primitives, the device
engine's SMEMs (the wave design, the plain versions) against the JAX host
and device engines, the Aligner's SAM (single-end and paired-end) and the
CLI's ``index -a mem2|all`` and ``mem --backend fmi``. Tolerance zero:
every value is an integer."""

import dataclasses
import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwameme_tpu.index import fmindex as j_fmindex
from bwameme_tpu.ops.fmi_search import DeviceFmIndex as JaxDeviceFmIndex
from bwameme_tpu.ops.fmi_search import make_fmi_fns
from bwameme_tpu.seeding.fmi_engine import FmiDeviceEngine as JaxFmiDevice
from bwameme_tpu.seeding.fmi_engine import FmiHostEngine as JaxFmiHost
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch import cli
from bwameme_tpu_torch.index import bntseq, fmindex
from bwameme_tpu_torch.index.build import build_index, load_index
from bwameme_tpu_torch.index.fmi_store import save_fm_index as save_fast
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.ops import fmi_search
from bwameme_tpu_torch.ops.fmi_search import DeviceFmIndex
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.fmi_engine import (FmiDeviceEngine,
                                                  FmiHostEngine, FmiWork)
from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions

GOLD = os.path.join(os.path.dirname(__file__), "golden")
FM_ARRAYS = ("count", "bwt", "cp_count", "cp_bits", "sa", "sa_ms_byte",
             "sa_ls_word")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(11)
    n = 3000
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[500:560] = code[1500:1560]              # a repeat
    code[2000:2200] = np.tile(code[2000:2020], 10)
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    return idx, fmindex.build_fm_index(code), j_fmindex.build_fm_index(code)


def _opt(cls):
    opt = cls()
    opt.min_seed_len = 12
    opt.max_mem_intv = 20
    return opt


def _reads(idx, rng):
    """Reads with N, mutations, both strands and from the repeats."""
    code = idx.bns.code
    reads = []
    for t in range(10):
        pos = int(rng.integers(0, len(code) - 120))
        r = code[pos: pos + 80].copy()
        for _ in range(2):
            r[rng.integers(0, 80)] = rng.integers(0, 4)
        if t % 4 == 0:
            r[rng.integers(0, 80)] = 4
        if t % 3 == 1:
            r = np.where(r < 4, 3 - r, r)[::-1].astype(np.uint8)
        reads.append(r)
    return reads + [code[2000:2100].copy(), code[490:570].copy(),
                    np.full(20, 4, np.uint8), code[7:20].copy()]


def _tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in sm]
            for sm in lists]


def test_fm_planes_equal_jax(small):
    _idx, fm, jfm = small
    assert (fm.n, fm.sentinel_index) == (jfm.n, jfm.sentinel_index)
    for name in FM_ARRAYS:
        a, b = getattr(fm, name), getattr(jfm, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for b in range(4):
        assert np.array_equal(fm.occ_ranks[b], jfm.occ_ranks[b])


def test_fm_files_round_trip(small, tmp_path):
    """save/load (the copy's compressed npz and the fast uncompressed one,
    read by both packages) and the reference .bwt.2bit.64 both ways."""
    _idx, fm, _jfm = small
    for save, name in ((fmindex.save_fm_index, "c"), (save_fast, "f")):
        prefix = str(tmp_path / name)
        save(prefix, fm)
        for load in (fmindex.load_fm_index, j_fmindex.load_fm_index):
            back = load(prefix)
            assert (back.n, back.sentinel_index) == (fm.n, fm.sentinel_index)
            for arr in FM_ARRAYS:
                assert np.array_equal(getattr(back, arr), getattr(fm, arr))
    prefix = str(tmp_path / "ref")
    fmindex.write_bwt_2bit_64(fm, prefix)
    j_fmindex.write_bwt_2bit_64(fm, str(tmp_path / "jref"))
    assert (open(prefix + ".bwt.2bit.64", "rb").read()
            == open(str(tmp_path / "jref") + ".bwt.2bit.64", "rb").read())
    back = fmindex.read_bwt_2bit_64(prefix)
    for arr in FM_ARRAYS:
        assert np.array_equal(getattr(back, arr), getattr(fm, arr))


def test_device_blocks_decode_to_the_host_planes(small):
    """DeviceFmIndex holds one 32-byte record a 64-base block, 32-byte
    aligned: its four int32 checkpoint counts, then its codes as two
    64-bit planes, H the high bit and L the low bit, bit o for base o.
    Every record gives back the host index's cp_count and one-hot cp_bits
    exactly. Code 0 stands where the one-hot bitmaps have no bit, the
    sentinel's slot and the last block's slots past the BWT's end; decoded,
    both are no base."""
    _idx, fm, _jfm = small
    dfm = DeviceFmIndex.from_host(fm, "cpu")
    nb = fm.cp_count.shape[0]
    rec = dfm.blocks.numpy()
    assert rec.shape == (nb, 8) and dfm.blocks.data_ptr() % 32 == 0
    assert dfm.nbytes == 4 * (5 + 8 * nb + len(fm.sa_ls_word))
    assert np.array_equal(rec[:, :4], fm.cp_count)
    planes = rec[:, 4:].copy().view("<u8")               # (nb, 2): H, L
    bits = (planes[:, :, None] >> np.arange(64, dtype=np.uint64)) & 1
    code = (2 * bits[:, 0] + bits[:, 1]).reshape(-1)
    pos = np.arange(nb * 64)
    none = (pos > fm.n) | (pos == fm.sentinel_index)
    assert (pos > fm.n).any() and (code[none] == 0).all()
    assert np.array_equal(code[~none], fm.bwt[~none[: fm.n + 1]])
    onehot = (code == np.arange(4)[:, None]) & ~none     # (4, nb * 64)
    weights = np.uint64(1) << np.arange(31, -1, -1, dtype=np.uint64)
    words = (onehot.reshape(4, nb, 2, 32) * weights).sum(-1)
    assert np.array_equal(words.astype(np.uint32).transpose(1, 0, 2),
                          fm.cp_bits)


def test_primitives_equal_jax(small):
    """occ, backward_ext, forward_ext, init_intv and sa_lookup of the plain
    versions against bwameme_tpu/ops/fmi_search.py on the same inputs."""
    _idx, fm, _jfm = small
    rng = np.random.default_rng(3)
    jd = JaxDeviceFmIndex.from_host(fm)
    fns = make_fmi_fns(jd)
    dfm = DeviceFmIndex.from_host(fm, "cpu")
    B, n1 = 512, fm.n + 1
    k = rng.integers(0, n1, B)
    s = np.minimum(rng.integers(0, 80, B), n1 - k)
    l = rng.integers(0, n1, B)
    a = rng.integers(0, 4, B)
    t = [torch.from_numpy(x) for x in (k, l, s, a)]
    j = [jnp.asarray(x.astype(np.int32)) for x in (k, l, s, a)]
    p = torch.from_numpy(rng.integers(0, n1 + 1, B))
    for b in range(4):
        assert np.array_equal(
            dfm.occ(b, p).numpy(),
            np.asarray(fns["occ"](jd, jnp.int32(b), jnp.asarray(
                p.numpy().astype(np.int32)))))
    for name in ("backward_ext", "forward_ext"):
        got = getattr(dfm, name)(*t)
        want = fns[name](jd, *j)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), name
    got = fmi_search.backward_ext(dfm, *(x.to(torch.int32) for x in t))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.stack(
        [np.asarray(w) for w in fns["backward_ext"](jd, *j)]))
    for g, w in zip(dfm.init_intv(t[3]), fns["init_intv"](jd, j[3])):
        assert np.array_equal(g.numpy(), np.asarray(w))
    ranks = rng.integers(0, n1, 700)
    steps = torch.zeros(700, dtype=torch.int64)
    got = fmi_search.sa_lookup_torch(dfm, torch.from_numpy(ranks), steps)
    assert np.array_equal(got.numpy(), np.asarray(
        fns["sa_lookup"](jd, jnp.asarray(ranks.astype(np.int32)))))
    assert np.array_equal(got.numpy(), fm.sa[ranks])
    assert int(steps.max()) > 0 and int(steps[ranks % 8 == 0].max()) == 0


def test_the_fm_text_stays_below_2_31(small):
    _idx, fm, _jfm = small
    with pytest.raises(ValueError, match="2\\^31"):
        DeviceFmIndex.from_host(dataclasses.replace(fm, n=2**31 - 1), "cpu")


def test_engines_equal_jax_host_and_device(small):
    """The port's FmiHostEngine == the JAX one in emission order; the port's
    device engine on the CPU (the wave design over the plain versions) ==
    the JAX FmiHostEngine and FmiDeviceEngine, sorted."""
    idx, fm, jfm = small
    reads = _reads(idx, np.random.default_rng(4))
    jhost = JaxFmiHost(idx, _opt(JaxMemOptions), fm=jfm)
    want_raw = [_tuples([jhost.collect_smems(r)])[0] for r in reads]
    host = FmiHostEngine(idx, _opt(MemOptions), fm=fm)
    assert [_tuples([host.collect_smems(r)])[0] for r in reads] == want_raw
    want = _tuples(jhost.sorted_smems_batch(reads))
    jdev = JaxFmiDevice(idx, _opt(JaxMemOptions), fm=jfm, lanes=256)
    assert _tuples(jdev.sorted_smems_batch(reads)) == want
    eng = FmiDeviceEngine(idx, _opt(MemOptions), fm=fm, device="cpu")
    work = FmiWork(len(reads))
    waves = eng.collect_smems_waves(reads, work)
    assert [sorted(x) for x in _tuples(waves)] == [sorted(x) for x in want]
    assert _tuples(eng.sorted_smems_batch(reads)) == want
    assert _tuples(eng.sorted_smems_batch_flat(reads).to_lists()) == want
    assert sum(map(len, want)) > 20
    # what the search needs: a wave a step of each read that extends, the
    # distinct occ blocks of every extension
    assert work.extensions > int(work.waves.sum()) > 0
    assert 0 < work.sectors() <= 3 * work.extensions


def test_fmi_and_learned_seed_the_same_hits(small):
    """FM-index and learned SMEMs agree on (start, end, hitcount) and on the
    hits' positions, each read through its own suffix array."""
    idx, fm, _jfm = small
    reads = _reads(idx, np.random.default_rng(6))
    opt = _opt(MemOptions)
    fmi = FmiDeviceEngine(idx, opt, fm=fm, device="cpu")
    learned = DeviceSeedingEngine(idx, opt, device="cpu")
    for a, b in zip(learned.sorted_smems_batch(reads),
                    fmi.sorted_smems_batch(reads)):
        assert [(s.start, s.end, s.hitcount) for s in a] == [
            (s.start, s.end, s.hitcount) for s in b]
        for x, y in zip(a, b):
            assert sorted(idx.sa[x.sa_lo: x.sa_lo + x.hitcount]) == sorted(
                fm.sa[y.sa_lo: y.sa_lo + y.hitcount])


def test_aligner_sam_with_the_fm_index_equals_learned(small):
    """Single-end and paired-end SAM with both FM-index engines == the
    learned engine's, byte for byte."""
    idx, fm, _jfm = small
    rng = np.random.default_rng(8)
    reads = []
    for i in range(8):
        pos = int(rng.integers(0, idx.l_pac - 120))
        c = idx.text[pos: pos + 120].copy()
        c[int(rng.integers(0, 120))] = (c[60] + 1) % 4
        reads.append(Read(f"r{i}", "".join("ACGT"[x] for x in c), "I" * 120,
                          None))
    opt = MemOptions()
    engines = (DeviceSeedingEngine(idx, opt, device="cpu"),
               FmiDeviceEngine(idx, opt, fm=fm, device="cpu"),
               FmiHostEngine(idx, opt, fm=fm))
    se = [Aligner(idx, opt, seeding_engine=e, device="cpu").align_batch(reads)
          for e in engines]
    assert se[0] == se[1] == se[2]
    pairs = []
    for i in range(6):
        st = int(rng.integers(0, idx.l_pac - 500))
        m2 = (3 - idx.text[st + 300: st + 400][::-1]).astype(np.uint8)
        pairs += [Read(f"p{i}", "".join("ACGT"[x] for x in m), "I" * 100,
                       None) for m in (idx.text[st: st + 100], m2)]
    popt = MemOptions()
    popt.flag |= MEM_F_PE
    pe = [Aligner(idx, popt, seeding_engine=e, device="cpu",
                  pes0=cli.insert_size("300,30")).align_pairs(pairs)
          for e in (DeviceSeedingEngine(idx, popt, device="cpu"),
                    FmiDeviceEngine(idx, popt, fm=fm, device="cpu"),
                    FmiHostEngine(idx, popt, fm=fm))]
    assert pe[0] == pe[1] == pe[2] and len(pe[0]) == 12


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_fmi")
    for name in ["ref.fa", "reads_se.fq", "reads_1.fq", "reads_2.fq"]:
        with gzip.open(os.path.join(GOLD, name + ".gz"), "rt") as f:
            lines = f.read().splitlines(keepends=True)
        (d / name).write_text("".join(lines if name == "ref.fa"
                                      else lines[:160]))
    return d


def _records(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@PG")]


def test_cli_index_mem2_and_mem_backend_fmi(golden, tmp_path, monkeypatch):
    """index -a mem2 / all write the FM-index files (as the JAX package's
    CLI does) and the ERT root; mem --backend fmi, with the device engine
    and the host engine, from the .fmi.npz, from the reference
    .bwt.2bit.64 alone and built at load, gives the default mem's SAM, SE
    and PE."""
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    prefix = str(tmp_path / "ref")
    assert cli.main(["index", str(golden / "ref.fa"), "-p", prefix, "-a",
                     "all"]) == 0
    for ext in (".fmi.npz", ".bwt.2bit.64", ".ert.npz"):
        assert os.path.exists(prefix + ext)
    jfm = j_fmindex.load_fm_index(prefix)
    want = j_fmindex.build_fm_index(load_index(prefix).bns.code)
    for name in FM_ARRAYS:
        assert np.array_equal(getattr(jfm, name), getattr(want, name))
    other = str(tmp_path / "m2")
    assert cli.main(["index", str(golden / "ref.fa"), "-p", other, "-a",
                     "mem2"]) == 0
    assert not os.path.exists(other + ".ert.npz")
    assert os.path.exists(other + ".fmi.npz")

    def mem(tag, reads, *flags):
        out = tmp_path / f"{tag}.sam"
        assert cli.main(["mem", prefix, *reads, "-o", str(out),
                         *flags]) == 0
        return _records(out)

    for reads in ([str(golden / "reads_se.fq")],
                  [str(golden / "reads_1.fq"), str(golden / "reads_2.fq")]):
        tag = str(len(reads))
        base = mem(tag + "learned", reads)
        assert len(base) >= 40
        assert mem(tag + "fmi", reads, "--backend", "fmi") == base
        assert mem(tag + "fmihost", reads, "--backend", "fmi", "--engine",
                   "host") == base
    os.remove(prefix + ".fmi.npz")       # the reference format alone
    assert mem("bwt", [str(golden / "reads_se.fq")], "--backend",
               "fmi") == mem("b0", [str(golden / "reads_se.fq")])
    os.remove(prefix + ".bwt.2bit.64")   # neither: built at load
    assert mem("none", [str(golden / "reads_se.fq")], "--backend",
               "fmi") == mem("b1", [str(golden / "reads_se.fq")])
