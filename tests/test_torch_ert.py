"""The port's ERT backend (the k-mer root, ``-Z``) on the CPU against the JAX
package: the root table, the window, the engine's SMEM sets in every memory
mode and a wide case, the Aligner's SAM (single-end and paired-end) and the
CLI's ``index -a ert`` and ``mem -Z``. Tolerance zero: every value is an
integer (ranks, SMEM tuples, SAM bytes)."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwameme_tpu.index.ert import build_kmer_table as j_build_kmer_table
from bwameme_tpu.index.ert import pick_ert_bits as j_pick_ert_bits
from bwameme_tpu.ops.sa_search import DeviceIndex as JaxDeviceIndex
from bwameme_tpu.ops.sa_search import make_search_fns
from bwameme_tpu.seeding.engine import DeviceSeedingEngine as JaxEngine
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch import cli
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.index.device import DeviceIndex, kmer_root
from bwameme_tpu_torch.index.ert import build_kmer_table, pick_ert_bits
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions


GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    """The golden reference and single-end reads, unpacked."""
    d = tmp_path_factory.mktemp("golden_ert")
    for name in ["ref.fa", "reads_se.fq"]:
        with gzip.open(os.path.join(GOLD, name + ".gz"), "rt") as f:
            (d / name).write_text(f.read())
    return d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _code(seed: int, n: int):
    rng = np.random.default_rng(seed)
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[700:800] = code[2700:2800]            # a repeat
    code[4000:4300] = np.tile(code[4000:4030], 10)
    return code


@pytest.fixture(scope="module")
def small():
    code = _code(21, 6000)
    bns = bntseq.BntSeq(l_pac=len(code),
                        contigs=[bntseq.Contig("c", "", 0, len(code), 0)],
                        ambs=[], code=code)
    return build_index(bns, rmi_bits=10)


def _reads(idx, rng, n=14, ln=100):
    """Reads with substitutions, N, both strands, and from the repeats."""
    reads = []
    for t in range(n):
        pos = int(rng.integers(0, idx.l_pac - ln - 30))
        r = idx.text[pos: pos + ln].copy()
        for _ in range(3):
            r[rng.integers(0, ln)] = rng.integers(0, 4)
        if t % 5 == 0:
            r[rng.integers(0, ln)] = 4
        if t % 2:
            r = np.where(r < 4, 3 - r, r)[::-1].astype(np.uint8)
        reads.append(r)
    reads += [idx.text[4000:4100].copy(), idx.text[690:810].copy(),
              np.full(30, 4, np.uint8), idx.text[10:29].copy()]
    return reads


def _tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in sm]
            for sm in lists]


@pytest.mark.parametrize("bits", [2, 5, 8])
def test_kmer_table_equals_jax(small, bits):
    idx = small
    got = build_kmer_table(idx.key_hi, bits)
    want = j_build_kmer_table(idx.key_hi, bits)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    wide = kmer_root(idx.key_hi, bits, True)
    assert wide.dtype == np.int64 and np.array_equal(wide, want)
    for n in (1, 4, 1000, idx.n_sa, 2**31 + 5, 6 * 10**9):
        assert pick_ert_bits(n) == j_pick_ert_bits(n)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_kmer_window_equals_jax(small, wide):
    """The root's window on stored keys and on keys cut to a few bases and
    padded with zeros or ones, as the searches pad them."""
    idx = small
    jd = JaxDeviceIndex.from_host(idx, mode=2, ert_bits=6)
    fns = make_search_fns(jd, root="kmer")
    di = DeviceIndex.from_host(idx, "cpu", mode=2, wide=wide, ert_bits=6)
    kh = idx.key_hi.astype(np.uint32)
    kl = idx.key_lo.astype(np.uint32)
    m = np.uint32(0xFFF00000)
    kh = np.concatenate([kh, kh & m, kh | ~m])
    kl = np.concatenate([kl, np.zeros_like(kl), ~np.zeros_like(kl)])
    wlo, whi = (np.asarray(x) for x in fns["rmi_window"](
        jd, jnp.asarray(kh), jnp.asarray(kl)))
    args = (torch.from_numpy(kh.view(np.int32)),
            torch.from_numpy(kl.view(np.int32)))
    lo, hi = seed_smem.kmer_window_torch(di, *args)
    assert lo.dtype == di.rank_dtype
    assert np.array_equal(lo.numpy(), wlo) and np.array_equal(hi.numpy(), whi)
    assert torch.equal(torch.stack(ss.rmi_window(
        di, ss.words_u32(args[0]), ss.words_u32(args[1]))),
        torch.stack([lo, hi]).long())


@pytest.fixture(scope="module")
def jax_kmer(small):
    idx = small
    eng = JaxEngine(idx, JaxMemOptions(), lanes=64, root="kmer", ert_bits=7)
    reads = _reads(idx, np.random.default_rng(5))
    return reads, _tuples(eng.sorted_smems_batch(reads))


LAYOUTS = [(4, False), (1, False), (2, False), (3, False), (1, True)]


@pytest.mark.parametrize("mode,wide", LAYOUTS,
                         ids=[f"mode{m}{'_wide' if w else ''}"
                              for m, w in LAYOUTS])
def test_ert_engine_equals_jax_and_learned(small, jax_kmer, mode, wide):
    """The port's ERT engine (plain versions) == the JAX engine with the
    k-mer root == the port's learned engine, in every mode and wide."""
    idx = small
    reads, want = jax_kmer
    eng = DeviceSeedingEngine(idx, MemOptions(), device="cpu", mode=mode,
                              wide=wide, root="kmer", ert_bits=7)
    assert (eng.di.mode, eng.di.wide, eng.di.root) == (mode, wide, "kmer")
    assert _tuples(eng.sorted_smems_batch(reads)) == want
    learned = DeviceSeedingEngine(idx, MemOptions(), device="cpu", mode=mode,
                                  wide=wide)
    assert _tuples(learned.sorted_smems_batch(reads)) == want
    flat = eng.sorted_smems_batch_flat(reads)
    assert _tuples(flat.to_lists()) == want


@pytest.mark.parametrize("mode,wide", [(4, False), (2, True)],
                         ids=["mode4", "mode2_wide"])
def test_work_under_one_root_counts_the_other(small, mode, wide):
    """A search under the P-RMI and one under the k-mer root locate the same
    keys, so the root's sectors that one count gives for the other root
    (answer_ids(root=)) are those the other counts itself, round by round.
    The rank rows and text the answers stand on are the same but for the
    one row that a full match of fewer bases than the k-mer stands on: any
    row of its interval, which the root's window may pick otherwise."""
    idx = small
    opt = MemOptions()
    reads = _reads(idx, np.random.default_rng(9))
    engs = [DeviceSeedingEngine(idx, opt, device="cpu", mode=mode, wide=wide,
                                root=root, ert_bits=7)
            for root in ("prmi", "kmer")]
    mat, lens_np, _ = engs[0]._batch_matrix(reads)
    lens = torch.from_numpy(lens_np.astype(np.int32))
    qbuf, nf, nr, nvf = seed_smem.prepare_reads(torch.from_numpy(mat), lens)
    R = len(reads)
    works = []
    for eng in engs:
        di = eng.di
        w = [ss.Work(R, "cpu") for _ in range(3)]
        r1 = seed_smem.seed_round1_torch(di, qbuf, nf, nr, nvf, lens,
                                         opt.min_seed_len, 96, work=w[0])
        seed_smem.seed_round2_torch(di, qbuf, nf, nr, lens, r1[0], r1[1],
                                    opt.split_len, opt.split_width,
                                    opt.min_seed_len, 16, work=w[1])
        seed_smem.seed_round3_torch(di, qbuf, nf, lens, opt.max_mem_intv,
                                    opt.min_seed_len + 1, 96, work=w[2])
        works.append(w)
    for wp, wk in zip(*works):
        for root in (engs[0].di, engs[1].di):
            got, want = wp.answer_ids(root), wk.answer_ids(root)
            assert torch.equal(got[got >= ss.IN_PARAMS],
                               want[want >= ss.IN_PARAMS])
        rows_p, rows_k = (set(w.answer_ids()[w.answer_ids() < ss.IN_PARAMS]
                              .tolist()) for w in (wp, wk))
        assert len(rows_p) > 0 and len(rows_p ^ rows_k) <= len(rows_p) // 100
    rounds1 = works[0][0]
    assert rounds1.answer_sectors() != rounds1.answer_sectors(
        root=engs[1].di)


def test_ert_default_root_size(small):
    """ert_bits=0 takes the size pick_ert_bits gives, as the JAX engine."""
    idx = small
    eng = DeviceSeedingEngine(idx, MemOptions(), device="cpu", root="kmer")
    assert eng.di.kmer_bits == j_pick_ert_bits(idx.n_sa)
    with pytest.raises(ValueError, match="root"):
        DeviceSeedingEngine(idx, MemOptions(), device="cpu", root="fmi")


def _sam_reads(idx, rng, n, ln=120):
    out = []
    for i in range(n):
        pos = int(rng.integers(0, idx.l_pac - ln))
        c = idx.text[pos: pos + ln].copy()
        c[int(rng.integers(0, ln))] = (c[60] + 1) % 4
        out.append(Read(f"r{i}", "".join("ACGTN"[x] for x in c), "I" * ln,
                        None))
    return out


def test_aligner_sam_with_the_kmer_root_equals_learned(small):
    """Single-end and paired-end SAM with the ERT engine == the learned
    engine's, byte for byte."""
    idx = small
    rng = np.random.default_rng(8)
    reads = _sam_reads(idx, rng, 8)
    opt = MemOptions()
    learned = DeviceSeedingEngine(idx, opt, device="cpu")
    ert = DeviceSeedingEngine(idx, opt, device="cpu", root="kmer")
    se = [Aligner(idx, opt, seeding_engine=e, device="cpu").align_batch(reads)
          for e in (learned, ert)]
    assert se[0] == se[1] and len(se[0]) == 8
    pairs = []
    for i in range(6):
        st = int(rng.integers(0, idx.l_pac - 500))
        m1, m2 = idx.text[st: st + 100], idx.text[st + 300: st + 400]
        m2 = (3 - m2[::-1]).astype(np.uint8)
        pairs += [Read(f"p{i}", "".join("ACGT"[x] for x in m), "I" * 100,
                       None) for m in (m1, m2)]
    popt = MemOptions()
    popt.flag |= MEM_F_PE
    pe = [Aligner(idx, popt, seeding_engine=e, device="cpu",
                  pes0=cli.insert_size("300,30")).align_pairs(pairs)
          for e in (DeviceSeedingEngine(idx, popt, device="cpu"),
                    DeviceSeedingEngine(idx, popt, device="cpu",
                                        root="kmer"))]
    assert pe[0] == pe[1] and len(pe[0]) == 12


def test_cli_index_ert_and_mem_Z(golden_dir, tmp_path, monkeypatch, capsys):
    """index -a ert writes the root's table and size; mem -Z reads the size
    and gives the default mem's SAM; -Z with the host engine exits 1, as in
    the JAX package."""
    from bwameme_tpu_torch.seeding import engine as engine_mod

    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    prefix = str(tmp_path / "ref")
    assert cli.main(["index", str(golden_dir / "ref.fa"), "-p", prefix,
                     "-a", "ert"]) == 0
    with np.load(prefix + ".ert.npz") as z:
        bits = int(z["kmer_bits"])
        table = z["kmer_table"]
    from bwameme_tpu_torch.index.build import load_index

    idx = load_index(prefix)
    assert bits == pick_ert_bits(idx.n_sa)
    assert np.array_equal(table, j_build_kmer_table(idx.key_hi, bits))
    made = []

    class Spy(engine_mod.DeviceSeedingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(engine_mod, "DeviceSeedingEngine", Spy)
    fq = tmp_path / "r.fq"
    with open(golden_dir / "reads_se.fq") as f:
        fq.write_text("".join(f.readlines()[:120]))
    outs = {}
    for name, flags in (("default", []), ("Z", ["-Z"]),
                        ("ert", ["--backend", "ert"])):
        out = tmp_path / f"{name}.sam"
        assert cli.main(["mem", prefix, str(fq), "-o", str(out),
                         *flags]) == 0
        outs[name] = [ln for ln in out.read_text().splitlines()
                      if not ln.startswith("@PG")]
    assert outs["Z"] == outs["default"] == outs["ert"]
    assert [e.di.root for e in made] == ["prmi", "kmer", "kmer"]
    assert made[1].di.kmer_bits == bits
    capsys.readouterr()
    assert cli.main(["mem", prefix, str(fq), "-Z", "--engine", "host"]) == 1
    assert "requires the device engine" in capsys.readouterr().err
