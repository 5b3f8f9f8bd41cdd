"""The port's single-end pipeline and CLI on the CPU against the JAX package:
the same reads through bwameme_tpu_torch's Aligner (plain PyTorch banded SW)
and bwameme_tpu's Aligner (XLA banded SW), both seeding on the host engine,
must give byte-identical SAM; so must the port's CLI on the golden SE
configs, which the JAX package reproduces byte for byte
(tests/test_golden_sam.py), with the host engine and with the device engine
(the default), and the port's device engine against bwameme_tpu's on the
shared multi-device workload."""

import gzip
import os

import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq
from bwameme_tpu.index.build import build_index
from bwameme_tpu.io.fastq import Read
from bwameme_tpu.pipeline import Aligner as JaxAligner
from bwameme_tpu.utils.config import MemOptions
from bwameme_tpu_torch import cli
from bwameme_tpu_torch.ops import banded_sw_cuda
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine

GOLD = os.path.join(os.path.dirname(__file__), "golden")
SE_CONFIGS = [
    ("se_Y", ["-Y"]),
    ("se_default", []),
    ("se_all", ["-a", "-Y"]),
    ("se_T40", ["-T", "40"]),
    ("se_5", ["-5", "-Y"]),
    ("se_x_intractg", ["-x", "intractg"]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version works on small tensors: one intra-op thread is as
    fast, and does not oversubscribe cores that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name, codes):
    return Read(name, "".join("ACGTN"[c] for c in codes), "I" * len(codes),
                None)


def _mutate(rng, c, n_sub, indel):
    c = c.copy()
    for _ in range(n_sub):
        p = int(rng.integers(0, len(c)))
        c[p] = (c[p] + rng.integers(1, 4)) % 4
    if indel:
        p = int(rng.integers(20, len(c) - 20))
        k = int(rng.integers(1, 4))
        c = (np.concatenate([c[:p], c[p + k:]]) if rng.random() < 0.5 else
             np.concatenate([c[:p], rng.integers(0, 4, k).astype(np.uint8),
                             c[p:]]))
    return c


@pytest.fixture(scope="module")
def genome():
    """Two contigs with planted repeats; reads that map uniquely, to
    repeats, across a chimeric junction, with indels, long deletions and N
    runs, not at all, and long reads whose seeds are re-scored (the
    dataclass path)."""
    rng = np.random.default_rng(2024)
    n0, n1 = 40000, 25000
    code = rng.integers(0, 4, n0 + n1).astype(np.uint8)
    for _ in range(6):
        src = int(rng.integers(0, n0 + n1 - 600))
        dst = int(rng.integers(0, n0 + n1 - 600))
        code[dst: dst + 500] = code[src: src + 500]
    bns = bntseq.BntSeq(
        l_pac=n0 + n1,
        contigs=[bntseq.Contig("chrA", "", 0, n0, 0),
                 bntseq.Contig("chrB", "", n0, n1, 0)],
        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    text = idx.text
    short, long_ = [], []
    for i in range(48):
        ln = 151 if i % 4 else int(rng.integers(90, 151))
        st = int(rng.integers(0, n0 + n1 - ln))
        c = _mutate(rng, text[st: st + ln], int(rng.poisson(1.5)), i % 3 == 0)
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        short.append(_read(f"s{i}", c))
    for i in range(3):  # chimeras: two distant halves
        a, b = (int(x) for x in rng.integers(0, n0 + n1 - 100, 2))
        short.append(_read(f"chim{i}", np.concatenate(
            [text[a: a + 80], text[b: b + 71]])))
    for i in range(2):  # N runs
        st = int(rng.integers(0, n0 + n1 - 151))
        c = text[st: st + 151].copy()
        c[60 + 10 * i: 70 + 10 * i] = 4
        short.append(_read(f"n{i}", c))
    short.append(_read("junk", rng.integers(0, 4, 151).astype(np.uint8)))
    for i, (head, gap) in enumerate(((50, 16), (70, 25), (90, 35), (60, 45))):
        # deletions far off the diagonal: under a narrow band (w=20) their
        # extensions retry at 2w
        st = int(rng.integers(0, n0 - 400))
        short.append(_read(f"del{i}", np.concatenate(
            [text[st: st + head], text[st + head + gap: st + gap + 151]])))
    for i, (g1, g2) in enumerate(((16, 17), (18, 25), (17, 40))):
        # a deletion on each side of the middle seed: its left reruns, so
        # its right reruns at w with the new h0, then may retry at 2w
        st = int(rng.integers(0, n0 - 400))
        short.append(_read(f"ddel{i}", np.concatenate(
            [text[st: st + 45], text[st + 45 + g1: st + 105 + g1],
             text[st + 105 + g1 + g2: st + 151 + g1 + g2]])))
    for i in range(4):
        st = int(rng.integers(0, n0 + n1 - 900))
        c = _mutate(rng, text[st: st + 800], 6, True)
        if i == 0:
            c = np.concatenate([text[st: st + 300], text[st + 390: st + 890]])
        long_.append(_read(f"l{i}", c))
    return idx, short, long_


@pytest.mark.parametrize("kind,w", [("short", 100), ("short", 20),
                                    ("long", 100)],
                         ids=["short", "short_w20", "long"])
def test_aligner_matches_jax(genome, kind, w):
    """Short reads take the port's flat path (coordinate jobs against the
    device text; under w=20 the band-retry ladder runs too), long reads its
    dataclass path (pair form)."""
    idx, short, long_ = genome
    reads = short if kind == "short" else long_
    opt = MemOptions(w=w)
    want = JaxAligner(idx, opt).align_batch(reads)
    got = Aligner(idx, opt, device="cpu").align_batch(reads)
    assert got == want


def test_flat_path_hands_the_kernel_contiguous_tensors(genome, monkeypatch):
    """The CUDA wrapper refuses non-contiguous tensors; the flat path must
    never build one (a column-permuted numpy array is not C-contiguous)."""
    from bwameme_tpu_torch.ops import banded_sw as bsw

    seen = []
    real = bsw.extend_side_round

    def spy(*args, **kw):
        seen.extend(a.is_contiguous() for a in args
                    if isinstance(a, torch.Tensor))
        return real(*args, **kw)

    monkeypatch.setattr(bsw, "extend_side_round", spy)
    idx, short, _ = genome
    Aligner(idx, MemOptions(), device="cpu").align_batch(short[:8])
    assert seen and all(seen)


def test_align_stream_matches_align_batch(genome):
    idx, short, _ = genome
    opt = MemOptions()
    whole = Aligner(idx, opt, device="cpu").align_batch(short)
    batches = [short[i: i + 20] for i in range(0, len(short), 20)]
    streamed = [blk for sam in Aligner(idx, opt, device="cpu").align_stream(
        batches) for blk in sam]
    assert streamed == whole


def test_device_engine_matches_host_engine(genome):
    """Short reads through the port's device engine (flat SMEMs, the
    engine's text on the device): the SAM of the host-engine run; streamed
    batches give the same as one batch. Reads past the learned path's
    500 bp cap are refused, as the reference refuses them."""
    idx, short, long_ = genome
    opt = MemOptions()
    eng = DeviceSeedingEngine(idx, opt, device="cpu")
    dev = Aligner(idx, opt, seeding_engine=eng, device="cpu")
    assert dev.text is eng.di          # one copy of the packed text
    host = Aligner(idx, opt, device="cpu")
    want = host.align_batch(short)
    assert dev.align_batch(short) == want
    batches = [short[i: i + 16] for i in range(0, len(short), 16)]
    dev2 = Aligner(idx, opt, seeding_engine=eng, device="cpu")
    assert [blk for sam in dev2.align_stream(batches) for blk in sam] == want
    with pytest.raises(ValueError, match="ceiling"):
        dev.align_batch(long_[:1])


def test_device_engine_matches_jax_device_engine(par_workload):
    """The shared multi-device workload's single-end reads: the port's
    Aligner over its device engine against bwameme_tpu's Aligner over its
    device engine, byte for byte."""
    from bwameme_tpu.seeding.engine import DeviceSeedingEngine as JaxEngine

    idx, se_reads, _pe = par_workload
    opt = MemOptions()
    want = JaxAligner(idx, opt, seeding_engine=JaxEngine(
        idx, opt, lanes=len(se_reads))).align_batch(se_reads)
    eng = DeviceSeedingEngine(idx, opt, lanes=len(se_reads), device="cpu")
    got = Aligner(idx, opt, seeding_engine=eng,
                  device="cpu").align_batch(se_reads)
    assert got == want


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_torch")
    for name in ["ref.fa", "reads_se.fq"]:
        with gzip.open(os.path.join(GOLD, name + ".gz"), "rt") as f:
            (d / name).write_text(f.read())
    assert cli.main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


@pytest.mark.parametrize("name,flags", SE_CONFIGS,
                         ids=[c[0] for c in SE_CONFIGS])
def test_golden_se_through_port_cli(golden_dir, tmp_path, monkeypatch, name,
                                    flags):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    out = tmp_path / f"{name}.sam"
    rc = cli.main(["mem", "-K", "100000000", *flags, str(golden_dir / "idx"),
                   str(golden_dir / "reads_se.fq"), "--engine", "host",
                   "-o", str(out)])
    assert rc == 0
    got = [ln for ln in out.read_text().splitlines() if not ln.startswith("@")]
    with gzip.open(os.path.join(GOLD, name + ".sam.gz"), "rt") as f:
        assert got == f.read().splitlines()
    # on the CPU the plain version ran: no kernel launch
    assert sum(banded_sw_cuda.stats.launches.values()) == 0


@pytest.mark.parametrize("name,flags", SE_CONFIGS,
                         ids=[c[0] for c in SE_CONFIGS])
def test_golden_se_through_port_cli_device_engine(golden_dir, tmp_path,
                                                  monkeypatch, name, flags):
    """No --engine flag: the default is the device engine; --batch is
    honoured (the reads go through in several batches)."""
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    out = tmp_path / f"{name}.sam"
    rc = cli.main(["mem", "-K", "100000000", *flags, str(golden_dir / "idx"),
                   str(golden_dir / "reads_se.fq"), "--batch", "48",
                   "-o", str(out)])
    assert rc == 0
    got = [ln for ln in out.read_text().splitlines() if not ln.startswith("@")]
    with gzip.open(os.path.join(GOLD, name + ".sam.gz"), "rt") as f:
        assert got == f.read().splitlines()
    assert sum(banded_sw_cuda.stats.launches.values()) == 0


def test_cli_default_engine_is_the_device_engine(golden_dir, tmp_path,
                                                 monkeypatch):
    import bwameme_tpu_torch.seeding.engine as engine_mod

    made = []
    real = engine_mod.DeviceSeedingEngine

    class Spy(real):
        def __init__(self, *a, **kw):
            made.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(engine_mod, "DeviceSeedingEngine", Spy)
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    fq = tmp_path / "two.fq"
    with open(golden_dir / "reads_se.fq") as f:
        fq.write_text("".join(f.readlines()[:8]))
    args = ["mem", str(golden_dir / "idx"), str(fq), "-o",
            str(tmp_path / "o.sam")]
    assert cli.main(args + ["--batch", "7", "--mode", "4"]) == 0
    assert len(made) == 1 and made[0]["lanes"] == 7 and made[0]["mode"] == 4
    assert str(made[0]["device"]) == "cpu"
    assert cli.main(args + ["--engine", "host"]) == 0
    assert len(made) == 1


@pytest.mark.parametrize("flags,msg", [
    (["--engine", "device", "-Z", "--dp-shards", "2"], "Queue 1 item 8"),
    (["--engine", "host", "--backend", "fmi", "--profile", "trace"],
     "--profile"),
    (["--engine", "host", "-Z"], "requires the device engine"),
    (["--engine", "host", "--shards", "2"], "Queue 1 item 8"),
], ids=["dp_shards", "profile", "ert_host", "shards"])
def test_cli_refuses_what_is_not_ported(golden_dir, capsys, flags, msg):
    reads = str(golden_dir / "reads_se.fq")
    rc = cli.main(["mem", str(golden_dir / "idx"), reads, *flags])
    assert rc == 1
    assert msg in capsys.readouterr().err


def test_cli_without_cuda_is_an_error(golden_dir, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("BWAMEME_PLATFORM", raising=False)
    for engine in (["--engine", "host"], []):     # [] = the device engine
        rc = cli.main(["mem", str(golden_dir / "idx"),
                       str(golden_dir / "reads_se.fq"), *engine])
        assert rc == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_cli_index_refuses_what_is_not_ported(golden_dir, capsys):
    """Every index type of the JAX package's CLI is ported (-a mem2, ert and
    all: tests/test_torch_fmi.py and test_torch_ert.py); a type it does not
    have is refused before anything is built."""
    for algo in ("bwt", "mlt"):
        with pytest.raises(SystemExit):
            cli.main(["index", str(golden_dir / "ref.fa"), "-a", algo,
                      "-p", str(golden_dir / "other")])
        assert "invalid choice" in capsys.readouterr().err
    assert not os.path.exists(str(golden_dir / "other.meme"))


def test_cli_device_engine_needs_the_isa(golden_dir, tmp_path, monkeypatch,
                                         capsys):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    prefix = str(tmp_path / "noisa")
    assert cli.main(["index", str(golden_dir / "ref.fa"), "-p", prefix,
                     "--no-isa"]) == 0
    # modes 3 and 4 need it; the default mode of such an index (2 or 1, as
    # the JAX ladder chooses) does not (tests/test_torch_modes.py)
    for mode in ("3", "4"):
        rc = cli.main(["mem", prefix, str(golden_dir / "reads_se.fq"),
                       "--mode", mode])
        assert rc == 1
        assert "inverse suffix array" in capsys.readouterr().err
