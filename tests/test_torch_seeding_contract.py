"""The seeding contract (seeding/host_engine.SeedingEngine) of the port's
four engines on the golden index, on the CPU: each engine's flat finish is
its list finish flattened and its sorted SMEMs; and the rescue rule of the
Aligner, which takes the serial per-pair rescue with a scalar oracle for
an engine and the chunk's batched rescue with any other, on the golden
pairs against the JAX package's Aligner under the same rule."""

import gzip
import os

import pytest
import torch

from bwameme_tpu.index import fmindex as j_fmindex
from bwameme_tpu.index.build import build_from_fasta
from bwameme_tpu.io.fastq import Read as JaxRead
from bwameme_tpu.pipeline import Aligner as JaxAligner
from bwameme_tpu.seeding.fmi_engine import FmiHostEngine as JaxFmiHost
from bwameme_tpu.seeding.host_engine import HostSeedingEngine as JaxHost
from bwameme_tpu.utils.config import MEM_F_PE as JAX_MEM_F_PE
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch.index import fmindex
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.fmi_engine import FmiDeviceEngine, FmiHostEngine
from bwameme_tpu_torch.seeding.host_engine import FlatSmems, HostSeedingEngine
from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions
from bwameme_tpu_torch.utils.timer import TPROF

GOLD = os.path.join(os.path.dirname(__file__), "golden")
# engine -> (whether it is a scalar oracle, the JAX host engine that seeds
# the reference's Aligner)
ENGINES = {
    "host": (True, "learned"),
    "learned": (False, "learned"),
    "fmi_host": (True, "fmi"),
    "fmi": (False, "fmi"),
}
N_READS = 24        # single-end reads for the contract
N_PAIRS = 40        # golden pairs for the rescue rule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fastq(name, n):
    with gzip.open(os.path.join(GOLD, name + ".gz"), "rt") as f:
        lines = f.read().splitlines()
    return [Read(lines[i][1:].split()[0], lines[i + 1], lines[i + 3], None)
            for i in range(0, 4 * n, 4)]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden reference's index (one object for both packages' Aligners,
    as tests/test_torch_pipeline_pe.py shares it), both FM-indexes, the
    first golden single-end reads and the first golden pairs,
    interleaved."""
    path = tmp_path_factory.mktemp("contract") / "ref.fa"
    with gzip.open(os.path.join(GOLD, "ref.fa.gz"), "rt") as f:
        path.write_text(f.read())
    idx = build_from_fasta(str(path))
    fm = fmindex.build_fm_index(idx.bns.code)
    jfm = j_fmindex.build_fm_index(idx.bns.code)
    pairs = [r for p in zip(_fastq("reads_1.fq", N_PAIRS),
                            _fastq("reads_2.fq", N_PAIRS)) for r in p]
    return idx, fm, jfm, _fastq("reads_se.fq", N_READS), pairs


def _engine(name, idx, opt, fm):
    return {
        "host": lambda: HostSeedingEngine(idx, opt),
        "learned": lambda: DeviceSeedingEngine(idx, opt, lanes=32,
                                               device="cpu"),
        "fmi_host": lambda: FmiHostEngine(idx, opt, fm=fm),
        "fmi": lambda: FmiDeviceEngine(idx, opt, fm=fm, device="cpu"),
    }[name]()


def _arrays(flat):
    return [(f, getattr(flat, f).dtype.str, getattr(flat, f).tolist())
            for f in ("off", "start", "end", "sa_lo", "hitcount")]


@pytest.mark.parametrize("name", list(ENGINES))
def test_flat_finish_is_the_list_finish_flattened(golden, name):
    """finish_batch_flat(submit_batch(c)) == FlatSmems.from_lists(
    finish_batch(submit_batch(c))) == sorted_smems_batch(c), dtypes
    included; the attributes the Aligner reads are there."""
    idx, fm, _jfm, reads, _pairs = golden
    opt = MemOptions()
    eng = _engine(name, idx, opt, fm)
    codes = [r.codes for r in Aligner(idx, opt, device="cpu").encode(reads)]
    flat = eng.finish_batch_flat(eng.submit_batch(codes))
    lists = eng.finish_batch(eng.submit_batch(codes))
    assert _arrays(flat) == _arrays(FlatSmems.from_lists(lists))
    assert flat.to_lists() == eng.sorted_smems_batch(codes)
    assert len(lists) == len(reads) and len(flat.start) > len(reads)
    assert eng.scalar_oracle is ENGINES[name][0]
    assert (eng.di is not None) is (name == "learned")
    assert eng.lanes == (32 if name == "learned" else None)
    assert eng.sa_positions is (fm.sa if "fmi" in name else idx.sa)


@pytest.mark.parametrize("name", list(ENGINES))
def test_pe_sam_follows_the_rescue_rule(golden, name):
    """The Aligner's paired-end SAM with each engine == the JAX Aligner's
    over the matching JAX host engine, serial for a scalar oracle and
    batched (``batched_rescue=True``) for a device engine; and the path
    taken is the rule's: the batched rescue's stage runs exactly for the
    device engines."""
    idx, fm, jfm, _reads, pairs = golden
    scalar, seeds = ENGINES[name]
    opt = MemOptions(flag=MemOptions().flag | MEM_F_PE)
    jopt = JaxMemOptions()
    jopt.flag |= JAX_MEM_F_PE
    jeng = (JaxHost(idx, jopt) if seeds == "learned"
            else JaxFmiHost(idx, jopt, fm=jfm))
    want = JaxAligner(idx, jopt, seeding_engine=jeng,
                      batched_rescue=not scalar).align_pairs(
        [JaxRead(r.name, r.seq, r.qual, None) for r in pairs])
    al = Aligner(idx, opt, seeding_engine=_engine(name, idx, opt, fm),
                 device="cpu")
    TPROF.counts.clear()
    got = al.align_pairs(pairs)
    assert got == want
    assert ("pe.rescue" in TPROF.counts) is not scalar
    assert sum(b.split("\t")[1] != "4" for b in got) > N_PAIRS
    assert al.n_processed == len(pairs)
