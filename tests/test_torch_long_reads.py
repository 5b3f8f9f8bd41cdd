"""Long reads through the port's device seeding engine on the CPU (the plain
versions): the checks of tests/test_long_reads.py.

The reference's learned path accepts reads up to LEARNED_MAX_READ_LEN=500
(src/macro.h:54) and hard-exits beyond (src/bwamem.cpp:1259-1262). The
port's DeviceSeedingEngine takes the read length as a runtime argument up to
MAX_READ_LEN = 512 (seeding/engine.py; the packed transfer's 10-bit end
coordinates): its SMEMs at 151, 200, 300 and 500 bp equal the host
engine's (and the JAX package's host engine's), a longer read fails with a
clean error before anything runs, and an Aligner over reads of mixed
lengths gives the host engine's SAM, which is the JAX package's. The port
has no length tiers (the JAX engine compiles a program a length bucket), so
test_tier_best_fit_per_batch has no counterpart here. Tolerance zero: SMEMs
are integer tuples, SAM is text.
"""

import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq as jax_bntseq
from bwameme_tpu.index.build import build_index as jax_build_index
from bwameme_tpu.io.fastq import Read as JaxRead
from bwameme_tpu.pipeline import Aligner as JaxAligner
from bwameme_tpu.seeding.host_engine import HostSeedingEngine as JaxHost
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch.align import extend as extend_mod
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine
from bwameme_tpu_torch.utils.config import MemOptions
from bwameme_tpu_torch.utils.timer import TPROF

N = 60000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    code = np.random.default_rng(404).integers(0, 4, N).astype(np.uint8)
    code[20000:20800] = np.tile(code[20000:20100], 8)

    def index(mod, build):
        bns = mod.BntSeq(l_pac=N, contigs=[mod.Contig("c", "", 0, N, 0)],
                         ambs=[], code=code.copy())
        return build(bns, rmi_bits=11)

    idx = index(bntseq, build_index)
    jidx = index(jax_bntseq, jax_build_index)
    opt = MemOptions()
    return (HostSeedingEngine(idx, opt), DeviceSeedingEngine(
        idx, opt, device="cpu"), idx, jidx, np.random.default_rng(405))


def _sample(idx, rng, length, k=6):
    reads = []
    for i in range(k):
        st = int(rng.integers(0, idx.l_pac - length - 1))
        c = idx.text[st: st + length].copy()
        for _ in range(rng.poisson(2)):
            p = int(rng.integers(0, length))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(c)
    return reads


def _tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in sm]
            for sm in lists]


@pytest.mark.parametrize("length", [151, 200, 300, 500])
def test_length_parity(setup, length):
    host_eng, dev_eng, idx, jidx, rng = setup
    reads = _sample(idx, rng, length)
    want = _tuples(host_eng.sorted_smems(c) for c in reads)
    assert _tuples(dev_eng.sorted_smems_batch(reads)) == want
    jax_host = JaxHost(jidx, JaxMemOptions())
    assert _tuples(jax_host.sorted_smems(c) for c in reads) == want


def test_beyond_ceiling_fails_cleanly(setup):
    _, dev_eng, idx, _, rng = setup
    with pytest.raises(ValueError, match="LEARNED_MAX_READ_LEN"):
        dev_eng.sorted_smems_batch(_sample(idx, rng, 600, k=1))


def test_aligner_end_to_end_mixed_lengths(setup):
    """Reads of 151, 320 and 500 bp in one batch through the device engine:
    the host engine's SAM, which is the JAX package's, each read on the
    contig."""
    _, dev_eng, idx, jidx, rng = setup
    reads = []
    for i, L in enumerate([151, 500, 320, 500]):
        st = int(rng.integers(0, idx.l_pac - L - 1))
        c = idx.text[st: st + L].copy()
        for _ in range(rng.poisson(2)):
            p = int(rng.integers(0, L))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        seq = "".join("ACGT"[x] for x in c)
        reads.append(Read(name=f"L{i}", seq=seq, qual="I" * L, comment=None))
    opt = MemOptions()
    sam_dev = Aligner(idx, opt, seeding_engine=dev_eng,
                      device="cpu").align_batch(reads)
    sam_host = Aligner(idx, opt, device="cpu").align_batch(reads)
    assert sam_dev == sam_host
    jax_reads = [JaxRead(r.name, r.seq, r.qual, None) for r in reads]
    assert sam_host == JaxAligner(jidx, JaxMemOptions()).align_batch(
        jax_reads)
    for s in sam_dev:
        assert s.split("\t")[2] == "c"  # mapped to the contig


def test_dataclass_path_hands_over_lists(setup):
    """Reads of 800 bp need their seeds re-scored, so the host engine's
    Aligner takes the dataclass path: extension hands AlnReg lists to the
    single-end finalize, builds no region table (no ``extend.objects``), and
    the SAM is the JAX package's."""
    _, _, idx, jidx, rng = setup
    reads = [Read(name=f"X{i}", seq="".join("ACGT"[x] for x in c),
                  qual="I" * len(c), comment=None)
             for i, c in enumerate(_sample(idx, rng, 800, k=4))]
    opt = MemOptions()
    al = Aligner(idx, opt, device="cpu")
    recs = al.encode(reads)
    assert not extend_mod.rescore_is_noop(opt, [r.codes for r in recs])
    regs = al.regions(recs)
    assert isinstance(regs, list) and all(
        isinstance(a, extend_mod.AlnReg) for r in regs for a in r)
    TPROF.counts.pop("extend.objects", None)
    sam = al.align_batch(reads)
    assert "extend.objects" not in TPROF.counts
    assert al.sam_se(recs, regs, 0) == sam
    jax_reads = [JaxRead(r.name, r.seq, r.qual, None) for r in reads]
    assert sam == JaxAligner(jidx, JaxMemOptions()).align_batch(jax_reads)
    assert all(s.split("\t")[2] == "c" for s in sam)
