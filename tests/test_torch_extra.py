"""The port's library entry points align1 and reg2ovlp
(bwameme_tpu_torch/align/extra.py) on the CPU against the JAX package's
(bwameme_tpu/align/extra.py): one genome made from a numpy seed, indexed by
each package's own build_index, the read of tests/test_extra.py and its
reverse complement, a read with three substitutions, one with an N and a
random read that has no region. The port runs with its default engine (the
host engine) and with its DeviceSeedingEngine on the CPU (the plain
versions); the JAX package with its default engine. Tolerance zero: every
AlnReg field (its chain and the chain's seeds included) and every OvlpHit
equal."""

import dataclasses

import numpy as np
import pytest
import torch

from bwameme_tpu.align.extra import align1 as jax_align1
from bwameme_tpu.align.extra import reg2ovlp as jax_reg2ovlp
from bwameme_tpu.index import bntseq as jax_bntseq
from bwameme_tpu.index.build import build_index as jax_build_index
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch.align.extra import align1, reg2ovlp
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.ops.launch import stats
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.utils.config import MemOptions

N = 20000
POS = 7000


@pytest.fixture(scope="module")
def genome():
    code = np.random.default_rng(9).integers(0, 4, N).astype(np.uint8)

    def index(mod, build):
        bns = mod.BntSeq(l_pac=N, contigs=[mod.Contig("c", "", 0, N, 0)],
                         ambs=[], code=code.copy())
        return build(bns, rmi_bits=11)

    idx = index(bntseq, build_index)
    opt = MemOptions()
    return (index(jax_bntseq, jax_build_index), idx, opt,
            DeviceSeedingEngine(idx, opt, device="cpu"), code)


def _reads(code):
    seq = "".join("ACGT"[c] for c in code[POS: POS + 100])
    rc = "".join("TGCA"["ACGT".find(c)] for c in reversed(seq))
    sub = list(seq)
    for p in (17, 52, 88):
        sub[p] = "ACGT"[("ACGT".find(sub[p]) + 1) % 4]
    with_n = seq[:40] + "N" + seq[41:]
    rng = np.random.default_rng(10)
    junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 100))
    return {"plain": seq, "revcomp": rc, "three_subs": "".join(sub),
            "with_n": with_n, "random": junk}


@pytest.mark.parametrize("engine", ["default", "device"])
@pytest.mark.parametrize("case", ["plain", "revcomp", "three_subs",
                                  "with_n", "random"])
def test_align1_and_reg2ovlp_match_jax(genome, case, engine):
    jidx, idx, opt, dev_eng, code = genome
    seq = _reads(code)[case]
    want = jax_align1(jidx, JaxMemOptions(), seq)
    stats.reset()
    got = align1(idx, opt, seq, engine=None if engine == "default"
                 else dev_eng, device="cpu")
    # on the CPU the plain versions ran: no kernel launch
    assert not any(stats.launches.values())
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    hits = reg2ovlp(idx.bns, len(seq), got)
    assert [dataclasses.asdict(h) for h in hits] == \
        [dataclasses.asdict(h) for h in jax_reg2ovlp(jidx.bns, len(seq),
                                                     want)]
    if case == "random":
        assert got == [] and hits == []
    else:
        # a reverse-strand hit in [l_pac, 2 l_pac) coordinates
        rev = case == "revcomp"
        assert got and hits[0].qe == 100 and hits[0].is_rev == rev
        assert hits[0].rb == (2 * N - POS - 100 if rev else POS)
        assert got[0].score == 100 * opt.a or case != "plain"


def test_align1_runs_on_the_card_unless_asked_for_the_cpu(genome):
    """The default device is CUDA; without a card align1 raises rather than
    move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, idx, opt, _, code = genome
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        align1(idx, opt, _reads(code)["plain"])
