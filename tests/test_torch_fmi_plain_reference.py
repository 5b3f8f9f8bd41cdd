"""The port's FM-index seeding held to the plain SMEM reference
(``portbench/reference/smem.py``: BWA-MEM2's three rounds over a sorted
suffix array, plain torch, nothing of the port): ``FmiHostEngine`` and the
device engine's CPU design (``collect_smems_waves``) give, per read, the
reference's multiset of (start, end, occurrences) and each SMEM's positions,
on a WBcel235-shaped genome of 200 kbp (``portbench/pbench/genome.py``,
repeats on) under wgsim's reads. The reference runs over its own suffix
array and over the learned index's, which sorts the text with its padding."""

import collections
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from pbench import genome as genome_mod  # noqa: E402
from pbench import wgsim  # noqa: E402
from reference import smem  # noqa: E402

from bwameme_tpu_torch.index import bntseq, fmindex  # noqa: E402
from bwameme_tpu_torch.index.build import build_index  # noqa: E402
from bwameme_tpu_torch.seeding.fmi_engine import (FmiDeviceEngine,  # noqa: E402
                                                  FmiHostEngine)
from bwameme_tpu_torch.utils.config import MemOptions  # noqa: E402

N_READS = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(kind, name):
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


class World:
    """The configuration's genome cut to 200 kbp (its generator seed
    replaced), its learned index, FM-index and the references."""

    def __init__(self, seed: int):
        spec = copy.deepcopy(_load("configs", "celegans-fmi")["genome"])
        spec["contigs"] = [["I", 120_000], ["II", 80_000]]
        spec["seed"] = seed
        self.g = g = genome_mod.make_genome(spec)
        code = g.code
        bns = bntseq.BntSeq(
            l_pac=len(code), contigs=[
                bntseq.Contig(nm, "", int(o), int(ln), 0) for nm, o, ln in
                zip(g.names, g.offsets, g.lengths)], ambs=[], code=code)
        self.idx = build_index(bns)
        self.fm = fmindex.build_fm_index(code)
        self.opt = MemOptions()
        ropt = smem.Options(self.opt.min_seed_len, self.opt.split_len,
                            self.opt.split_width, self.opt.max_mem_intv)
        text = smem.forward_rc(code)
        self.refs = [smem.SmemReference(text, smem.suffix_array(text), ropt),
                     smem.SmemReference(self.idx.text, self.idx.sa, ropt,
                                        n=2 * len(code))]

    def wgsim(self, traffic: str, seed: int, units: int) -> list:
        t = _load("traffic", traffic)
        haps = wgsim.haplotypes(self.g.code, t, seed)
        r = wgsim.generate(haps, t, seed, 2, units, self.g.offsets)
        return [r.seq[m][u] for u in range(units) for m in range(len(r.seq))]

    def tandem_arrays(self) -> list:
        """The repeat slots that repeat a unit of 2-150 bases (a base equal
        to the one a unit on in four of five places): the tandem arrays."""
        out = []
        for a, b in zip(self.g.rep_start, self.g.rep_end):
            c = self.g.code[a:b]
            if any(len(c) > 2 * u and (c[u:] == c[:-u]).mean() > 0.8
                   for u in range(2, 151)):
                out.append((int(a), int(b)))
        return out

    def from_spans(self, spans, rng) -> list:
        """151 bp reads inside the [start, end) spans, either strand."""
        text = self.idx.text
        out = []
        for i, (a, b) in enumerate(spans):
            st = a + int(rng.integers(0, max(1, b - a - 151)))
            r = text[st: st + 151].copy()
            out.append((3 - r[::-1]).copy() if i % 2 else r)
        return out


@pytest.fixture(scope="module")
def worlds():
    cache = {}

    def get(seed):
        if seed not in cache:
            cache[seed] = World(seed)
        return cache[seed]
    return get


def _reads(w: World, case: str) -> list:
    rng = np.random.default_rng(len(case))
    if case == "se":
        return w.wgsim("wgsim-se151", 2**31 + 7, N_READS)
    if case == "pe":
        return w.wgsim("wgsim-pe151", 2**31 + 9, N_READS // 2)
    if case == "repeats":
        # interspersed copies and tandem arrays: the repeats' slots
        k = rng.choice(len(w.g.rep_start), N_READS)
        return w.from_spans(zip(w.g.rep_start[k], w.g.rep_end[k]), rng)
    if case == "tandem":
        spans = w.tandem_arrays()
        assert spans
        return w.from_spans([spans[i % len(spans)] for i in range(N_READS)],
                            rng)
    if case == "duplications":
        d = w.g.dups
        assert len(d)
        spans = [(a, a + n) for row in d for a, n in ((row[0], row[2]),
                                                       (row[1], row[2]))]
        return w.from_spans(spans * 2, rng)
    if case == "n_bases":
        reads = w.wgsim("wgsim-se151", 2**31 + 11, N_READS)
        for i, r in enumerate(reads):
            r[rng.integers(0, 151, 1 + i % 3)] = 4
            if i % 4 == 0:
                at = int(rng.integers(0, 140))
                r[at: at + 10] = 4
        return reads
    if case == "text_ends":
        # the text's first bases, its last, and its last run on into T's
        # (which the learned index's padding matches and the text does not)
        n = 2 * w.idx.l_pac
        t = w.idx.text
        return [t[:151].copy(), t[n - 151: n].copy(),
                np.concatenate([t[n - 100: n], np.full(51, 3, np.uint8)]),
                np.concatenate([t[n - 140: n], np.full(11, 3, np.uint8)])]
    raise ValueError(case)


def _triples(lists):
    return [collections.Counter(x[:3] for x in r) for r in lists]


CASES = [("se", 2024), ("pe", 2024), ("repeats", 2024), ("tandem", 2024),
         ("duplications", 2024), ("n_bases", 2024), ("text_ends", 2024),
         ("se", 11), ("repeats", 11)]


@pytest.mark.parametrize("case,genome_seed", CASES,
                         ids=[f"{c}-g{s}" for c, s in CASES])
def test_fm_engines_equal_the_plain_reference(worlds, case, genome_seed):
    w = worlds(genome_seed)
    reads = _reads(w, case)
    host = FmiHostEngine(w.idx, w.opt, fm=w.fm)
    dev = FmiDeviceEngine(w.idx, w.opt, fm=w.fm, device="cpu")
    engines = {
        "host": [[(s.start, s.end, s.hitcount, s.sa_lo) for s in
                  host.collect_smems(r)] for r in reads],
        "waves": [[(s.start, s.end, s.hitcount, s.sa_lo) for s in x]
                  for x in dev.collect_smems_waves(reads)]}
    ref, ref_meme = w.refs
    want = ref.smems(reads)
    assert sum(map(len, want)) >= len(reads)
    assert _triples(ref_meme.smems(reads)) == _triples(want)
    for name, got in engines.items():
        assert _triples(got) == _triples(want), name
        for i, (g, r) in enumerate(zip(got, want)):
            where = {x[:3]: x[3:] for x in r}
            for st, en, s, k in g:
                lo, hi = where[(st, en, s)]
                assert sorted(w.fm.sa[k: k + s].tolist()) == ref.positions(
                    lo, hi, en - st), (name, i, st, en)
    if case in ("repeats", "tandem"):
        assert max(x[2] for r in want for x in r) > 1
    if case == "duplications":
        # each read has a twin: its whole length occurs twice
        assert all(any(x[1] - x[0] == 151 and x[2] >= 2 for x in r)
                   for r in want)


def test_reference_past_the_text_end(worlds):
    """Over the learned index's padded suffix array, a match that runs into
    the padding is no occurrence: the read that runs on from the text's last
    bases into T's sorts among the padded suffixes' block, and is found
    once as far as the text's end and not past it."""
    w = worlds(2024)
    _, ref_meme = w.refs
    pad = w.idx.pad_len
    reads = _reads(w, "text_ends")[2:]
    for r, body, (lo, hi, cnt) in zip(reads, (100, 140),
                                      ref_meme.tables(reads)):
        past = min(len(r), body + pad)
        assert past > body
        assert int(cnt[0, body]) >= 1
        assert int(hi[0, past] - lo[0, past]) >= 1
        assert int(cnt[0, past]) == 0
