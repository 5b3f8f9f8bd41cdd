"""The genome and the copy of wgsim's model: deterministic by seed, and
their parameters come back out of the genome and of 10^5 reads."""

import numpy as np
import pytest

from pbench import genome, wgsim

SPEC = {"generator": "shaped", "seed": 2024,
        "contigs": [["I", 1_200_000], ["II", 790_000], ["M", 10_000]],
        "gc": 0.354,
        "interspersed": {"share": 0.08, "bp_per_family": 20000,
                         "consensus_bp": [150, 3000], "min_copy_bp": 100,
                         "full_length": 0.5, "divergence": [0.02, 0.25]},
        "tandem": {"share": 0.02, "unit_bp": [2, 150],
                   "array_bp": [40, 4000], "divergence": [0.0, 0.1]},
        "duplications": {"share": 0.02, "bp": [1000, 10000]}}
T = {"generator": "wgsim", "paired": True, "read_len": [151, 151],
     "error_rate": 0.02, "mutation_rate": 0.001, "indel_fraction": 0.15,
     "indel_extend": 0.3, "fragment_mean": 500, "fragment_sd": 50}


@pytest.fixture(scope="module")
def g():
    return genome.make_genome(SPEC)


@pytest.fixture(scope="module")
def code(g):
    return g.code


def test_genome_shape(g, tmp_path):
    n = 2_000_000
    assert len(g.code) == n and g.code.max() == 3
    assert g.names == ["I", "II", "M"]
    assert g.offsets.tolist() == [0, 1_200_000, 1_990_000]
    assert (genome.make_genome(SPEC).code == g.code).all()
    assert np.isin(g.code, [1, 2]).mean() == pytest.approx(0.354, abs=0.005)
    # repeats: sorted, disjoint, none across a contig's end, about 12%
    assert (g.rep_start[1:] >= g.rep_end[:-1]).all()
    ends = g.offsets + g.lengths
    k = np.searchsorted(ends, g.rep_start, side="right")
    assert (g.rep_end <= ends[k]).all()
    assert (g.rep_end - g.rep_start).sum() / n == pytest.approx(0.12,
                                                                abs=0.02)
    # each duplication's stretches are equal, base for base, and far apart
    assert len(g.dups)
    for a, b, ln in g.dups:
        assert (g.code[a: a + ln] == g.code[b: b + ln]).all()
        assert abs(int(b) - int(a)) > 2 * ln
    a, b, ln = (int(v) for v in g.dups[0])
    assert g.in_repeat(np.array([a + 5]), np.array([a + 6]))[0]
    row, side = g.dup_of(np.array([b + 50, a + 10, a + 50]),
                         np.array([b + 200, a + 160, a + ln - 41]), 40)
    assert row.tolist() == [0, -1, 0] and side.tolist() == [1, -1, 0]
    # kept once, read back whole
    again = genome.cached(SPEC, str(tmp_path))
    back = genome.cached(SPEC, str(tmp_path))
    assert back.names == g.names and (back.code == g.code).all()
    assert (again.dups == back.dups).all()
    assert genome.key(SPEC) != genome.key(dict(SPEC, seed=1))


def test_deterministic_by_seed(code):
    haps = wgsim.haplotypes(code, T, 2**31 + 7)
    a = wgsim.generate(haps, T, 2**31 + 7, 2, 5000)
    b = wgsim.generate(wgsim.haplotypes(code, T, 2**31 + 7), T, 2**31 + 7, 2,
                       3000)
    assert all((x[:3000] == y).all() for x, y in zip(a.seq, b.seq))
    assert all((x[:3000] == y).all() for x, y in zip(a.lo, b.lo))
    c = wgsim.generate(haps, T, 2**31 + 8, 2, 3000)
    assert not (c.seq[0] == b.seq[0]).all()
    t1 = wgsim.fastq_text(b, 0, 0.02)
    assert t1 == wgsim.fastq_text(b, 0, 0.02)
    lines = t1.split("\n")
    assert lines[0] == "@0000000000" and lines[4] == "@0000000000"
    assert lines[8] == "@0000000001" and len(lines[1]) == 151
    assert set(lines[3]) == {"2"}      # -10 log10(0.02) rounded, + 33


def test_error_rate_and_fragments(code):
    t = dict(T, mutation_rate=0.0)
    haps = wgsim.haplotypes(code, t, 11)
    r = wgsim.generate(haps, t, 11, 2, 50_000)
    err = []
    for m in (0, 1):
        fwd = np.where(r.rev[m][:, None], (3 - r.seq[m])[:, ::-1], r.seq[m])
        ref = code[r.lo[m][:, None] + np.arange(151)]
        assert (r.hi[m] - r.lo[m] == 150).all()
        err.append((fwd != ref).mean())
    assert np.mean(err) == pytest.approx(0.02, abs=0.0005)
    assert (r.rev[0] != r.rev[1]).all() and 0.48 < r.rev[0].mean() < 0.52
    span = np.maximum(r.hi[0], r.hi[1]) - np.minimum(r.lo[0], r.lo[1]) + 1
    assert span.mean() == pytest.approx(500, abs=1.0)
    assert span.std() == pytest.approx(50, abs=1.0)


def test_mutations(code):
    t = dict(T, mutation_rate=0.01)
    subs = indels = dels = del_bases = 0
    for h in wgsim.haplotypes(code, t, 5):
        tr = h.to_ref(np.arange(len(h.codes)))
        step = np.diff(tr)
        inserted = np.concatenate([[False], step == 0])
        ins_runs = np.count_nonzero(inserted[1:] & ~inserted[:-1])
        gaps = step[step > 1] - 1
        dels += len(gaps)
        del_bases += int(gaps.sum())
        indels += ins_runs + len(gaps)
        subs += np.count_nonzero(h.codes[~inserted] != code[tr[~inserted]])
    n = subs + indels
    # each haplotype carries the homozygous third and half of the rest
    assert n == pytest.approx(2 * 0.01 * len(code) * 2 / 3, rel=0.03)
    assert indels / n == pytest.approx(0.15, abs=0.01)
    assert del_bases / dels == pytest.approx(1 / (1 - 0.3), rel=0.05)


def test_no_fragment_across_contigs(g):
    t = dict(T, fragment_mean=5000, fragment_sd=500)
    r = wgsim.generate(wgsim.haplotypes(g.code, t, 3), t, 3, 2, 20_000,
                       g.offsets)
    lo = np.minimum(r.lo[0], r.lo[1])
    hi = np.maximum(r.hi[0], r.hi[1])
    c = np.searchsorted(g.offsets, lo, side="right")
    assert (c == np.searchsorted(g.offsets, hi, side="right")).all()
    # the short last contig gets its reads too
    assert (c == 3).any()
    se = wgsim.generate(wgsim.haplotypes(g.code, T, 3), dict(T, paired=False),
                        3, 2, 100, g.offsets)
    assert len(se.seq) == 1
