"""The port's full (unbanded) Smith-Waterman for mate rescue, plain version,
on the CPU: the same numpy inputs through bwameme_tpu's XLA program
(ops/sw_full.full_sw_batch, align_batch) and the port's plain PyTorch
version, all outputs equal (tolerance zero), and both against the scalar
ksw_align2 contract (align/sw_scalar.sw_align). The kernel's own tests are
in tests/test_torch_cuda_emulation.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwameme_tpu.ops import sw_full as jsw
from bwameme_tpu_torch.align.sw_scalar import sw_align
from bwameme_tpu_torch.index.packing import pack_words
from bwameme_tpu_torch.ops import sw_full as tsw
from bwameme_tpu_torch.utils.config import MemOptions

OPT = MemOptions()
GAPS = (OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins)
FWD_KEYS = ("score", "te", "qe", "score2", "te2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rescue_pairs(rng, n, qmax=100, tmax=300):
    """Queries cut from their target with a few substitutions, as a mate
    rescue finds them (tests/test_sw_full.py's generator); every third
    target holds its query's source twice (a second hit for score2)."""
    pairs = []
    for i in range(n):
        t = rng.integers(0, 4, int(rng.integers(50, tmax))).astype(np.int32)
        st = int(rng.integers(0, max(1, len(t) - qmax)))
        q = t[st: st + int(rng.integers(20, qmax))].copy()
        if i % 3 == 0:
            t = np.concatenate([t, t[st: st + len(q)]])
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, len(q)))
            q[p] = (q[p] + rng.integers(1, 4)) % 4
        pairs.append((q, t))
    return pairs


def edge_pairs(case: str):
    """Inputs a lane-parallel kernel can get wrong, as (query, target)."""
    rng = np.random.default_rng(len(case))
    if case == "row_max_ties":
        # two letters, unit costs (below): rows whose maximum several
        # columns share, and targets that repeat the query
        out = []
        for _ in range(24):
            q = rng.integers(0, 2, int(rng.integers(2, 90))).astype(np.int32)
            t = np.tile(q, 3)[: int(rng.integers(2, 200))]
            out.append((q, np.where(rng.random(len(t)) < 0.1, 1 - t, t)))
        return out
    if case == "qlen_1":
        return [(np.array([c], np.int32),
                 rng.integers(0, 5, int(rng.integers(1, 40))).astype(np.int32))
                for c in (0, 1, 2, 3, 4, 2)]
    if case == "all_n":
        return [(np.full(n, 4, np.int32),
                 rng.integers(0, 4, 80).astype(np.int32)) for n in (1, 30, 70)
                ] + [(rng.integers(0, 4, 40).astype(np.int32),
                      np.full(50, 4, np.int32))]
    if case == "t_shorter_than_q":
        out = []
        for _ in range(12):
            q = rng.integers(0, 4, int(rng.integers(40, 151))).astype(np.int32)
            st = int(rng.integers(0, 20))
            out.append((q, q[st: st + int(rng.integers(1, 30))].copy()))
        return out
    if case == "q_past_64":
        return rescue_pairs(rng, 10, qmax=200, tmax=600)
    raise ValueError(case)


EDGE_CASES = ("row_max_ties", "qlen_1", "all_n", "t_shorter_than_q",
              "q_past_64")


def _padded(pairs):
    Q = max(len(q) for q, _ in pairs)
    T = max(len(t) for _, t in pairs)
    B = len(pairs)
    q = np.zeros((B, Q), np.int32)
    t = np.zeros((B, T), np.int32)
    for b, (qq, tt) in enumerate(pairs):
        q[b, : len(qq)] = np.minimum(qq, 4)
        t[b, : len(tt)] = np.minimum(tt, 4)
    qlen = np.array([len(x) for x, _ in pairs], np.int32)
    tlen = np.array([len(x) for _, x in pairs], np.int32)
    return q, t, qlen, tlen


def _opt(case):
    return (MemOptions(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1)
            if case == "row_max_ties" else OPT)


@pytest.mark.parametrize("case", ("rescue",) + EDGE_CASES)
def test_forward_pass_matches_jax(case):
    """full_sw_batch, the forward pass, on the same padded arrays."""
    pairs = (rescue_pairs(np.random.default_rng(1), 40) if case == "rescue"
             else edge_pairs(case))
    opt = _opt(case)
    q, t, qlen, tlen = _padded(pairs)
    ms = np.full(len(pairs), 19 if case == "rescue" else 3, np.int32)
    mat = opt.mat.astype(np.int32)
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    want = jsw.full_sw_batch(*[jnp.asarray(a) for a in (q, t, qlen, tlen, mat,
                                                        ms)], *gaps)
    got = tsw.full_sw_batch(*[torch.from_numpy(a) for a in (q, t, qlen, tlen,
                                                            mat, ms)], *gaps)
    for k in FWD_KEYS:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    if case in ("rescue", "row_max_ties", "q_past_64"):
        assert int(got["score2"].max()) > 0


@pytest.mark.parametrize("case", ("rescue",) + EDGE_CASES)
def test_align_batch_matches_jax_and_the_scalar_contract(case):
    """align_batch with the reverse pass: the port's == bwameme_tpu's ==
    sw_scalar.sw_align (xtra_start), every key of every job."""
    pairs = (rescue_pairs(np.random.default_rng(2), 25) if case == "rescue"
             else edge_pairs(case))
    opt = _opt(case)
    args = (opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    got = tsw.align_batch(pairs, *args, min_sc=19, device="cpu")
    assert got == jsw.align_batch(pairs, *args, min_sc=19)
    for (q, t), g in zip(pairs, got):
        ref = sw_align(np.minimum(q, 4), np.minimum(t, 4), *args,
                       xtra_start=True, min_sc=19)
        assert (g["score"], g["te"], g["qe"], g["score2"]) == (
            ref.score, ref.te, ref.qe, ref.score2)
        if g["score"] > 0:
            assert (g["tb"], g["qb"]) == (ref.tb, ref.qb)


def test_without_start_and_empty_jobs():
    """with_start=False leaves tb = qb = -1; empty queries and targets give
    the empty result, as the JAX program does."""
    rng = np.random.default_rng(3)
    pairs = rescue_pairs(rng, 6) + [
        (np.zeros(0, np.int32), rng.integers(0, 4, 30).astype(np.int32)),
        (rng.integers(0, 4, 30).astype(np.int32), np.zeros(0, np.int32))]
    args = (OPT.mat, *GAPS)
    got = tsw.align_batch(pairs, *args, with_start=False, device="cpu")
    want = jsw.align_batch(pairs, *args, with_start=False)
    assert got == want
    assert all(g["tb"] == g["qb"] == -1 for g in got)
    assert got[-1] == got[-2] == dict(score=0, te=-1, qe=-1, score2=0,
                                      te2=-1, tb=-1, qb=-1)


def test_coordinate_form_equals_the_pair_form():
    """align_coord reads each target from the packed text (both strands'
    words, as the device index holds them) by (start, length): the result of
    align_batch on the same bytes."""
    rng = np.random.default_rng(4)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    text32 = torch.from_numpy(np.concatenate(
        [pack_words(text, pad_code=3),
         np.full(4, 0xFFFFFFFF, np.uint32)]).view(np.int32))
    starts = rng.integers(0, 4400, 30)
    lens = rng.integers(1, 600, 30)
    lens[:3] = (1, 16, 17)
    queries = []
    for s, n in zip(starts, lens):
        c = text[s + n // 3: s + n // 3 + 100].copy()
        c[rng.integers(0, len(c), 3)] = rng.integers(0, 5, 3)
        queries.append(c)
    targets = [text[s: s + n] for s, n in zip(starts, lens)]
    args = (OPT.mat, *GAPS)
    got = tsw.align_coord(text32, queries, starts, lens, *args, min_sc=19)
    assert got == tsw.align_batch(list(zip(queries, targets)), *args,
                                  min_sc=19, device="cpu")
    assert sum(g["score"] >= 60 for g in got) > 20


def test_other_devices_are_refused():
    x = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        tsw.sw_full(x, x, x[0], x[0], x, x[0], *GAPS)
