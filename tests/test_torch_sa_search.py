"""Each plain search primitive of the port against the public function of
the same name that bwameme_tpu's make_search_fns returns, on one set of
arrays made with numpy from a seed. Tolerance zero: everything is integer,
and the one f32 step (the P-RMI prediction) is held bit-exact through the
windows it yields."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq
from bwameme_tpu.index.build import build_index
from bwameme_tpu.ops.sa_search import DeviceIndex as JaxDeviceIndex
from bwameme_tpu.ops.sa_search import make_search_fns
from bwameme_tpu_torch.index.device import DeviceIndex
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """A 24 kbp text with a tiled repeat (suffixes that tie for hundreds of
    bases), reads of 151 bp (mutated, reverse-complemented, with N, from the
    repeat, across the text/reverse-complement junction and at the T
    padding) and one of 480 bp, packed by the port's read prep."""
    rng = np.random.default_rng(41)
    n = 24000
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[8000:8400] = np.tile(code[8000:8050], 8)
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    text = idx.text
    reads = []
    for i in range(10):
        st = int(rng.integers(0, n - 151))
        c = text[st: st + 151].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, 151))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 3 == 0:
            c[int(rng.integers(0, 151))] = 4
        if i % 2:
            c = np.where(c < 4, 3 - c, c)[::-1].astype(np.uint8)
        reads.append(c)
    reads += [text[8000 + 13 * k: 8151 + 13 * k].copy() for k in range(3)]
    reads.append(text[n - 75: n + 76].copy())        # across the junction
    reads.append(text[2 * n - 151:].copy())          # runs into the padding
    reads.append(np.concatenate([text[2 * n - 100:],
                                 np.full(51, 3, np.uint8)]))
    reads.append(text[8010:8490].copy())             # 480 bp, deep ties
    lens = np.array([len(c) for c in reads])
    mat = np.full((len(reads), lens.max()), 3, np.uint8)
    for i, c in enumerate(reads):
        mat[i, : len(c)] = c
    qbuf, nf, nr, _ = seed_smem.prepare_reads(
        torch.from_numpy(mat), torch.from_numpy(lens))
    jd = JaxDeviceIndex.from_host(idx, mode=4)
    mw = int((idx.rmi_err_lo.astype(np.int64)
              + idx.rmi_err_hi.astype(np.int64)).max())
    fns = make_search_fns(jd, max_read_words=qbuf.shape[1] - 3, max_width=mw)
    di = DeviceIndex.from_host(idx, "cpu")

    # jobs (row, pivot, v): whole valid windows and cut ones, both strands
    R = len(reads)
    rows, pivs, vs = [], [], []
    for i in range(R):
        for _ in range(12):
            p = int(rng.integers(0, lens[i]))
            rev = int(rng.integers(0, 2))
            full = int((nr if rev else nf)[i, p]) - p
            v = full if rng.random() < 0.6 else int(rng.integers(0, full + 1))
            rows.append(i + rev * R)
            pivs.append(p)
            vs.append(v)
    # the deep ones: from the start of the repeat reads and the long read
    for i in (10, 11, 12, R - 1):
        for p in (0, 7, 33):
            rows.append(i)
            pivs.append(p)
            vs.append(int(nf[i, p]) - p)
    jobs = tuple(np.asarray(a, np.int32) for a in (rows, pivs, vs))
    assert (jobs[2] == 0).any() and (jobs[2] > 112).any()
    assert ((jobs[2] > 48) & (jobs[2] <= 112)).any()
    return dict(idx=idx, jd=jd, fns=fns, di=di, qbuf=qbuf, jobs=jobs,
                rng=rng)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a)).to(torch.int64)


def _qbuf_np(qbuf):
    return qbuf.numpy().view(np.uint32)


def _same(got, want):
    got = [np.asarray(g.numpy()) for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g.astype(np.int64) == w.astype(np.int64)).all()


def test_prmi_window_on_every_key(world):
    """Every stored key, each leaf's first and last key, and keys with their
    tails padded with zeros and ones (what find_longest and interval_at
    feed the model)."""
    idx, di, jd, fns = (world[k] for k in ("idx", "di", "jd", "fns"))
    khi, klo = idx.key_hi.astype(np.uint32), idx.key_lo.astype(np.uint32)
    ls = np.asarray(idx.rmi_leaf_start, np.int64)
    edge = np.unique(np.clip(np.concatenate([ls[:-1], ls[1:] - 1]), 0,
                             idx.n_sa - 1))
    parts_hi, parts_lo = [khi, khi[edge]], [klo, klo[edge]]
    for keep in (5, 19, 24):
        m = np.uint32((0xFFFFFFFF << (32 - 2 * min(keep, 16))) & 0xFFFFFFFF)
        ml = np.uint32(0) if keep <= 16 else np.uint32(
            (0xFFFFFFFF << (64 - 2 * keep)) & 0xFFFFFFFF)
        parts_hi += [khi & m, (khi & m) | ~m]
        parts_lo += [klo & ml, (klo & ml) | ~ml]
    kh, kl = np.concatenate(parts_hi), np.concatenate(parts_lo)
    want = fns["rmi_window"](jd, _j(kh), _j(kl))
    _same(ss.rmi_window(di, _t(kh), _t(kl)), want)
    # the int32-storage form the kernel's wrapper takes
    got = seed_smem.prmi_window_torch(
        di, *(torch.from_numpy(k.view(np.int32)) for k in (kh, kl)))
    assert got[0].dtype == torch.int32
    _same(got, want)
    # and the windows hold each key's own rank
    lo, hi = (np.asarray(w)[: idx.n_sa] for w in want)
    r = np.arange(idx.n_sa)
    assert ((lo <= r) & (r < hi)).mean() > 0.99


def test_text64_at_against_the_text(world):
    idx, di = world["idx"], world["di"]
    n = idx.n_sa
    pos = np.concatenate([world["rng"].integers(0, n, 200),
                          [0, 15, 16, n - 70, n - 64, n - 1, n, n + 40]])
    got = np.stack([w.numpy() for w in ss.text64_at(di, _t(pos))], 1)
    textp = np.concatenate([idx.text, np.full(400, 3, np.uint8)])
    for p, words in zip(pos, got):
        if p >= n:
            assert (words == 0xFFFFFFFF).all()
            continue
        bases = textp[p: p + 64].astype(np.int64).reshape(4, 16)
        want = (bases << (2 * (15 - np.arange(16)))).sum(1)
        assert (words == want).all(), p


@pytest.mark.parametrize("name", ["suffix_cmp", "lcp_at"])
def test_compare_incl_out_of_range_ranks(world, name):
    di, jd, fns, qbuf = (world[k] for k in ("di", "jd", "fns", "qbuf"))
    rows, pivs, vs = world["jobs"]
    rng = np.random.default_rng(3)
    n = di.n_sa
    sa_idx = rng.integers(0, n, len(rows)).astype(np.int32)
    sa_idx[::7] = -1
    sa_idx[3::7] = n
    sa_idx[5::11] = n + 5
    sa_idx[6::13] = 0
    sa_idx[2::17] = n - 1
    # ranks next to where the pattern belongs: long common prefixes
    near = fns["find_longest"](jd, _j(_qbuf_np(qbuf)), _j(rows), _j(pivs),
                               _j(np.maximum(vs, 1)))[1]
    sa_idx[1::3] = (np.asarray(near)[1::3]
                    - rng.integers(0, 2, len(rows))[1::3])
    want = fns[name](jd, _j(_qbuf_np(qbuf)), _j(rows), _j(pivs), _j(vs),
                     _j(sa_idx))
    got = getattr(ss, name)(di, qbuf, _t(rows), _t(pivs), _t(vs), _t(sa_idx))
    if name == "lcp_at":
        got, want = [got], [want]
    _same(got, want)


@pytest.mark.parametrize("name", ["find_longest", "interval_at",
                                  "sa_query_min1"])
def test_search_primitives(world, name):
    di, jd, fns, qbuf = (world[k] for k in ("di", "jd", "fns", "qbuf"))
    rows, pivs, vs = world["jobs"]
    if name != "sa_query_min1":     # their callers never pass a length of 0
        vs = np.maximum(vs, 1)
    want = fns[name](jd, _j(_qbuf_np(qbuf)), _j(rows), _j(pivs), _j(vs))
    _same(getattr(ss, name)(di, qbuf, _t(rows), _t(pivs), _t(vs)), want)
    if name == "find_longest":
        assert int(np.asarray(want[0]).max()) > 112


def test_sa_query_widening(world):
    di, jd, fns, qbuf = (world[k] for k in ("di", "jd", "fns", "qbuf"))
    rows, pivs, vs = world["jobs"]
    mi = np.random.default_rng(5).choice(
        [1, 2, 3, 8, 21, 500, 100000], len(rows)).astype(np.int32)
    want = fns["sa_query"](jd, _j(_qbuf_np(qbuf)), _j(rows), _j(pivs), _j(vs),
                           _j(mi))
    _same(ss.sa_query(di, qbuf, _t(rows), _t(pivs), _t(vs), _t(mi)), want)
    # the widening did run: some job ended shorter than its longest match
    longest = fns["sa_query_min1"](jd, _j(_qbuf_np(qbuf)), _j(rows),
                                   _j(pivs), _j(vs))[0]
    assert (np.asarray(want[0]) < np.asarray(longest)).any()
    # and the int32 form the kernel's wrapper takes
    got = seed_smem.sa_query_torch(di, qbuf, *(torch.from_numpy(a)
                                               for a in (rows, pivs, vs, mi)))
    _same(list(got), want)


def test_packed_words_compare_as_unsigned(world):
    """A pattern of T's (words with the top bit set) sorts after everything
    else: a signed compare of the int32 storage would put it first."""
    di = world["di"]
    qbuf = torch.full((2, 5), -1, dtype=torch.int32)       # all T
    z = torch.zeros(1, dtype=torch.int64)
    less, _ = ss.suffix_cmp(di, qbuf, z, z, z + 32, z)      # rank 0: AAA...
    assert bool(less[0])
    lo, hi = ss.rmi_window(di, z + 0xFFFFFFFF, z + 0xFFFFFFFF)
    assert int(hi[0]) == di.n_sa and int(lo[0]) > di.n_sa // 2
