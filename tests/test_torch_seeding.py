"""The port's device seeding engine on the CPU (the plain versions) against
the JAX package's DeviceSeedingEngine and the port's own HostSeedingEngine,
on the read families of tests/test_device_seeding.py. Tolerance zero: SMEMs
are integer tuples (start, end, sa_lo, hitcount).

Under pytest the JAX engine runs round 1 as its fused program and rounds 2
and 3 as host-driven waves (tests/conftest.py sets BWAMEME_FUSE_STEPS23=0);
both forms are the reference."""

import copy

import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq
from bwameme_tpu.index.build import build_index
from bwameme_tpu.seeding.engine import DeviceSeedingEngine as JaxEngine
from bwameme_tpu.utils.config import MemOptions as JaxMemOptions
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine
from bwameme_tpu_torch.utils.config import MemOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(77)
    n = 30000
    code = rng.integers(0, 4, n).astype(np.uint8)
    # repetitive structure: interval widening and reseeding
    code[10000:10400] = np.tile(code[10000:10050], 8)
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=11)
    opt = MemOptions()
    return (HostSeedingEngine(idx, opt), JaxEngine(idx, JaxMemOptions()),
            DeviceSeedingEngine(idx, opt, device="cpu"), idx, rng)


def _tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in sm]
            for sm in lists]


def _families(idx, rng):
    text, l_pac = idx.text, idx.l_pac
    fam = {}
    reads = []
    for _ in range(12):
        st = int(rng.integers(0, l_pac - 150))
        c = text[st: st + 120].copy()
        for _ in range(int(rng.integers(0, 4))):
            pp = int(rng.integers(0, 120))
            c[pp] = (c[pp] + rng.integers(1, 4)) % 4
        reads.append(c)
    fam["sampled"] = reads
    reads = []
    for i in range(8):
        st = int(rng.integers(0, l_pac - 150))
        c = text[st: st + 101].copy()
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(c)
    reads.append(rng.integers(0, 4, 100).astype(np.uint8))   # garbage
    fam["rc_and_random"] = reads
    fam["repetitive"] = [text[10000 + k * 37: 10000 + k * 37 + 100].copy()
                         for k in range(5)]
    reads = []
    for _ in range(5):
        st = int(rng.integers(0, l_pac - 150))
        c = text[st: st + 110].copy()
        for _ in range(int(rng.integers(1, 4))):
            c[int(rng.integers(0, 110))] = 4
        reads.append(c)
    fam["with_n"] = reads
    fam["short_and_edge"] = [
        text[:60].copy(),                       # start of text
        text[l_pac - 60: l_pac].copy(),         # end of the forward strand
        text[100:118].copy(),                   # shorter than min_seed
        np.zeros(40, np.uint8),                 # poly-A
        text[l_pac - 70: l_pac + 81].copy(),    # across the junction
        text[2 * l_pac - 151:].copy(),          # runs into the T padding
        np.full(30, 4, np.uint8),               # all N
        np.zeros(0, np.uint8),                  # empty
    ]
    return fam


FAMILIES = ["sampled", "rc_and_random", "repetitive", "with_n",
            "short_and_edge"]


@pytest.fixture(scope="module")
def families(engines):
    return _families(engines[3], np.random.default_rng(78))


@pytest.fixture(scope="module")
def seeded(engines, families):
    """Every family through the three engines as ONE batch each (the JAX
    engine compiles its programs per batch shape): per-read lists in
    emission order from both device engines, sorted lists from the oracle,
    and the port's flat struct."""
    host, jax_eng, eng, _idx, _rng = engines
    reads = [c for f in FAMILIES for c in families[f]]
    bounds = np.cumsum([0] + [len(families[f]) for f in FAMILIES])
    span = {f: slice(int(bounds[i]), int(bounds[i + 1]))
            for i, f in enumerate(FAMILIES)}
    return dict(
        span=span,
        host=_tuples([host.sorted_smems(c) for c in reads]),
        jax=_tuples(jax_eng.collect_smems_batch(reads)),
        port=_tuples(eng.collect_smems_batch(reads)),
        flat=_tuples(eng.sorted_smems_batch_flat(reads).to_lists()))


def _sorted(lists):
    return [sorted(lst, key=lambda s: s[:2]) for lst in lists]


@pytest.mark.parametrize("family", FAMILIES)
def test_port_engine_equals_jax_engine_and_host_oracle(seeded, family):
    sl = seeded["span"][family]
    want = seeded["host"][sl]
    assert _sorted(seeded["port"][sl]) == want
    assert _sorted(seeded["jax"][sl]) == want
    assert seeded["flat"][sl] == want
    if family != "short_and_edge":
        assert sum(map(len, want)) > 0


def test_emission_order_is_the_references(seeded):
    """Unsorted, per read: round 1, then round 2, then round 3, each in the
    order its state machine emits - the JAX engine's order."""
    assert seeded["port"] == seeded["jax"]
    assert any(lst != sorted(lst, key=lambda s: s[:2])
               for lst in seeded["port"])


def test_flat_struct_types(engines, families):
    flat = engines[2].sorted_smems_batch_flat(families["repetitive"])
    assert flat.off.dtype == flat.start.dtype == flat.end.dtype == np.int32
    assert flat.sa_lo.dtype == flat.hitcount.dtype == np.int64
    assert flat.off[-1] == len(flat.start) > 0


def test_long_read_near_the_cap(engines):
    host, _jax_eng, eng, idx, _rng = engines
    c = idx.text[5000:5480].copy()
    c[200] = (c[200] + 1) % 4
    c[333] = 4
    r = idx.text[10010:10490].copy()            # 480 bp of the repeat
    want = _tuples([host.sorted_smems(x) for x in (c, r)])
    assert _tuples(eng.sorted_smems_batch([c, r])) == want
    assert sorted_single(eng, c) == want[0]
    with pytest.raises(ValueError, match="ceiling"):
        eng.submit_batch([np.zeros(513, np.uint8)])


def sorted_single(eng, codes):
    return [(s.start, s.end, s.sa_lo, s.hitcount)
            for s in eng.sorted_smems(codes)]


def test_pack_keeps_ties_in_emission_order():
    """Entries of one read with equal (start, end) stay in round, then
    emission order through pack + the host's stable sort."""
    def rnd(entries, M):
        slots = torch.zeros((4, 2, M), dtype=torch.int32)
        nsm = torch.zeros(2, dtype=torch.int32)
        for read, e in entries:
            slots[:, read, nsm[read]] = torch.tensor(e, dtype=torch.int32)
            nsm[read] += 1
        return slots, nsm, torch.zeros(2, dtype=torch.int32)

    r1 = rnd([(0, (5, 40, 100, 1)), (0, (0, 30, 7, 2)), (1, (3, 25, 9, 1))],
             4)
    r2 = rnd([(0, (5, 40, 200, 3))], 2)
    r3 = rnd([(0, (5, 40, 300, 9)), (0, (5, 24, 11, 30)),
              (1, (3, 25, 8, 2))], 4)
    eng = DeviceSeedingEngine.__new__(DeviceSeedingEngine)
    cap = 2 * 24
    token = (2, [r1, r2, r3], seed_smem.pack_rounds([r1, r2, r3], cap), cap)
    flat = eng.finish_batch_flat(token)
    assert flat.off.tolist() == [0, 5, 7]
    assert _tuples(flat.to_lists()) == [
        [(0, 30, 7, 2), (5, 24, 11, 30), (5, 40, 100, 1), (5, 40, 200, 3),
         (5, 40, 300, 9)],
        [(3, 25, 9, 1), (3, 25, 8, 2)]]
    # a batch that outgrows the packed buffer is fetched as slot planes
    small = (2, [r1, r2, r3], seed_smem.pack_rounds([r1, r2, r3], 3), 3)
    assert eng.finish_batch_flat(small) is None
    assert _tuples(eng.finish_batch(small))[1] == [(3, 25, 9, 1),
                                                  (3, 25, 8, 2)]


@pytest.mark.parametrize("max_smems", [1, 2])
def test_a_full_round_drops_seeds_as_the_jax_engine_does(engines, families,
                                                         max_smems):
    """With max_smems lowered, reads emit more SMEMs in rounds 1 and 3 than
    they have slots: the port keeps the ones that found a slot and drops the
    rest, read for read as the JAX device engine drops them (its rounds 1
    and 3 as the fused programs, which hold the slots; its round 2 here is
    the host-driven waves, which hold none, and no read fills round 2's 16
    slots), and counts the dropped ones."""
    _host, jax_eng, eng, _idx, _rng = engines
    reads = families["sampled"]
    ref = copy.copy(jax_eng)    # the fixture's engines are shared
    ref.max_smems = max_smems
    ref.fuse_step3 = True
    want = _tuples(ref.collect_smems_batch(reads))
    tight = copy.copy(eng)      # shares the index planes
    tight.max_smems = max_smems
    tight.dropped_smems = 0
    assert _tuples(tight.collect_smems_batch(reads)) == want
    dropped = tight.dropped_smems
    assert dropped > 0
    flat = tight.sorted_smems_batch_flat(reads)
    assert _tuples(flat.to_lists()) == _sorted(want)
    assert tight.dropped_smems == 2 * dropped


def test_prepare_reads_equals_host_packing(engines, families):
    """The query buffer and the tables against numpy: pack_words of each
    strand, and HostSeedingEngine's next-N scan."""
    from bwameme_tpu_torch.index.packing import pack_words

    reads = families["with_n"] + families["short_and_edge"][:4]
    mat, lens, maxlen = DeviceSeedingEngine._batch_matrix(reads)
    qbuf, nf, nr, nvf = seed_smem.prepare_reads(torch.from_numpy(mat),
                                                torch.from_numpy(lens))
    q = qbuf.numpy().view(np.uint32)
    R = len(reads)
    for i, c in enumerate(reads):
        rc = np.where(c < 4, 3 - c, c)[::-1]
        for row, s, tab in ((i, c, nf), (R + i, rc, nr)):
            padded = np.full(maxlen, 3, np.uint8)
            padded[: len(s)] = np.where(s >= 4, 0, s)
            w = pack_words(padded, pad_code=3)
            assert (q[row, : len(w)] == w).all()
            assert (q[row, len(w):] == 0xFFFFFFFF).all()
            nn = HostSeedingEngine._next_n(s)
            assert tab[i, : len(s) + 1].tolist() == nn.tolist()
            assert (tab[i, len(s):] == len(s)).all()
        nv = [next((j for j in range(k, len(c)) if c[j] < 4), len(c))
              for k in range(len(c) + 1)]
        assert nvf[i, : len(c) + 1].tolist() == nv


def test_plain_rounds_count_the_work_without_changing_the_result(engines,
                                                                 families):
    """``work=`` counts one number of probes a read - the index sectors the
    scalar contract reads for it - and the distinct sectors the answers
    stand on, and leaves the round's result as it is: reads that are
    searched count some, reads too short to seed, all N or empty count
    none."""
    eng, opt = engines[2], engines[2].opt
    reads = families["sampled"][:4] + families["short_and_edge"]
    mat, lens_np, _ = eng._batch_matrix(reads)
    lens = torch.from_numpy(lens_np.astype(np.int32))
    qbuf, nf, nr, nvf = seed_smem.prepare_reads(torch.from_numpy(mat), lens)
    R = len(reads)
    rounds = [
        (seed_smem.seed_round1_torch,
         (eng.di, qbuf, nf, nr, nvf, lens, opt.min_seed_len, 96)),
        (seed_smem.seed_round3_torch,
         (eng.di, qbuf, nf, lens, opt.max_mem_intv, opt.min_seed_len + 1,
          96))]
    r1 = rounds[0][0](*rounds[0][1])
    rounds.insert(1, (seed_smem.seed_round2_torch,
                      (eng.di, qbuf, nf, nr, lens, r1[0], r1[1],
                       opt.split_len, opt.split_width, opt.min_seed_len,
                       16)))
    searched = torch.tensor([len(c) >= opt.min_seed_len and bool((c < 4).any())
                             for c in reads])
    for k, (fn, args) in enumerate(rounds):
        work = ss.Work(R, "cpu")
        got, want = fn(*args, work=work), fn(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool((work.probes[~searched] == 0).all())
        if k != 1:      # round 2 reseeds only long, rare SMEMs
            assert bool((work.probes[searched] > 0).all())
            assert (0 < work.answer_sectors(leaves=False)
                    < work.answer_sectors())
        assert work.answer_sectors() <= int(work.probes.sum())
