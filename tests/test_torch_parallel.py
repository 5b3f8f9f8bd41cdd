"""The port's scale-out on the CPU (bwameme_tpu_torch/parallel/, the
sharded index of index/device.py): the index's per-suffix planes in rank
blocks over CPU "devices" (a device may repeat, the port's counterpart of
the virtual CPU devices this suite arms for the JAX package), read through
the plain owned gather. Held against the JAX package: the sharded sa_query
against bwameme_tpu's make_sharded_search on a 4-device CPU mesh, exactly;
the sharded engine, the data-parallel aligner, two gloo processes and the
CLI against the single-device host-engine SAM of the shared workload
(``par_oracle``), byte for byte; SMEMs at several shard counts and in every
layout against the unsharded engine's."""

import gzip
import os

import jax
import numpy as np
import pytest
import torch

from bwameme_tpu_torch import cli
from bwameme_tpu_torch.index.device import (MAX_BLOCKS, DeviceIndex,
                                            ShardedPlane, block_of,
                                            choose_mode)
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem
from bwameme_tpu_torch.parallel import multihost
from bwameme_tpu_torch.parallel.dp import DataParallelAligner, make_dp_mesh
from bwameme_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                      make_sharded_search)
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import (DeviceSeedingEngine,
                                              cut_batch)

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(n):
    return [torch.device("cpu")] * n


def _jobs(idx, rng, n_reads=40, per_read=12):
    """Reads of the index's text (substitutions, an N, both strands), their
    packed query buffer and sa_query jobs on it: every pivot's whole window
    and cut ones, min_intv from 1 up."""
    eng = DeviceSeedingEngine(idx, _opt(), device="cpu")
    reads = []
    for i in range(n_reads):
        a = int(rng.integers(0, 2 * idx.l_pac - 120))
        c = idx.text[a: a + 120].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, 120))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 5 == 0:
            c[int(rng.integers(0, 120))] = 4
        reads.append(c)
    mat, lens_np, _ = eng._batch_matrix(reads)
    lens = torch.from_numpy(lens_np.astype(np.int32))
    qbuf, nf, nr, _ = seed_smem.prepare_reads(torch.from_numpy(mat), lens)
    R = len(reads)
    rd = np.repeat(np.arange(R), per_read)
    piv = rng.integers(0, 120, R * per_read)
    rev = rng.integers(0, 2, R * per_read)
    full = np.where(rev == 1, nr.numpy()[rd, piv], nf.numpy()[rd, piv]) - piv
    v = np.where(rng.random(R * per_read) < 0.6, full,
                 (rng.random(R * per_read) * (full + 1)).astype(np.int64))
    mi = rng.choice([1, 1, 2, 3, 11, 21, 501], R * per_read)
    return qbuf, [a.astype(np.int32) for a in (rd + rev * R, piv, v, mi)]


def _opt():
    from bwameme_tpu_torch.utils.config import MemOptions

    return MemOptions()


# ------------------------------------------------------ the owned gather


def test_sharded_plane_blocks_and_owned_gather():
    """Equal blocks of ceil(n / shards) rows, the last padded with zeros as
    put_shard pads, each its own allocation, the table their addresses;
    owned gives the whole plane's rows at every rank, the first and last
    of each block included, and the fill outside [0, n)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (101, 4)).astype(
        np.int32))
    p = ShardedPlane.split(x, _cpus(4))
    assert p.block_rows == 26 and p.shape == (101, 4) and len(p.blocks) == 4
    assert p.table.tolist() == [b.data_ptr() for b in p.blocks]
    assert len({b.data_ptr() for b in p.blocks}) == 4
    assert bool((p.blocks[3][23:] == 0).all())
    assert torch.equal(p.whole(), x)
    g = torch.tensor([-3, -1, 0, 25, 26, 51, 52, 77, 78, 99, 100, 101, 104,
                      500])
    got = ss.owned(p, g, 7)
    inb = (g >= 0) & (g < 101)
    assert torch.equal(got[inb], x[g[inb]])
    assert bool((got[~inb] == 7).all())
    assert torch.equal(ss.owned(x, g, 7), got)


def test_sharded_index_checks_and_mode_ladder(par_workload):
    """The planes are checked block by block; the ladder budgets a block a
    device (bwameme_tpu/ops/sa_search.py:205); a sharded index keeps the
    text, the leaf records and the k-mer table whole on its first device."""
    idx = par_workload[0]
    di = DeviceIndex.from_host(idx, "cpu", mode=3, ert_bits=0,
                               shards=_cpus(3))
    assert di.shards == _cpus(3)
    assert isinstance(di.sa, ShardedPlane) and isinstance(di.ktext,
                                                          ShardedPlane)
    assert isinstance(di.text32, torch.Tensor)
    assert isinstance(di.kmer_table, torch.Tensor)
    whole = DeviceIndex.from_host(idx, "cpu", mode=3, ert_bits=0)
    assert torch.equal(di.sa.whole(), whole.sa)
    assert torch.equal(di.ktext.whole(), whole.ktext)
    bad = ShardedPlane(di.sa.blocks[:2], di.sa.rows, di.sa.table[:2])
    with pytest.raises(ValueError, match="rows in 2 blocks"):
        DeviceIndex(**{**{f: getattr(di, f) for f in
                          DeviceIndex.__dataclass_fields__}, "sa": bad})
    with pytest.raises(ValueError, match="sharded already"):
        di.shard(_cpus(2))
    n = 2 * 10**9
    assert choose_mode(n, True, False, 16 << 30) == 1
    assert choose_mode(n, True, False, 16 << 30, shards=2) == 3
    assert choose_mode(n, True, False, 16 << 30, shards=4) == 4


def test_mode_ladder_budgets_repeated_devices_per_card(par_workload,
                                                      monkeypatch):
    """Blocks that repeat a device share its memory: the ladder budgets the
    fullest card's blocks, so four blocks on one device get the mode of the
    whole index there, and two blocks a card over two cards that of half
    of it."""
    idx = par_workload[0]
    n = int(idx.n_sa)
    monkeypatch.setenv("BWAMEME_HBM_BYTES", str(n * 16))
    whole = DeviceIndex.from_host(idx, "cpu")
    assert whole.mode == 3
    four = DeviceIndex.from_host(idx, "cpu", shards=_cpus(4))
    assert (four.mode, four.shards) == (whole.mode, _cpus(4))
    assert choose_mode(n, True, False, n * 16, shards=4) == 4
    assert choose_mode(n, True, False, n * 16, shards=4, per_card=4) == 3
    n = 2 * 10**9
    assert choose_mode(n, True, False, 16 << 30, shards=4, per_card=4) == 1
    assert choose_mode(n, True, False, 16 << 30, shards=4, per_card=2) == 3


def test_sharded_sa_query_equals_jax_make_sharded_search(par_workload):
    """The port's sharded sa_query (plain version, 4 CPU shards) against the
    JAX package's make_sharded_search on a 4-device CPU mesh, on the same
    queries from a numpy seed: mlen, lb and cnt exactly equal."""
    from jax.sharding import Mesh

    from bwameme_tpu.parallel import sharded_index as jsh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    idx = par_workload[0]
    qbuf, jobs = _jobs(idx, np.random.default_rng(11))
    mesh = Mesh(np.array(jax.devices()[:4]), ("idx",))
    jq = jsh.make_sharded_search(jsh.ShardedIndex.shard(idx, mesh),
                                 max_read_words=qbuf.shape[1])
    want = [np.asarray(a) for a in jq(qbuf.numpy().view(np.uint32), *jobs)]
    si = ShardedIndex.shard(idx, _cpus(4))
    assert si.n_shards == 4
    got = make_sharded_search(si)(qbuf, *(torch.from_numpy(a) for a in jobs))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert int(got[0].max()) > 100 and int((got[2] >= 2).sum()) > 0


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engine8(par_workload, par_oracle):
    return DeviceSeedingEngine(par_workload[0], par_oracle[2], lanes=256,
                               device="cpu", shards=_cpus(8))


def test_sharded_engine_se_sam(par_workload, par_oracle, engine8):
    idx, se_reads, _ = par_workload
    sam_se, _, opt, _ = par_oracle
    assert len(engine8.di.shards) == 8
    al = Aligner(idx, opt, seeding_engine=engine8, device="cpu")
    assert al.align_batch(se_reads) == sam_se


def test_sharded_engine_pe_sam(par_workload, par_oracle, engine8):
    idx, _, pe_reads = par_workload
    _, sam_pe, _, opt_pe = par_oracle
    al = Aligner(idx, opt_pe, seeding_engine=engine8, device="cpu")
    assert al.align_pairs(pe_reads) == sam_pe


@pytest.fixture(scope="module")
def codes(par_workload):
    from bwameme_tpu_torch.index.packing import NT4_TABLE

    _, se_reads, pe_reads = par_workload
    return [NT4_TABLE[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in se_reads + pe_reads[:32]]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 8])
def test_smems_at_every_shard_count(par_workload, par_oracle, codes,
                                    n_shards):
    """The workload's 60000 suffixes split evenly in 1, 2, 3 and 8 blocks;
    7 does not divide them, and the last block is padded."""
    idx, opt = par_workload[0], par_oracle[2]
    want = DeviceSeedingEngine(idx, opt, device="cpu").collect_smems_batch(
        codes)
    eng = DeviceSeedingEngine(idx, opt, device="cpu",
                              shards=_cpus(n_shards))
    B = eng.di.rk.block_rows
    assert (B * n_shards > idx.n_sa) == (n_shards == 7)
    assert eng.collect_smems_batch(codes) == want


LAYOUTS = [(1, False, "prmi"), (2, False, "prmi"), (3, False, "prmi"),
           (4, False, "prmi"), (1, True, "prmi"), (4, False, "kmer"),
           (3, True, "kmer")]


@pytest.mark.parametrize("mode,wide,root", LAYOUTS,
                         ids=[f"mode{m}{'_wide' if w else ''}_{r}"
                              for m, w, r in LAYOUTS])
def test_smems_of_every_layout_sharded(par_workload, par_oracle, codes, mode,
                                       wide, root):
    idx, opt = par_workload[0], par_oracle[2]
    kw = dict(device="cpu", mode=mode, wide=wide, root=root)
    want = DeviceSeedingEngine(idx, opt, **kw).collect_smems_batch(codes)
    eng = DeviceSeedingEngine(idx, opt, shards=_cpus(3), **kw)
    assert (eng.di.mode, eng.di.wide, eng.di.root) == (mode, wide, root)
    assert eng.collect_smems_batch(codes) == want


# ---------------------------------------------------- the batch cut


def test_cut_batch_slices():
    """One contiguous slice a device of the list, in order, the empty ones
    left out; no read is one empty slice on the first device."""
    cpu = torch.device("cpu")
    assert cut_batch(10, _cpus(3)) == [(cpu, 0, 4), (cpu, 4, 8),
                                      (cpu, 8, 10)]
    assert cut_batch(2, _cpus(4)) == [(cpu, 0, 1), (cpu, 1, 2)]
    assert cut_batch(5, _cpus(1)) == [(cpu, 0, 5)]
    assert cut_batch(0, _cpus(2)) == [(cpu, 0, 0)]


def _flat_tuples(flat):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
            for lst in flat.to_lists()]


def _list_tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
            for lst in lists]


@pytest.mark.parametrize("n_slices", [2, 3])
def test_batch_cut_equals_one_launch(par_workload, par_oracle, codes,
                                     n_slices):
    """The batch cut over n_slices devices (CPU ones here) gives the
    one-launch batch's flat SMEMs and per-read lists, entry for entry, and
    drops as many SMEMs (one emission slot a read in rounds 1 and 3)."""
    import copy

    idx, opt = par_workload[0], par_oracle[2]
    eng = DeviceSeedingEngine(idx, opt, device="cpu", shards=_cpus(3))
    assert eng.cards == _cpus(1)
    tight = copy.copy(eng)
    tight.max_smems = 1
    for e in (eng, tight):
        e.dropped_smems = 0
        one = e.submit_batch(codes)
        assert not isinstance(one, list)
        want_flat = _flat_tuples(e.finish_batch_flat(one))
        want_lists = _list_tuples(e.finish_batch(one))
        dropped = e.dropped_smems
        assert dropped > 0 if e is tight else dropped == 0
        e.dropped_smems = 0
        tok = e.submit_batch(codes, devices=_cpus(n_slices))
        assert [b for b, _ in tok] == [b for _, b, _ in
                                       cut_batch(len(codes),
                                                 _cpus(n_slices))]
        assert _flat_tuples(e.finish_batch_flat(tok)) == want_flat
        assert _list_tuples(e.finish_batch(tok)) == want_lists
        assert e.dropped_smems == dropped


def test_batch_cut_with_an_overflowing_slice(par_workload, par_oracle,
                                             codes):
    """A slice whose packed entries outgrow its buffer is fetched as its
    slot planes; the merged result is still the one-launch batch's, whose
    own buffer (twice the slice's) holds them."""
    idx, opt = par_workload[0], par_oracle[2]
    eng = DeviceSeedingEngine(idx, opt, device="cpu")
    # reads with SMEMs, then as many shorter than a seed, which have none
    batch = codes[:32] + [np.zeros(10, np.uint8)] * 32
    want = _list_tuples(eng.finish_batch(eng.submit_batch(batch)))
    total = sum(map(len, want))
    eng.pack_cap_per_read = total // 32 - 1
    assert total > 32 * eng.pack_cap_per_read and total <= len(batch) * (
        eng.pack_cap_per_read)
    one = eng.finish_batch_flat(eng.submit_batch(batch))
    assert _flat_tuples(one) == [sorted(w, key=lambda s: (s[0], s[1]))
                                 for w in want]
    tok = eng.submit_batch(batch, devices=_cpus(2))
    assert [t[0] for _, t in tok] == [32, 32]
    assert eng._flat(tok[0][1])[0] is None
    assert _flat_tuples(eng.finish_batch_flat(tok)) == _flat_tuples(one)
    assert _list_tuples(eng.finish_batch(tok)) == want


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_aligner_over_the_batch_cut(par_workload, par_oracle, paired):
    """The Aligner over a sharded engine whose batches are cut in three
    slices: the JAX package's host-engine SAM, and the unsharded port's."""
    import functools

    idx, se_reads, pe_reads = par_workload
    sam_se, sam_pe, opt, opt_pe = par_oracle
    o = opt_pe if paired else opt
    eng = DeviceSeedingEngine(idx, o, lanes=256, device="cpu",
                              shards=_cpus(2))
    eng.submit_batch = functools.partial(eng.submit_batch,
                                         devices=_cpus(3))
    whole = Aligner(idx, o, seeding_engine=DeviceSeedingEngine(
        idx, o, lanes=256, device="cpu"), device="cpu")
    al = Aligner(idx, o, seeding_engine=eng, device="cpu")
    if paired:
        assert al.align_pairs(pe_reads) == sam_pe == whole.align_pairs(
            pe_reads)
    else:
        assert al.align_batch(se_reads) == sam_se == whole.align_batch(
            se_reads)


def test_shard_views_and_bytes_a_card(par_workload):
    """shard() returns the view from the first device; every distinct
    device of the list has a view whose text, leaves, root and block tables
    lie on it, over the same blocks. Each card is budgeted its blocks and a
    copy of the replicated planes and tables; more than MAX_BLOCKS blocks
    raise, naming both counts."""
    idx = par_workload[0]
    whole = DeviceIndex.from_host(idx, "cpu", mode=2, wide=True, ert_bits=0)
    di = whole.shard(_cpus(3))
    cpu = torch.device("cpu")
    assert di.on("cpu") is di and di.views == {cpu: di}
    assert whole.on("cpu") is whole
    with pytest.raises(ValueError, match="no block on cuda:1"):
        di.on(torch.device("cuda", 1))
    blocks = {k: di.planes[k].blocks for k in ("sa", "key2")}
    rep = {k: t.numel() * t.element_size() for k, t in whole.planes.items()
           if k not in ("sa", "key2")}
    assert set(rep) == {"text32", "params", "params64", "kmer_table"}
    cards = [torch.device("cuda", i) for i in (0, 1, 0, 2)]
    need = whole.shard_bytes(cards)
    blk = {k: b[0].numel() * b[0].element_size() for k, b in blocks.items()}
    assert list(need) == [cards[0], cards[1], cards[3]]
    for d, n in need.items():
        per = sum(whole.planes[k].numel() * whole.planes[k].element_size()
                  // 4 for k in ("sa", "key2"))
        assert n == cards.count(d) * per + sum(rep.values()) + 2 * 8 * 4
    assert sum(blk.values()) * 3 >= sum(
        whole.planes[k].numel() * whole.planes[k].element_size()
        for k in ("sa", "key2"))
    with pytest.raises(ValueError, match="33 blocks: .* at most 32"):
        whole.shard(_cpus(MAX_BLOCKS + 1))


@pytest.mark.parametrize("n_blocks", [2, 3, 4])
@pytest.mark.parametrize("n", [2281701376, 2**31 - 1, 60000],
                         ids=["jumbo", "narrow_max", "small"])
def test_block_of_without_a_division(n, n_blocks):
    """The kernels' owner lookup (a multiply-high by the host's reciprocal
    and one compare) is r // block_rows at every block's first and last
    row, at n_sa - 1 and at random ranks: wide over the jumbo index's
    2281701376 suffixes, narrow and wide below 2^31, without the planes."""
    B = -(-n // n_blocks)
    rng = np.random.default_rng(n_blocks)
    ranks = {0, n - 1, *rng.integers(0, n, 2000).tolist()}
    for b in range(n_blocks):
        ranks |= {r for r in (b * B - 1, b * B, b * B + 1, (b + 1) * B - 1)
                  if 0 <= r < n}
    for wide in ([True] if n >= 2**31 else [False, True]):
        for r in sorted(ranks):
            assert block_of(r, B, wide) == r // B, (r, B, wide)


# ---------------------------------------------- data parallel, processes


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_data_parallel_2x2(par_workload, par_oracle, paired):
    idx, se_reads, pe_reads = par_workload
    sam_se, sam_pe, opt, opt_pe = par_oracle
    mesh = make_dp_mesh(2, 2, _cpus(4))
    assert [len(row) for row in mesh] == [2, 2]
    al = DataParallelAligner(idx, opt_pe if paired else opt, mesh=mesh)
    assert all(len(row.engine.di.shards) == 2 for row in al.rows)
    if paired:
        assert al.align_pairs(pe_reads) == sam_pe
    else:
        assert al.align_batch(se_reads) == sam_se
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_dp_mesh(2, 3, _cpus(4))


def test_two_gloo_processes(par_oracle, tmp_path):
    """Two worker processes over torch.distributed (gloo), each an engine of
    two CPU shards: the card counts all-reduced to 2 x 2, FASTQ scattered,
    SAM gathered, PE statistics all-gathered; the union's SAM is the
    single-device oracle's."""
    sam_se, sam_pe, _, _ = par_oracle
    got_se, got_pe = multihost.run_multihost(2, "gloo", "cpu", shards=2,
                                             workdir=str(tmp_path),
                                             timeout=240)
    for pid in range(2):
        assert (tmp_path / f"cards_{pid}").read_text() == "4 cpu cpu"
    assert got_se == "".join(sam_se)
    assert got_pe == "".join(sam_pe)


def test_nccl_needs_a_card_a_process():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(RuntimeError,
                       match=r"2 processes of 1 card\(s\) each need 2 "
                             r"cards, [01] visible"):
        multihost.run_multihost(2, "nccl")


def _cuda(*ids):
    return [torch.device("cuda", i) for i in ids]


CARD_MAPS = [
    ("nccl", 2, 2, 4, "cuda", [_cuda(0, 1), _cuda(2, 3)]),
    ("nccl", 4, 1, 4, "cuda", [_cuda(0), _cuda(1), _cuda(2), _cuda(3)]),
    ("nccl", 2, 2, 3, "cuda", "need 4 cards, 3 visible"),
    ("gloo", 2, 3, 4, "cpu", [_cpus(3), _cpus(3)]),
    ("gloo", 2, 2, 4, "cuda:1", [_cuda(1, 1), _cuda(1, 1)]),
]


@pytest.mark.parametrize("backend,n_procs,k,visible,device,want", CARD_MAPS,
                         ids=["nccl_2x2", "nccl_4x1", "nccl_3_of_4",
                              "gloo_cpu", "gloo_card"])
def test_process_cards(monkeypatch, backend, n_procs, k, visible, device,
                       want):
    """Under nccl process p takes cards [p k, (p + 1) k), the dp rows'
    split, and each process's ladder then counts one block a card; fewer
    visible cards than n_procs x k raise naming both counts; under gloo
    every process's blocks are k copies of its device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=want):
            multihost.process_cards(backend, 0, n_procs, "cuda", k)
        return
    got = [multihost.process_cards(backend, p, n_procs, device, k)
           for p in range(n_procs)]
    assert got == want
    if backend == "nccl":
        assert got == make_dp_mesh(n_procs, k)
        assert all(max(map(c.count, c)) == 1 for c in got)


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def golden_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_parallel")
    with gzip.open(os.path.join(GOLD, "ref.fa.gz"), "rt") as f:
        (d / "ref.fa").write_text(f.read())
    with gzip.open(os.path.join(GOLD, "reads_se.fq.gz"), "rt") as f:
        (d / "reads.fq").write_text("".join(f.readlines()[: 4 * 120]))
    assert cli.main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


def _mem(d, out, *flags):
    assert cli.main(["mem", str(d / "idx"), str(d / "reads.fq"), "-o",
                     str(out), *flags]) == 0
    return [ln for ln in out.read_text().splitlines()
            if not ln.startswith("@PG")]


def test_cli_shards_and_dp_shards(golden_index, tmp_path, monkeypatch):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    want = _mem(golden_index, tmp_path / "one.sam")
    assert len(want) > 120
    assert _mem(golden_index, tmp_path / "s4.sam", "--shards", "4") == want
    assert _mem(golden_index, tmp_path / "dp.sam", "--dp-shards", "2",
                "--shards", "2", "--batch", "50") == want


@pytest.mark.parametrize("flags", [["--backend", "fmi", "--shards", "2"],
                                   ["--engine", "host", "--dp-shards", "2"],
                                   ["--shards", "0"]],
                         ids=["fmi", "host", "zero"])
def test_cli_refuses_a_mesh_without_the_device_engine(golden_index, capsys,
                                                      monkeypatch, flags):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    rc = cli.main(["mem", str(golden_index / "idx"),
                   str(golden_index / "reads.fq"), *flags])
    assert rc == 1
    assert "--shards" in capsys.readouterr().err


def test_cli_refuses_more_shards_than_cards(golden_index, capsys,
                                            monkeypatch):
    """On the card the shards take the first N visible cards: more than are
    visible exits 1 with the count."""
    from bwameme_tpu_torch.parallel import dp

    monkeypatch.delenv("BWAMEME_PLATFORM", raising=False)
    monkeypatch.setattr(cli, "select_device",
                        lambda: torch.device("cuda", 0))
    monkeypatch.setattr(dp, "visible_devices",
                        lambda: [torch.device("cuda", 0)])
    rc = cli.main(["mem", str(golden_index / "idx"),
                   str(golden_index / "reads.fq"), "--shards", "2"])
    assert rc == 1
    assert ("--dp-shards 1 x --shards 2: only 1 device(s) visible"
            in capsys.readouterr().err)
