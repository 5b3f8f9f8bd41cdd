#!/usr/bin/env python3
"""Kernel-level measurements that chip_smoke.py does not make. Needs one
CUDA card and nvcc; prints the card's name and power limit, then one JSON
object a line.

    python3 bwameme_tpu_torch/kernel_bench.py launch
    python3 bwameme_tpu_torch/kernel_bench.py k1
    python3 bwameme_tpu_torch/kernel_bench.py seed [--mode M] [--wide]
                                                   [--root kmer]
    python3 bwameme_tpu_torch/kernel_bench.py sw_full
    python3 bwameme_tpu_torch/kernel_bench.py fmi
    python3 bwameme_tpu_torch/kernel_bench.py shards
    python3 bwameme_tpu_torch/kernel_bench.py shard_engine
    python3 bwameme_tpu_torch/kernel_bench.py owner_ptx

``launch``: what one call of the flat row gather costs at the seeding
batch's shape (16-byte rows, 4096 lanes, 64 KB a call) beside
torch.index_select on the same tensors: the host's time a launch (1000
calls between two drains of the stream), the card's time a call (400 calls
queued behind a spinning kernel) and the time of a call made alone; then the
same three for the wrapper's parts on their own (its argument checks,
new_empty, the bare ctypes call of the C launcher). To compare with an
earlier commit on one card, unpack it (git archive), copy this file and
bench_util.py into its package and run both trees' copies in turn; the parts
are skipped on a tree whose launch path has no ``entry``.

``k1``: the banded-SW extension kernel at chip_smoke.py's phase-2 shapes:
the 4096 pair jobs, the 1 kbp pair batch, and the coordinate round with its
jobs sorted by target length and in their given order, each timed twice, in
turns. Then the pair batch's heaviest jobs alone (1, 132 and all 4096 of
them, heaviest first, by the rows they ran times their band's cells a
lane): how much of a launch is its longest job's chain of rows.

``seed``: the three seeding rounds on the bench genome's index (100 Mbp,
built at first use under .bench_cache/) and reads of chip_smoke.py's kind.
Each round at 4096, 16384, 32768 and 65536 reads: a call made alone (the
wrapper and the launch included) and the card's time a call with the host
out of the way (calls queued behind a spinning kernel). Then, at 4096
reads, what tells which regime a round is in: the read with the most work alone on the
card (the chain no batch can be faster than), and the batch sorted by each
read's work, heaviest first, against the given order. The work is the count
of index sectors the scalar contract reads for a read, as the plain version
counts them (``ops.sa_search.Work.probes``). To share the index with another
checkout, link its .bench_cache to this one's; on a tree whose plain
versions do not count (``work=``) the rows of the batch sizes print and the
rest fails. ``--mode`` (1-4) and ``--wide`` choose the index's layout (the
variants of the kernels); by default the ladder's choice, mode 4 narrow on
this index. ``--root kmer`` seeds from the ERT k-mer root (its size as
index/ert.pick_ert_bits gives it) instead of the P-RMI.

``sw_full``: the time of one step of the full SW's wavefront, a forward
pass over random targets of SW_STEP_ROWS rows (no early stop), for query
lengths whose columns sit in registers (K = 1, 2, 5, 8 a lane) and past
them (memory columns), each for one job alone and for SW_STEP_JOBS jobs (8
warps an SM): the card's time a call with the host out of the way over the
steps the kernel reports it ran.

``fmi``: the FM-index kernels on the bench genome's FM-index (index -a
mem2's files, built at first use under .bench_cache/): fmi_smem at 4096 and
16384 reads of seed's kind, fmi_backward_ext on 128 units a read and
fmi_sa_lookup on a rank a read at both sizes, each a call made alone and
the card's time a call with the host out of the way; the primitives held
against their plain versions, and each kernel's byte bound (its distinct
occ blocks, one 32-byte sector each, and its other bytes over 3.35 TB/s),
the same blocks' bound in the two-array layout (a 16-byte count record and
a 32-byte bitmap record a block), and the random-sector rate it reaches
(the blocks' bytes over its time on the card; fmi_smem's blocks at 4096
reads, from the plain wave engine's run); ptxas's registers and stack
frame where this process built the kernels; then at 4096 reads
fmi_smem's warp steps (forward extensions and backward chunks apart), its
heaviest read alone (by the extensions it ran, the read a thread-a-read
kernel is slowest on) and the read of the longest chain of warp steps
alone, against the batch. To compare with an earlier commit's kernel,
run that tree's own copy of this file in the same call (before the
warp-a-read design, ``fmi`` there times its thread-a-read kernel).

``shards``: the sharded index's seeding kernels (csrc/seed_smem.cu built
with SEED_SHARDED) on the bench genome cut to SHARD_MBP (10 Mbp) and 4096
reads of seed's kind. First K4 (gather_chain, 4096 lanes, 16-byte rows of a
1 GiB table): us a dependent round on a table on cuda:0 and, with two cards
or more, on one on cuda:1 read from cuda:0 through a peer pointer. Then the
index's rank rows in blocks placed three ways: the whole index (the
unsharded variants), four blocks on cuda:0, and one block a visible card
when there are two or more (peer pointers over NVLink; with more than two
cards also two blocks on two cards). For each placement the four kernels
(sa_query on 8 jobs a read, the three rounds) launched on cuda:0 equal the
whole index's; a call alone and the card's time a call; the slowest read's
dependent steps, those that waited on a block on another card apart
(the kernels' counts), and the cross-card latency bound: local steps at
K4's local latency plus remote steps at its remote one. The byte bounds: the
answers' distinct sectors (the plain version's count) over 3.35 TB/s, and
the share of them on other cards over NVLink's 450 GB/s each way. Where the
blocks lie on two cards or more, the rounds again with the batch cut a
slice a card, each slice launched on its own card at once: the slowest
card's ms a round alone and queued behind a spinning kernel on every card,
and the slowest read's steps. Then ``shard_engine``'s
rows. With two cards or more, then: mem --shards N (one block a card) and
mem --dp-shards 2 --shards N/2 against mem on one card, SE and PE SAM; the
dry run over N cards (parallel/dryrun.dryrun_multichip); processes under
nccl (parallel/multihost.py), 2 of N/2 cards each and N of one card,
against one process, SE and PE SAM; and the wide jumbo index of
chip_smoke.py's phase jumbo (2^31 + 2^27 suffixes, mode 1, built on cuda:0)
whole and in 2 and 4 rank blocks, one a card: sa_query on every rotation
and the three rounds at 4096 reads equal the whole index's, the same rows
as at 10 Mbp, with the bytes each card holds.

``shard_engine``: the seeding engine's whole batch (submit_batch and
finish_batch_flat: prep, the three rounds, pack, the fetch and the sort) at
4096 reads, 10 Mbp, whole on cuda:0, 4 blocks on cuda:0 and one block a
card: host ms a batch, SMEMs equal, and the launches a round (one a card
where the engine cuts the batch over its cards). It uses the engine's
public interface alone: a copy of this file in an older tree's package
times that tree's engine.

``owner_ptx``: what the sharded variants' owner lookup compiles to: nvcc's
PTX of the sharded seeding variants of modes 4 and 1, narrow and wide, a
line a kernel entry with its division and remainder instructions (none: the
block comes from a multiply-high and one compare), its multiply-highs, its
shared-memory loads (the blocks' starts and bases) and its 64-bit read-only
global loads (the block tables, read once a thread block). Needs nvcc, not
a card; a copy of this file in an older tree's package reads that tree's
source.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's shapes
BATCH = 4096
GATHER_BYTES = 1 << 30
PAIRS_SHAPE = (4096, 151, 512)
LONG_PAIRS_SHAPE = (50, 1030, 1250)
COORD_SHAPE = (1024, 4096)


def bench_launch() -> dict:
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.ops import gather_bench as gb

    dev = torch.device("cuda", 0)
    n_rows = GATHER_BYTES // 16
    src = gb.make_table(n_rows, 4, dev, seed=4)
    idx = gb.make_lanes(n_rows, BATCH, dev, seed=BATCH)
    kern = lambda: gb.gather_flat(src, idx)
    lib = lambda: torch.index_select(src, 0, idx)
    check = (gb.gather_flat(src, idx) == lib()).all()
    out = dict(what="gather_flat, 16 B rows x 4096 lanes",
               package=os.path.relpath(os.path.dirname(gb.__file__), ROOT),
               equal=bool(check))
    fns = [("kernel", kern), ("index_select", lib)]
    from bwameme_tpu_torch.ops import launch
    if hasattr(launch, "entry"):    # the wrapper's parts, on their own
        c_fn = launch.entry("gather_bench", "gather_rows_launch", gb._declare)
        out_t = torch.empty((BATCH, 4), dtype=torch.int32, device=dev)
        ptrs = (src.data_ptr(), idx.data_ptr(), out_t.data_ptr())
        fns += [
            ("part_checks", lambda: gb._check_args(src, idx)),
            ("part_empty", lambda: src.new_empty((BATCH, 4))),
            ("part_c_launcher", lambda: c_fn(
                *ptrs, BATCH, 1, 4, launch.raw_stream(0))),
        ]
    for _ in range(2):      # twice, in turns
        for name, fn in fns:
            out.setdefault(f"{name}_host_us", []).append(bu.host_us(fn))
            out.setdefault(f"{name}_device_us", []).append(bu.queued_us(fn))
            out.setdefault(f"{name}_alone_us", []).append(
                bu.cuda_ms(fn, 50) * 1e3)
    return out


def bench_k1() -> list[dict]:
    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.ops import banded_sw_cuda
    from bwameme_tpu_torch.utils.config import MemOptions

    dev = torch.device("cuda", 0)
    opt = MemOptions()
    rng = np.random.default_rng(7)
    arrays = bu.random_pairs(rng, *PAIRS_SHAPE, opt.w)
    mat = torch.from_numpy(opt.mat.astype(np.int32)).to(dev)
    rest = (mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.pen_clip5,
            opt.zdrop)
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    long_args = (*[torch.from_numpy(a).to(dev) for a in bu.random_pairs(
        rng, *LONG_PAIRS_SHAPE, opt.w)], *rest)
    n_reads, n_regs = COORD_SHAPE
    t32, cd, lj, rj, h0 = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in bu.coord_workload(opt, rng, n_reads, n_regs, 151))
    sort = lambda j: j[:, torch.argsort(j[5], descending=True, stable=True)]
    lj_s, rj_s = sort(lj), sort(rj)
    pairs = lambda ts: banded_sw_cuda.banded_sw_pairs(*ts, *rest)
    coord = lambda l, r: bu.run_coord_round(
        banded_sw_cuda.banded_sw_coord, opt, t32, cd, l, r, h0, mat)
    row = dict(what="K1 at the smoke's shapes", pairs_ms=[], long_pairs_ms=[],
               coord_sorted_ms=[], coord_unsorted_ms=[])
    for _ in range(2):
        row["pairs_ms"].append(bu.cuda_ms(lambda: pairs(tensors), 10))
        row["long_pairs_ms"].append(bu.cuda_ms(
            lambda: banded_sw_cuda.banded_sw_pairs(*long_args), 10))
        row["coord_sorted_ms"].append(
            bu.cuda_ms(lambda: coord(lj_s, rj_s), 10))
        row["coord_unsorted_ms"].append(bu.cuda_ms(lambda: coord(lj, rj), 10))

    # the heaviest jobs alone: rows run x cells a lane of the band's width
    q, t, qlen, tlen, h0p, ws = arrays
    res = pairs(tensors)
    rows = np.maximum(res["tle"].cpu().numpy(), res["gtle"].cpu().numpy())
    weight = rows * -(-np.minimum(qlen, 2 * ws + 1) // 32)
    order = torch.from_numpy(np.argsort(-weight, kind="stable")).to(dev)
    top = int(order[0])
    alone = dict(what="banded_sw_pairs, the heaviest jobs alone",
                 rows_of_heaviest=int(rows[top]), qlen_of_heaviest=int(qlen[top]))
    for n in (1, 132, len(qlen)):
        sub = [x[order[:n]].contiguous() for x in tensors]
        alone[f"heaviest_{n}_ms"] = [bu.cuda_ms(lambda: pairs(sub), 10)
                                     for _ in range(2)]
    return [row, alone]


SEED_MBP = 100
SEED_BATCHES = (4096, 16384, 32768, 65536)


def bench_seed(mode: int | None = None, wide: bool | None = None,
               root: str = "prmi"):
    """Yields the rows as they are measured, in the index layout of mode and
    wide (DeviceIndex.from_host's defaults where None), from ``root``."""
    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops import sa_search as ss
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    dev = torch.device("cuda", 0)
    idx = load_index(bu.get_index(SEED_MBP))
    eng = DeviceSeedingEngine(idx, MemOptions(), lanes=BATCH, device=dev,
                              mode=mode, wide=wide, root=root)
    yield dict(what="the index's layout", mode=eng.di.mode,
               wide=eng.di.wide, root=eng.di.root, kmer_bits=eng.di.kmer_bits,
               gib=eng.di.nbytes / 2**30)
    rng = np.random.default_rng(17)
    reads = bu.simulated_reads(idx.text, idx.l_pac, max(SEED_BATCHES), 151,
                               rng, bu.planted_repeats(SEED_MBP))
    names = ("seed_round1", "seed_round2", "seed_round3")

    def times(batch, k, queued=100):
        fn = lambda: batch.run(k, batch.kernels[k])
        return dict(alone_ms=[bu.cuda_ms(fn, 10) for _ in range(2)],
                    device_ms=[bu.queued_us(fn, queued) / 1e3
                               for _ in range(2)])

    for n in SEED_BATCHES:
        batch = bu.Rounds(eng, reads[:n], dev)
        yield dict(what=f"the rounds at {n} reads", **{
            name: times(batch, k) for k, name in enumerate(names)})

    # at one batch: each read's work, the heaviest read alone, sorted reads
    batch = bu.Rounds(eng, reads[:BATCH], dev)
    for k, name in enumerate(names):
        work = ss.Work(BATCH, dev)
        batch.run(k, batch.plain[k], work=work)
        work = work.probes.cpu().numpy()
        order = np.argsort(-work, kind="stable")
        alone = bu.Rounds(eng, [reads[order[0]]], dev)
        by_work = bu.Rounds(eng, [reads[i] for i in order], dev)
        yield dict(
            what=f"{name} at {BATCH} reads: the heaviest read alone, and "
            "the batch sorted by work against its given order",
            work_probes_mean=float(work.mean()),
            work_probes_max=int(work.max()),
            heaviest_alone=times(alone, k), sorted=times(by_work, k),
            given=times(batch, k))


SHARD_MBP = 10
NVLINK_BPS = 450e9     # each way, to the other cards of an H100 SXM host
# K4 at a seeding batch's lanes: 16-byte rows of a 1 GiB table, chains of
# CHAIN_ROUNDS and 64 times as many dependent loads
CHAIN_ROUNDS = 15
CHAIN_LANES = 4096
QUERY_JOBS = 8      # sa_query jobs a read


def chain_us(src, idx, device=None) -> float:
    """K4's time a dependent round, launched on ``device`` (default: src's
    card): the difference between chains of 64 x CHAIN_ROUNDS and
    CHAIN_ROUNDS rounds over the rounds between them."""
    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.ops.gather_bench import gather_chain_cuda

    short = bu.cuda_ms(lambda: gather_chain_cuda(src, idx, CHAIN_ROUNDS,
                                                 device), 10)
    long = bu.cuda_ms(lambda: gather_chain_cuda(src, idx, 64 * CHAIN_ROUNDS,
                                                device), 10)
    return (long - short) * 1e3 / (63 * CHAIN_ROUNDS)


def bench_chain_latency(cards):
    """K4 (``gather_chain``) at CHAIN_LANES lanes on a table on cuda:0 and,
    with two cards or more, on an equal table on cuda:1 read from cuda:0
    through a peer pointer: us a dependent round, local and remote. Both
    chains must end where the plain version's does."""
    import torch

    from bwameme_tpu_torch.ops import gather_bench as gb
    from bwameme_tpu_torch.ops import seed_smem_cuda

    dev = cards[0]
    rows = GATHER_BYTES // 16
    src = gb.make_table(rows, 4, dev, seed=5)
    idx = gb.make_lanes(rows, CHAIN_LANES, dev, seed=6)
    want = gb.gather_chain_torch(src, idx, CHAIN_ROUNDS)
    if not torch.equal(gb.gather_chain_cuda(src, idx, CHAIN_ROUNDS), want):
        raise RuntimeError("gather_chain differs from its plain version")
    row = dict(what=f"K4 gather_chain, {CHAIN_LANES} lanes, 16-byte rows "
               f"of a {GATHER_BYTES >> 30} GiB table", rounds=CHAIN_ROUNDS,
               local_us=chain_us(src, idx), remote_us=None)
    if len(cards) > 1:
        far = gb.make_table(rows, 4, cards[1], seed=5)
        seed_smem_cuda.peer_access(dev, [cards[1]])
        got = gb.gather_chain_cuda(far, idx, CHAIN_ROUNDS, dev)
        if not torch.equal(got, want):
            raise RuntimeError("gather_chain through a peer pointer differs "
                               "from its plain version")
        row["remote_us"] = chain_us(far, idx, dev)
        row["what"] += f"; the table on {cards[1]}, launched on {dev}"
        del far
    del src
    torch.cuda.empty_cache()
    return row


def query_jobs(batch, rng, per_read: int):
    """sa_query jobs cut from a batch's reads: each read's strands at random
    pivots, whole windows, min_intv 1 to 21; (row, pivot, v, min_intv)."""
    import numpy as np
    import torch

    R = batch.R
    _, nf, nr, _ = batch.prep
    rd = np.repeat(np.arange(R), per_read)
    lens = batch.lens.cpu().numpy()[rd]
    piv = (rng.random(R * per_read) * np.maximum(lens, 1)).astype(np.int64)
    rev = rng.integers(0, 2, R * per_read)
    v = np.where(rev == 1, nr.cpu().numpy()[rd, piv],
                 nf.cpu().numpy()[rd, piv]) - piv
    mi = rng.choice([1, 1, 2, 3, 21], R * per_read)
    return [torch.from_numpy(a.astype(np.int32)).to(batch.lens.device)
            for a in (rd + rev * R, piv, v, mi)]


def slowest_steps(di, run, n: int, dev) -> dict:
    """The slowest warp's dependent steps, as the kernel counts them, of one
    run(counts=...) on ``dev``: all, and those that waited on a block on
    another card (none for a whole index)."""
    import torch

    from bwameme_tpu_torch.ops import seed_smem_cuda

    counts = torch.zeros((seed_smem_cuda.count_rows(di), n),
                         dtype=torch.int32, device=dev)
    run(counts=counts)
    c = counts.cpu()
    k = int(c[1].argmax())
    remote = int(c[2, k]) if c.shape[0] > 2 else 0
    return dict(steps=int(c[1, k]), local_steps=int(c[1, k]) - remote,
                remote_steps=remote,
                remote_steps_max=int(c[2].max()) if c.shape[0] > 2 else 0)


def latency_bound_ms(steps: dict, lat: dict) -> float:
    """Local steps at K4's local latency and remote ones at its remote
    latency (the local one where no remote was measured)."""
    remote_us = lat["remote_us"] or lat["local_us"]
    return (steps["local_steps"] * lat["local_us"]
            + steps["remote_steps"] * remote_us) / 1e3


def kernel_rows(di, batch, jobs, wants, lat, sectors=None, remote=0.0,
                qbuf=None):
    """The four seeding kernels of an index on one batch launched on the
    batch's card: each equal to ``wants`` (those of the whole index), card
    ms (a call alone, and with the host out of the way), the slowest read's
    local and remote steps and the cross-card latency bound; with the
    answers' sectors, the byte bound (HBM, and the remote share of them
    over NVLink); ``qbuf``: the jobs' query buffer, by default the
    batch's."""
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.ops import seed_smem_cuda

    dev = batch.lens.device
    qbuf = batch.prep[0] if qbuf is None else qbuf
    runs = {"sa_query": lambda **kw: seed_smem_cuda.sa_query(di, qbuf, *jobs,
                                                             **kw)}
    for k in range(3):
        runs[f"seed_round{k + 1}"] = (
            lambda k=k, **kw: batch.run(k, batch.kernels[k], **kw))
    out = {}
    for name, run in runs.items():
        got = run()
        same = (torch.equal(got, wants[name]) if name == "sa_query"
                else same_rounds(got, wants[name]))
        if not same:
            raise RuntimeError(f"{name}: another answer than the whole "
                               "index's")
        n = jobs[0].shape[0] if name == "sa_query" else batch.R
        steps = slowest_steps(di, run, n, dev)
        row = dict(alone_ms=bu.cuda_ms(run, 10),
                   device_ms=bu.queued_us(run, 100) / 1e3, **steps,
                   latency_bound_ms=latency_bound_ms(steps, lat))
        if sectors is not None:
            nbytes = sectors[name] * bu.SECTOR
            row.update(answer_sectors=sectors[name],
                       hbm_bound_ms=nbytes / bu.HBM_BPS * 1e3,
                       nvlink_bound_ms=remote * nbytes / NVLINK_BPS * 1e3)
        out[name] = row
    return out


def cut_rows(eng, reads, wants, lat):
    """The three rounds with the batch cut over the engine's cards, a slice
    launched on each card's view of the index at once: each slice equal to
    the whole index's rows, and per round the slowest card's ms, a call made
    alone on every card (CUDA events around one launch a card, the
    wrappers' host time included, as ``alone_ms``) and with the host out of
    the way (``queued_ms``), with each card's queued ms, and the slowest
    read's local and remote steps over the slices."""
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.seeding.engine import cut_batch

    cut = cut_batch(len(reads), eng.cards)
    slices = []
    for d, b, e in cut:
        with torch.cuda.device(d):
            sub = _view_engine(eng, d)
            slices.append((d, b, e, sub, bu.Rounds(sub, reads[b:e], d)))
    out = dict(slices=[[str(d), b, e] for d, b, e in cut])
    for k in range(3):
        name = f"seed_round{k + 1}"
        worst = None
        for d, b, e, sub, rb in slices:
            got = rb.run(k, rb.kernels[k])
            want = wants[name]
            if not same_rounds(got, tuple(
                    x[..., b:e, :].to(d) if x.dim() == 3 else x[b:e].to(d)
                    for x in want)):
                raise RuntimeError(f"{name}: the slice on {d} differs from "
                                   "the whole index's rows")
            st = slowest_steps(sub.di, lambda counts, rb=rb: rb.run(
                k, rb.kernels[k], counts=counts), e - b, d)
            if worst is None or st["steps"] > worst["steps"]:
                worst = st
        runs = [(d, lambda rb=rb: rb.run(k, rb.kernels[k]))
                for d, _, _, _, rb in slices]
        queued = cards_ms(runs, 100, spin=True)
        out[name] = dict(alone_ms=statistics.median(
            max(cards_ms(runs, 1)) for _ in range(10)),
            queued_ms=max(queued), card_queued_ms=queued, **worst,
            latency_bound_ms=latency_bound_ms(worst, lat))
    return out


def cards_ms(runs, n: int, spin: bool = False) -> list:
    """Each card's ms a call of its run, n calls a card issued in turns
    across the cards, timed by CUDA events on each card's stream; ``spin``
    queues them behind a kernel that spins on every card first, so that the
    host's launch time is out of the way."""
    import torch

    for d, fn in runs:
        fn()
        torch.cuda.synchronize(d)
    ev = []
    for d, _ in runs:
        with torch.cuda.device(d):
            if spin:
                torch.cuda._sleep(200_000_000)
            ev.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
            ev[-1][0].record()
    for _ in range(n):
        for d, fn in runs:
            with torch.cuda.device(d):
                fn()
    for (d, _), (_, end) in zip(runs, ev):
        with torch.cuda.device(d):
            end.record()
    for d, _ in runs:
        torch.cuda.synchronize(d)
    return [a.elapsed_time(b) / n for a, b in ev]


def _view_engine(eng, dev):
    """A shallow copy of an engine over its index's view from ``dev``."""
    import copy

    sub = copy.copy(eng)
    sub.di = eng.di.on(dev)
    return sub


def bench_shards():
    """Yields the rows of ``shards`` as they are measured."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch import cli
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops import sa_search as ss
    from bwameme_tpu_torch.ops import seed_smem
    from bwameme_tpu_torch.parallel import multihost
    from bwameme_tpu_torch.parallel.dryrun import dryrun_multichip
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    lat = bench_chain_latency(cards)
    yield lat
    prefix = bu.get_index(SHARD_MBP)
    idx = load_index(prefix)
    eng = DeviceSeedingEngine(idx, MemOptions(), lanes=BATCH, device=dev)
    rng = np.random.default_rng(17)
    reads = bu.simulated_reads(idx.text, idx.l_pac, BATCH, 151, rng,
                               bu.planted_repeats(SHARD_MBP))
    whole = bu.Rounds(eng, reads, dev)
    jobs = query_jobs(whole, np.random.default_rng(19), QUERY_JOBS)
    wants, sectors = {}, {}
    work = ss.Work(jobs[0].shape[0], dev)
    wants["sa_query"] = seed_smem.sa_query_torch(eng.di, whole.prep[0],
                                                 *jobs, work=work)
    sectors["sa_query"] = work.answer_sectors()
    for k in range(3):
        name = f"seed_round{k + 1}"
        wants[name] = whole.run(k, whole.kernels[k])
        work = ss.Work(BATCH, dev)
        whole.run(k, whole.plain[k], work=work)
        sectors[name] = work.answer_sectors()
    placements = {"whole": None, "4 blocks on cuda:0": [dev] * 4}
    for n in sorted({2, n_cards} if n_cards >= 2 else ()):
        placements[f"{n} blocks, one a card"] = cards[:n]
    for what, devices in placements.items():
        sharded = eng
        if devices is not None:
            sharded = copy.copy(eng)
            sharded.di = eng.di.shard(devices)
        batch = bu.Rounds(sharded, reads, dev)
        remote = (0.0 if devices is None else
                  sum(d != dev for d in devices) / len(devices))
        row = dict(what=f"the kernels at {BATCH} reads ({len(jobs[0])} "
                   f"sa_query jobs), {SHARD_MBP:g} Mbp: {what}, launched "
                   f"on {dev}", remote_share=remote,
                   card_bytes=card_bytes(sharded.di))
        row.update(kernel_rows(sharded.di, batch, jobs, wants, lat, sectors,
                               remote))
        yield row
        if devices is not None and len(set(devices)) > 1:
            yield dict(what=f"the rounds at {BATCH} reads, {SHARD_MBP:g} "
                       f"Mbp: {what}, the batch cut a slice a card",
                       **cut_rows(sharded, reads, wants, lat))
        del batch, sharded
    yield from bench_shard_engine(eng, idx, reads)
    if n_cards < 2:
        return
    work = tempfile.mkdtemp(prefix="bwameme_shards_")
    fq = os.path.join(work, "reads.fq")
    r1, r2 = (os.path.join(work, f"reads_{k}.fq") for k in (1, 2))
    write_fastq(fq, reads[:1024])
    # pairs: the reads two by two, the second reverse-complemented back
    write_fastq(r1, reads[0:1024:2])
    write_fastq(r2, [np.where(c < 4, 3 - c, c)[::-1].astype(np.uint8)
                     for c in reads[1:1024:2]])
    sams = {}
    for ins in ((fq,), (r1, r2)):
        for flags in ((), ("--shards", str(n_cards)),
                      ("--dp-shards", "2", "--shards", str(n_cards // 2))):
            out = os.path.join(work, f"{len(sams)}.sam")
            rc = cli.main(["mem", prefix, *ins, "-o", out, *flags])
            if rc != 0:
                raise RuntimeError(f"mem {' '.join(flags)} exited {rc}")
            with open(out) as f:
                sams["PE" if len(ins) > 1 else "SE",
                     " ".join(flags) or "one card"] = [
                    ln for ln in f if not ln.startswith("@PG")]
    for end in ("SE", "PE"):
        one = sams.pop((end, "one card"))
        for (e, flags), sam in sams.items():
            if e == end and sam != one:
                raise RuntimeError(f"mem {flags} {end}: another SAM than one "
                                   "card's")
        yield dict(what=f"mem {', '.join(f for e, f in sams if e == end)} "
                   f"== one card's {end} SAM on 1024 reads at "
                   f"{SHARD_MBP:g} Mbp", records=len(one))
    yield dict(what=f"dryrun_multichip({n_cards})",
               **dryrun_multichip(n_cards))
    del eng, whole
    one = multihost.single_process("cuda:0")
    for n_procs, k in dict.fromkeys(((2, n_cards // 2), (n_cards, 1))):
        t0 = time.perf_counter()
        got = multihost.run_multihost(n_procs, "nccl", shards=k, timeout=600)
        if got != one:
            raise RuntimeError(f"{n_procs} nccl processes x {k} cards: "
                               "another SAM than one process's")
        yield dict(what=f"{n_procs} processes under nccl, {k} card(s) each "
                   "== one process's SE and PE SAM",
                   records=[g.count("\n") for g in got],
                   seconds=time.perf_counter() - t0)
    yield from bench_jumbo_shards(cards, lat)


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for i, c in enumerate(reads):
            seq = "".join("ACGTN"[x] for x in c)
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


ENGINE_REPS = 10


def bench_shard_engine(eng=None, idx=None, reads=None):
    """The seeding engine's whole batch (prep, the three rounds, pack, the
    fetch and the host's sort: submit_batch then finish_batch_flat) at
    BATCH reads on the bench genome cut to SHARD_MBP: whole on cuda:0, 4
    blocks on cuda:0, and one block a visible card when there are two or
    more; the median host ms of ENGINE_REPS batches, each batch's SMEMs the
    whole engine's. Where the engine cuts a batch over its cards, the launches
    of a round are one a card. Uses the engine's public interface only, so
    that a copy of this file in an older tree times that tree's engine."""
    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops.launch import stats, variant
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    if eng is None:
        idx = load_index(bu.get_index(SHARD_MBP))
        eng = DeviceSeedingEngine(idx, MemOptions(), lanes=BATCH, device=dev)
        reads = bu.simulated_reads(idx.text, idx.l_pac, BATCH, 151,
                                   np.random.default_rng(17),
                                   bu.planted_repeats(SHARD_MBP))
    want = None
    placements = {"whole": None, "4 blocks on cuda:0": [dev] * 4}
    if n_cards >= 2:
        placements[f"{n_cards} blocks, one a card"] = [
            torch.device("cuda", i) for i in range(n_cards)]
    for what, shards in placements.items():
        e = eng if shards is None else DeviceSeedingEngine(
            idx, MemOptions(), lanes=BATCH, device=dev, shards=shards,
            mode=eng.di.mode)

        def batch():
            flat = e.finish_batch_flat(e.submit_batch(reads))
            return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
                    for lst in flat.to_lists()]

        got = batch()
        want = want or got
        if got != want:
            raise RuntimeError(f"the engine, {what}: other SMEMs than the "
                               "whole index's")
        name = variant("seed_round1", e.di.mode, e.di.wide,
                       sharded=shards is not None)
        stats.reset()
        times = []
        for _ in range(ENGINE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = stats.launches.get(name, 0) / ENGINE_REPS
        slices = len(getattr(e, "cards", [dev]))
        if launches != slices:
            raise RuntimeError(f"the engine, {what}: {launches} launches of "
                               f"{name} a batch, {slices} cards")
        yield dict(what=f"the engine's batch of {BATCH} reads, "
                   f"{SHARD_MBP:g} Mbp: {what}", host_ms=statistics.median(
                       times), host_ms_all=times, round1_launches=launches)
        del e
        torch.cuda.empty_cache()


def same_rounds(got, want) -> bool:
    """A round's results equal: the counts, the drops and the slots in use
    (the others are left as they were allocated)."""
    import torch

    used = (torch.arange(got[0].shape[2], device=got[0].device)[None, :]
            < got[1][:, None])
    return (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            and torch.equal(got[0][:, used], want[0][:, used]))


def card_bytes(di) -> dict:
    """The bytes of an index's planes (blocks, the replicated planes and the
    tables of every view of a sharded index) on each device; raises unless
    each view's replicated planes and tables lie on its own device."""
    from bwameme_tpu_torch.index.device import ShardedPlane

    views = di.views if di.shards is not None else {di.device: di}
    out, seen = {}, set()
    for d, view in views.items():
        for name, t in view.planes.items():
            own = t.table if isinstance(t, ShardedPlane) else t
            if own.device != d:
                raise RuntimeError(f"the view from {d}: {name} on "
                                   f"{own.device}")
            parts = [*t.blocks, t.table] if isinstance(t, ShardedPlane) \
                else [t]
            for x in parts:
                key = (str(x.device), x.data_ptr())
                if key not in seen:
                    seen.add(key)
                    out[str(x.device)] = (out.get(str(x.device), 0)
                                          + x.numel() * x.element_size())
    return out


# chip_smoke.py's jumbo index: a JUMBO_P-base block tiled to 2^31 + 2^27
# suffixes, mode 1 wide
JUMBO_P, JUMBO_M = 4096, 16
JUMBO_N = (2**31 + 2**27) // JUMBO_P * JUMBO_P
JUMBO_L = 48


def bench_jumbo_shards(devices, lat):
    """The wide jumbo index (bench_util.periodic_index, built on the first
    of ``devices``) whole and in 2 and 4 rank blocks, one a device of the
    list: sa_query on every rotation's first JUMBO_L bases (against the
    closed form too) and the three rounds on BATCH reads cut from the text,
    each placement's answers the whole index's; card ms a call launched on
    the first device, the slowest read's local and remote steps and the
    cross-card latency bound, bytes a card; then the rounds with the batch
    cut a slice a card."""
    import types

    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.index.packing import pack_words
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    dev = devices[0]
    p, L = JUMBO_P, JUMBO_L
    t0 = time.perf_counter()
    di, block, rot = bu.periodic_index(JUMBO_N, p, JUMBO_M, seed=9,
                                       device=dev)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    tile2 = np.tile(block, 2)
    qbuf = np.full((p, L // 16 + 3), 0xFFFFFFFF, np.uint32)
    qbuf[:, : L // 16] = np.stack([pack_words(tile2[r: r + L])
                                   for r in rot])
    qbuf = torch.from_numpy(qbuf.view(np.int32)).to(dev)
    jobs = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        np.arange(p), np.zeros(p), np.full(p, L), np.ones(p))]
    closed = np.array([bu.expected_hit(block, rot, JUMBO_N, p, JUMBO_M, k,
                                       L) for k in range(p)]).T
    reads = bu.periodic_reads(block, BATCH, 151, np.random.default_rng(31))
    wants = None
    for n in (1, 2, 4):
        if n > len(devices):
            break
        sdi = di if n == 1 else di.shard(devices[:n])
        eng = types.SimpleNamespace(
            di=sdi, opt=MemOptions(), max_smems=96, max_reseeds=16,
            _batch_matrix=DeviceSeedingEngine._batch_matrix,
            cards=list(dict.fromkeys(sdi.shards or [dev])))
        batch = bu.Rounds(eng, reads, dev)
        if wants is None:
            from bwameme_tpu_torch.ops import seed_smem_cuda

            wants = {"sa_query": seed_smem_cuda.sa_query(di, qbuf, *jobs)}
            if not (wants["sa_query"].cpu().numpy() == closed).all():
                raise RuntimeError("sa_query on the jumbo index differs "
                                   "from the closed form")
            for k in range(3):
                wants[f"seed_round{k + 1}"] = batch.run(k, batch.kernels[k])
        row = dict(what=f"the jumbo index ({JUMBO_N} suffixes, mode 1 "
                   f"wide), {'whole' if n == 1 else f'{n} blocks, one a card'}"
                   f": sa_query on {p} rotations and the rounds at {BATCH} "
                   f"reads == the whole index's, launched on {dev}",
                   card_bytes=card_bytes(sdi), built_s=built)
        row.update(kernel_rows(sdi, batch, jobs, wants, lat, qbuf=qbuf))
        yield row
        if n > 1:
            yield dict(what=f"the jumbo index in {n} blocks, one a card: "
                       "the rounds with the batch cut a slice a card",
                       **cut_rows(eng, reads, wants, lat))
        del sdi, eng, batch
        torch.cuda.empty_cache()


def owner_ptx(root: str = ROOT) -> list[dict]:
    """The PTX of the sharded seeding variants of modes 4 and 1 (narrow and
    wide in each) of the tree at ``root``, as nvcc makes it from
    csrc/seed_smem.cu with the build's flags: a row a kernel entry with its
    division and remainder instructions (div./rem.), its multiply-highs
    (mul.hi), its shared-memory loads and its 64-bit read-only global loads
    (the block tables' __ldg)."""
    import re
    import tempfile

    from bwameme_tpu_torch.ops import build

    src = os.path.join(root, "bwameme_tpu_torch", "csrc", "seed_smem.cu")
    rows = []
    for mode in (4, 1):
        out = os.path.join(tempfile.mkdtemp(prefix="bwameme_ptx_"), "s.ptx")
        flags = [f for f in build.NVCC_FLAGS if f not in (
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([build.find_nvcc(), *flags, "-fmad=false",
                        f"-DSEED_MODE={mode}", "-DSEED_SHARDED", "-ptx",
                        "-o", out, src], check=True, capture_output=True)
        text = open(out).read()
        for m in re.finditer(r"\.entry (\w+)\((.*?)\n\}", text, re.S):
            name, body = m[1], m[2]
            if "round" not in name and "query" not in name:
                continue
            rows.append(dict(
                mode=mode, entry=name,
                # the template <MODE, RT, KMER>: RT long long mangles as x
                wide=f"ILi{mode}Ex" in name,
                div_rem=len(re.findall(r"\b(?:div|rem)\.\w+", body)),
                mul_hi=sorted(set(re.findall(r"mul\.hi\.\w+", body))),
                ld_shared=len(re.findall(r"\bld\.shared\.", body)),
                ld_global_nc_u64=len(re.findall(r"ld\.global\.nc\.[us]64",
                                                 body))))
    return rows


SW_STEP_QLENS = (32, 64, 151, 256, 300)
SW_STEP_ROWS = 4000
SW_STEP_JOBS = 132 * 8


def bench_sw_full():
    """Yields a row a query length."""
    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.ops import sw_full_cuda
    from bwameme_tpu_torch.utils.config import MemOptions

    dev = torch.device("cuda", 0)
    opt = MemOptions()
    rng = np.random.default_rng(5)
    mat = torch.from_numpy(opt.mat.astype(np.int32)).to(dev)
    for qlen in SW_STEP_QLENS:
        row = dict(what=f"sw_full forward pass, Q={qlen}, T={SW_STEP_ROWS}")
        for n in (1, SW_STEP_JOBS):
            q, t = (torch.from_numpy(rng.integers(0, 4, (n, w)).astype(
                np.int32)).to(dev) for w in (qlen, SW_STEP_ROWS))
            lens = [torch.full((n,), v, dtype=torch.int32, device=dev)
                    for v in (qlen, SW_STEP_ROWS, opt.min_seed_len)]
            steps = torch.zeros((2, n), dtype=torch.int32, device=dev)
            call = lambda: sw_full_cuda.sw_full_pairs(
                q, t, *lens[:2], mat, lens[2], opt.o_del, opt.e_del,
                opt.o_ins, opt.e_ins, with_start=False, steps=steps)
            us = bu.queued_us(call, 20)
            row[f"jobs_{n}_us"] = us
            row[f"jobs_{n}_us_a_step"] = us / int(steps[0].max())
        yield row


FMI_BATCHES = (4096, 16384)
FMI_UNITS_A_READ = 128


def bench_fmi():
    """Yields the rows as they are measured."""
    import numpy as np
    import torch

    from bwameme_tpu_torch import bench_util as bu
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.index.fmindex import load_fm_index
    from bwameme_tpu_torch.ops import build, fmi_search, fmi_search_cuda
    from bwameme_tpu_torch.seeding.fmi_engine import (FmiDeviceEngine,
                                                      FmiWork)
    from bwameme_tpu_torch.utils.config import MemOptions

    log = build.build().log
    yield dict(what="ptxas, the FM-index kernels (None: built before)",
               **{k: bu.ptxas_usage(log, f"{k}_kernel") for k in (
                   "fmi_backward_ext", "fmi_sa_lookup", "fmi_smem")})
    dev = torch.device("cuda", 0)
    idx = load_index(bu.get_index(SEED_MBP))
    fm = load_fm_index(bu.get_fm_index(SEED_MBP))
    eng = FmiDeviceEngine(idx, MemOptions(), fm=fm, device=dev)
    dfm = eng.dfm
    rng = np.random.default_rng(17)
    reads = bu.simulated_reads(idx.text, idx.l_pac, max(FMI_BATCHES), 151,
                               rng, bu.planted_repeats(SEED_MBP))

    def times(fn, queued=50):
        return dict(alone_ms=[bu.cuda_ms(fn, 10) for _ in range(2)],
                    device_ms=[bu.queued_us(fn, queued) / 1e3
                               for _ in range(2)])

    def bounds(row, blocks, other_bytes):
        """The byte bounds and the random-sector rate (bench_util.fmi_row)
        of a row's blocks, at its fastest time on the card."""
        row.update(bu.fmi_row(
            fmi_search.block_sectors(blocks), bu.two_array_sectors(blocks),
            other_bytes, min(row["device_ms"])))
        return row

    def smem_times(batch):
        """fmi_smem on the batch already on the card: the launch alone,
        not the host's matrix and copies, which would sit between the
        queued calls."""
        up = eng._upload(batch)
        return times(lambda: eng._smem(*up, eng.max_smems))

    n1 = fm.n + 1
    for n in FMI_BATCHES:
        u = FMI_UNITS_A_READ * n
        k = rng.integers(0, n1, u)
        s = np.minimum(rng.integers(0, 64, u), n1 - k)
        units = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in
                 (k, rng.integers(0, n1, u), s, rng.integers(0, 4, u))]
        ranks = torch.from_numpy(rng.integers(0, n1, n).astype(
            np.int32)).to(dev)
        batch = reads[:n]
        ext = lambda: fmi_search_cuda.backward_ext(dfm, *units)
        look = lambda: fmi_search_cuda.sa_lookup(dfm, ranks)
        visited = []
        if not (torch.equal(ext(), fmi_search.backward_ext_torch(dfm, *units))
                and torch.equal(look(), fmi_search.sa_lookup_torch(
                    dfm, ranks, visited=visited))):
            raise RuntimeError("an FM-index kernel differs from its plain "
                               "version")
        yield dict(
            what=f"the FM-index kernels at {n} reads",
            fmi_smem=smem_times(batch),
            fmi_backward_ext=bounds(dict(units=u, **times(ext)),
                                    fmi_search.ext_blocks(units[0], units[2]),
                                    u * (16 + 12)),
            fmi_sa_lookup=bounds(dict(ranks=n, **times(look)),
                                 torch.cat(visited), n * (4 + 4 + 4)))
    batch = reads[:BATCH]
    work = FmiWork(len(batch))
    eng.collect_smems_waves(batch, work)
    codes, lens = eng._upload(batch)
    _, nsm, k_steps = eng._smem(codes, lens, eng.max_smems, steps=True)
    n_sm = int(torch.clamp(nsm, max=eng.max_smems).sum())
    fwd, bwd, bwd_ext = k_steps.cpu().numpy()
    ext, chain = fwd + bwd_ext, fwd + bwd
    top, slow = int(np.argmax(ext)), int(np.argmax(chain))
    yield dict(what=f"fmi_smem at {BATCH} reads: its bounds, the warp's "
               "steps, the heaviest read and the longest chain alone "
               "against the batch",
               extensions_max=int(ext.max()), heaviest=top,
               heaviest_steps=[int(fwd[top]), int(bwd[top])],
               steps_max=int(chain.max()), slowest=slow,
               slowest_steps=[int(fwd[slow]), int(bwd[slow])],
               steps_mean=[float(fwd.mean()), float(bwd.mean())],
               heaviest_alone=smem_times([batch[top]]),
               slowest_alone=smem_times([batch[slow]]),
               batch=bounds(smem_times(batch), work.blocks(),
                            codes.numel() + 4 * len(batch) + 16 * n_sm))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("launch", "k1", "seed", "sw_full",
                                     "fmi", "shards", "shard_engine",
                                     "owner_ptx"))
    ap.add_argument("--mode", type=int, choices=(1, 2, 3, 4), default=None,
                    help="seed: the index's memory mode (default: the "
                    "ladder's)")
    ap.add_argument("--wide", action="store_true", default=None,
                    help="seed: int64 coordinates")
    ap.add_argument("--root", choices=("prmi", "kmer"), default="prmi",
                    help="seed: the P-RMI (default) or the ERT k-mer root")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.what == "launch":
        print(json.dumps(bench_launch()))
    elif args.what == "owner_ptx":
        for row in owner_ptx():
            print(json.dumps(row), flush=True)
    else:
        rows = {"k1": bench_k1,
                "seed": lambda: bench_seed(args.mode, args.wide, args.root),
                "sw_full": bench_sw_full, "fmi": bench_fmi,
                "shards": bench_shards,
                "shard_engine": bench_shard_engine}[args.what]()
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
