#!/usr/bin/env python3
"""Kernel-level measurements that chip_smoke.py does not make. Needs one
CUDA card and nvcc; prints the card's name and power limit, then one JSON
object a line.

    python3 bwameme_tpu_torch/kernel_bench.py launch
    python3 bwameme_tpu_torch/kernel_bench.py k1
    python3 bwameme_tpu_torch/kernel_bench.py seed [--mode M] [--wide]
    python3 bwameme_tpu_torch/kernel_bench.py sw_full

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
this index.

``sw_full``: the time of one step of the full SW's wavefront, a forward
pass over random targets of SW_STEP_ROWS rows (no early stop), for query
lengths whose columns sit in registers (K = 1, 2, 5, 8 a lane) and past
them (memory columns), each for one job alone and for SW_STEP_JOBS jobs (8
warps an SM): the card's time a call with the host out of the way over the
steps the kernel reports it ran.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

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


def bench_seed(mode: int | None = None, wide: bool | None = None):
    """Yields the rows as they are measured, in the index layout of mode and
    wide (DeviceIndex.from_host's defaults where None)."""
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
                              mode=mode, wide=wide)
    yield dict(what="the index's layout", mode=eng.di.mode,
               wide=eng.di.wide, gib=eng.di.nbytes / 2**30)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("launch", "k1", "seed", "sw_full"))
    ap.add_argument("--mode", type=int, choices=(1, 2, 3, 4), default=None,
                    help="seed: the index's memory mode (default: the "
                    "ladder's)")
    ap.add_argument("--wide", action="store_true", default=None,
                    help="seed: int64 coordinates")
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
    else:
        rows = {"k1": bench_k1,
                "seed": lambda: bench_seed(args.mode, args.wide),
                "sw_full": bench_sw_full}[args.what]()
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
