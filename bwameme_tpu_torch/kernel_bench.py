#!/usr/bin/env python3
"""Kernel-level measurements that chip_smoke.py does not make. Needs one
CUDA card and nvcc; prints the card's name and power limit, then one JSON
object a line.

    python3 bwameme_tpu_torch/kernel_bench.py launch
    python3 bwameme_tpu_torch/kernel_bench.py k1

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("launch", "k1"))
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
        for row in bench_k1():
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
