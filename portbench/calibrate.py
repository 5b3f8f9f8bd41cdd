"""The readings that a cell's limits are set from, in one process on the
card: the port as the configuration states it on each of ``--seeds``, then
each control (the configuration with one guarantee broken by the flags of
``--control``, which may repeat) on each of ``--control-seeds``. Each reading
is a short window at the cell's own load, checked as a run checks it. Set-up
is paid once a variant, so a dozen seeds cost a dozen short windows.

    python3 portbench/calibrate.py --workload CELL --seconds 10 \\
        --seeds 1,2,3 --control="-w 0" --control-seeds 4,5,6 [--out FILE]

Prints one JSON line a reading, and writes them to ``--out`` too. Not run by
the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time

import run as R


def readings(cell, seeds, seconds: float, extra=(), on_card=True,
             out=None) -> list:
    genome = R.genome_mod.cached(cell.config["genome"], R.genome_dir(cell))
    prefix, _ = R.index_prefix(cell, genome)
    port = R.Port(cell, prefix, on_card, extra)
    rows = []
    for k, seed in enumerate(seeds):
        pool, text, warm = R.make_reads(cell, genome, seed, seconds)
        if k == 0:
            port.align(warm, None, keep=False)
        t0 = time.perf_counter()
        win = port.align(text, seconds)
        R._sync(on_card)
        numbers = R.check(cell, win, pool, genome, seed)
        row = {"workload": cell.name, "control": list(extra), "seed": seed,
               "units": win.units, "window_s": win.seconds,
               "check_s": time.perf_counter() - t0 - win.seconds, **numbers}
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
    port.close()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", action="append", default=[])
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        cell = R.resolve(json.load(f), a.workload)
    on_card = os.environ.get("BWAMEME_PLATFORM") != "cpu"
    seeds = [int(s) for s in a.seeds.split(",") if s]
    if seeds:
        readings(cell, seeds, a.seconds, (), on_card, a.out)
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    for c in a.control:
        readings(cell, cseeds, a.seconds, tuple(shlex.split(c)), on_card,
                 a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
