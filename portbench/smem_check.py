"""Two checks of an FM-index cell on the card, beside its runs (not run by
the benchmark's runs):

    python3 portbench/smem_check.py --workload fmi-pe151 --seed 1 \\
        [--reads 512] [--sam-against celegans-meme-m4] [--out DIR]

``smems``: ``--reads`` reads drawn from the cell's pool of ``--seed`` (both
mates of half as many pairs, paired-end) are seeded by the timed path, the
port's engine as ``run.Port`` sets it up (``submit_batch``, then
``finish_batch_flat``, or ``finish_batch`` where the batch outgrew the
packed buffer), and held to the plain reference (``reference/smem.py``) over
the learned index's suffix array of the same genome: per read, the multiset
of (start, end, occurrences), and each SMEM's positions.

``sam``: the pool's first chunk (the configuration's ``chunk_bp``) through
the port's ``mem`` with the configuration's flags and with those of the
configuration ``--sam-against`` (the learned index), a process each; the
SAMs must be the same but for ``@PG``. The differing records go to
``--out``.

Prints one JSON line; exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import run as R
from pbench import wgsim
from reference import smem


def pick(pool, n: int, paired: bool, seed: int) -> list:
    """``n`` reads of the pool (``n // 2`` pairs, both mates, paired-end),
    drawn from the seed."""
    rng = np.random.default_rng([seed, 77])
    units = n // 2 if paired else n
    at = np.sort(rng.choice(pool.n, units, replace=False))
    return [pool.seq[m][u] for u in at for m in range(len(pool.seq))]


def check_smems(port, reads) -> dict:
    eng = port.aligner.engine
    token = eng.submit_batch(reads)
    flat = eng.finish_batch_flat(token)
    got = flat.to_lists() if flat is not None else eng.finish_batch(token)
    idx, opt = port.idx, port.aligner.opt
    ref = smem.SmemReference(
        idx.text, idx.sa, smem.Options(opt.min_seed_len, opt.split_len,
                                       opt.split_width, opt.max_mem_intv),
        n=2 * idx.l_pac)
    t0 = time.perf_counter()
    want = ref.smems(reads)
    ref_s = time.perf_counter() - t0
    sa = eng.sa_positions
    bad, positions, texts = 0, 0, []
    for i, (g, w) in enumerate(zip(got, want)):
        gc = collections.Counter((s.start, s.end, s.hitcount) for s in g)
        wc = collections.Counter(x[:3] for x in w)
        same = gc == wc
        if same:
            where = {x[:3]: x[3:] for x in w}
            for s in g:
                lo, hi = where[(s.start, s.end, s.hitcount)]
                p = sorted(sa[s.sa_lo: s.sa_lo + s.hitcount].tolist())
                same &= p == ref.positions(lo, hi, s.end - s.start)
                positions += s.hitcount
        if not same:
            bad += 1
            texts.append(f"read {i}: port {sorted(gc.elements())} "
                         f"reference {sorted(wc.elements())}")
    return {"reads": len(reads), "reads_differing": bad,
            "smems": sum(map(len, want)), "positions": positions,
            "flat": flat is not None, "reruns": eng.reruns,
            "reference_s": ref_s, "faults": texts[:20]}


def other_config(bench: dict, name: str, cell) -> dict:
    """The configuration ``name``, which must be of the cell's genome."""
    cfg = next(c for c in bench["configs"] if c["name"] == name)
    with open(os.path.join(R.ROOT, cfg["file"])) as f:
        other = json.load(f)
    if other["genome"] != cell.config["genome"]:
        raise ValueError(f"{name} is of another genome")
    return other


def check_sam(cell, other: dict, genome, prefix: str, seed: int,
              out: str) -> dict:
    t = cell.traffic
    mates = 2 if t["paired"] else 1
    units = math.ceil(cell.config["chunk_bp"] / sum(t["read_len"][:mates]))
    haps = wgsim.haplotypes(genome.code, t, seed)
    reads = wgsim.generate(haps, t, seed, 2, units, genome.offsets)
    res = {"units": units}
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "chunk.fq")
        with open(fq, "w") as f:
            f.write(wgsim.fastq_text(reads, 0, t["error_rate"]))
        sams = []
        for name, args in ((cell.config["name"], cell.config["mem_args"]),
                           (other["name"], other["mem_args"])):
            path = os.path.join(tmp, f"{name}.sam")
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "bwameme_tpu_torch.cli", "mem", *args,
                 *(["-p"] if t["paired"] else []), "-o", path, prefix, fq],
                cwd=R.ROOT, capture_output=True, text=True)
            res[f"{name}_s"] = time.perf_counter() - t0
            if p.returncode:
                raise RuntimeError(f"mem {' '.join(args)}: {p.stderr[-2000:]}")
            with open(path) as f:
                sams.append([ln for ln in f if not ln.startswith("@PG")])
    a, b = sams
    diff = [(x, y) for x, y in zip(a, b) if x != y]
    res.update(records=len(a), records_other=len(b), records_differing=len(diff)
               + abs(len(a) - len(b)))
    if diff and out:
        with open(os.path.join(out, f"{cell.name}.sam_diff.txt"), "w") as f:
            for x, y in diff:
                f.write(f"< {x}> {y}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/smem_check.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--reads", type=int, default=512)
    p.add_argument("--sam-against", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = R.resolve(bench, a.workload)
    on_card = os.environ.get("BWAMEME_PLATFORM") != "cpu"
    genome = R.genome_mod.cached(cell.config["genome"], R.genome_dir(cell))
    prefix, _ = R.index_prefix(cell, genome)
    pool, _, _ = R.make_reads(cell, genome, a.seed, 1.0)
    reads = pick(pool, a.reads, cell.traffic["paired"], a.seed)
    port = R.Port(cell, prefix, on_card)
    out = {"workload": cell.name, "seed": a.seed,
           "smems": check_smems(port, reads)}
    port.close()
    del port
    ok = out["smems"]["reads_differing"] == 0
    if a.sam_against:
        out["sam"] = check_sam(cell, other_config(bench, a.sam_against, cell),
                               genome, prefix, a.seed, a.out)
        ok &= out["sam"]["records_differing"] == 0
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
