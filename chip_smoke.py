#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (bwameme_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; imports neither JAX nor the JAX package. Phases, each
of which ends the run with a non-zero exit and no result line when it fails:

1. card: the card's name and power limit (nvidia-smi); the kernels built
   from csrc/ with nvcc (one nvcc a source, all at once), and the build's
   time. From here to the end of phase 2b the bench genome's index and
   FM-index are built by processes of their own (phase 4's, 5's and 7's),
   and FmiHostEngine runs on phase 7's reads; they are waited for before
   anything is timed, phases 2 and 2b's kernels included.
2. banded SW, kernel vs plain: each extension kernel against its plain
   PyTorch version on the card, on random jobs at the main path's shapes,
   on the cases a warp-a-job kernel can get wrong (query lengths around
   multiples of the 32 lanes, the retry ladder's bands and a negative one,
   h0 = 0, all-N queries, z-drop off, batches that do not fill their last
   block, 4096 tie jobs), on a batch at the 1 kbp path's shape (Q > 1000,
   T > 1200) and on queries of 9000 bases, whose row state is a window in
   shared memory that slides with the band or, under a band wider than half
   the window, device memory, all
   outputs exactly equal; 64 jobs against the scalar contract
   (align/sw_scalar.py); the median times of both versions.
2b. mate rescue's full SW, kernel vs plain: both forms of sw_full (the
   coordinate form reads the targets from the packed text on the card)
   against the plain version, all seven outputs exactly equal, on 1024 jobs
   at a 2 x 151 bp library's rescue shape (windows of 529 rows), on the
   cases a warp-a-job kernel can get wrong (query lengths around the lanes'
   multiples, 1 and 0, all-N, empty and one-row targets, targets shorter
   than their queries, row-maximum ties under unit costs), on a long-insert
   library's windows of 12000 rows and on queries past the shared-memory
   cap; 16 jobs against the scalar contract. One launch a call of each
   form, both passes, each form counted on a call of its own;
   the steps each job's passes ran (the reverse pass must stop on the row
   where it reaches the forward score), the longest chain of steps, us a
   step (its job alone), the cells the passes need (the bound), the times
   of both versions and of the forward pass alone, ptxas's registers and
   spills.
3. gathers: the three row-gather kernels against their plain versions, all
   words equal, at 128-word and 4-word rows over a 1 GiB table, for 4096 and
   65536 lanes; then the microbenchmark itself (ops/gather_bench.microbench):
   ns per row, us per dependent round, GB/s, and one library call's time.
   The kernels' line reads the 4-word, 4096-lane case, counted on its own,
   with the host's time a launch and the card's time a call beside
   torch.index_select's; 128-word rows at 65536 lanes (32 MB each way)
   give the flat gather's GB/s beside index_select's.
4. search: on the bench genome's index (100 Mbp, built at first use under
   .bench_cache/), the P-RMI window of 2^20 keys and sa_query of >= 10^5
   jobs cut from simulated reads, kernel == plain exactly; the three seeding
   rounds (a warp a read) on 4096 reads (mutated, reverse-complemented, with
   N, from the planted repeats), kernel == plain exactly and, through the
   engine, == the port's HostSeedingEngine on 128 of them. Then the rounds
   on 253 reads that stress a warp-a-read search (a count that fills no
   block; reads from repeats, of 19-40 bp, of 500 bp, with N) on a 2 Mbp
   genome with tiled and dispersed repeats under a coarse P-RMI whose
   windows are wider than 32 x 30 ranks, kernel == plain exactly, with the
   most SMEMs a read emits in a round beside its slots. Then the same keys,
   jobs and reads in mode 1 (positions only: every compare walks the packed
   text), each kernel == plain, timed; and the wide mode-1 engine over the
   main run's 8192 reads, whose SMEMs must equal the narrow mode-4
   engine's. A seeding kernel's byte bound is reckoned from what the
   answers stand on, whatever the design: the distinct index sectors that
   hold the leaf record, the rank-indexed entries beside every insertion
   point and interval border and the text that decides their compares,
   counted by the plain version over the whole launch (answer_sectors).
   Beside it stand the sectors the scalar contract's binary searches read
   (work_sectors) and the sectors and dependent steps the kernel counted
   of itself (kernel_sectors, latency_steps). A P-RMI variant's plain ms
   is the plain version's run that also counts this work. The k-mer root
   (phase 6's backend) on the same planes, keys, jobs and reads in modes 4
   and 1: each engine's path over the 4096 reads, then kmer_window (every
   stored key's rank inside its window), sa_query and the three rounds
   against their plain versions, timed, and mode 4's SMEMs against the
   HostSeedingEngine's. Both roots give the same answers, so the work is
   counted once a layout: a k-mer variant's plain version counts nothing,
   and its bound is the P-RMI count's rank rows and text with the k-mer
   table's entries of the same keys in place of the leaf records.
4b. layouts: on the bench genome cut to SIDE_MBP, modes 2 and 3 and modes
   1-4 in wide (int64) coordinates, each with both roots: each one's path
   (the engine over 512 reads, counted from 0), then the root's window,
   sa_query and the three rounds against their plain versions, timed, with
   their bounds (counted once a layout, as in phase 4).
4c. jumbo: more than 2^31 suffixes (2^31 + 2^27) on one card in mode 1
   wide, the analytic periodic index (bench_util.periodic_index) built on
   the card; sa_query == its closed form on 96 rotations (some lb past
   2^31), prmi_window and the three rounds == plain. Its seconds and peak
   device memory.
5. end to end: ``bwameme_tpu_torch.cli mem`` with its default engine (the
   device engine) on 8192 single-end 151 bp reads of the bench genome in
   batches of 4096 (the main path), and the same with --mode 1, whose SAM
   must be byte-identical (index_upload, align and peak device memory of
   both). Then, on the bench genome cut to 2 Mbp
   (SIDE_MBP: built in seconds, so that no run but the main ones pays 100
   Mbp of rank rows), 128 short reads with the default engine, on 64 reads
   with two deletions under -w 20 (the band-retry ladder), and with
   --engine host on 8 reads of 1 kbp (the dataclass path) and on the 128
   short reads. Each of these runs starts with every launch count at 0 and is
   read just after: the default run must launch each seeding round once a
   batch and the extension kernel, the long reads the pair form, the
   deletion reads the retries; at least 95% of the main run's reads map to
   their source, and the SAM records of its first 128 reads are
   byte-identical to a CPU run of --engine host on the same 100 Mbp index
   (no rank rows to assemble); the SAM records of the 128 short reads of
   the 2 Mbp genome are byte-identical
   from the card (in modes 4, 3, 2 and 1, and on the index saved without
   its ISA), from a CPU run of the plain versions and from --engine
   host, those of the deletion reads to a CPU run of --engine host (the
   scalar seeding and the plain banded SW), and those of the long reads to
   their CPU run.
5b. paired-end: ``mem r1.fq r2.fq`` with the default engine on 4096 FR
   pairs of 2 x 151 bp (insert N(400, 40), Poisson(1) substitutions; in
   every eighth pair the second mate has a substitution every 12 bases, so
   that only a mate rescue places it). The run starts with every count at
   0: it must launch each seeding round once a batch, the extension and
   sw_full; at least 95% of the pairs are flagged proper and 90% of the
   rescued mates lie at their source. 64 pairs of the 2 Mbp genome under
   -I 400,40 give the same SAM from the card (as one -p interleaved file,
   in modes 4 and 1), from a CPU run of the plain versions and from
   --engine host (the serial host rescue, which launches no sw_full).

6. ERT (-Z): beyond phases 4 and 4b, the stress reads on the coarse
   genome under its k-mer root; mem -Z on the main run's 8192 reads, whose
   SAM must be the default mem's.
7. FM-index (--backend fmi), on index -a mem2's files of the bench genome
   (built by a process of their own from phase 1 on, as the learned index
   is): fmi_backward_ext on 2^20 units and fmi_sa_lookup on 2^16 ranks
   against their plain versions (and FmiHostEngine, the index's sa);
   fmi_smem on one batch of 4096 main reads, as mem --backend fmi
   launches it, against the plain wave engine (whose work gives its bound;
   timed there), its first 128 against FmiHostEngine in emission order;
   against FmiHostEngine on 1024 reads of the side genome and on the
   stress reads (the scalar engine's SMEMs of these computed by a process
   of its own while the card works), the stress reads also against the
   waves; an overflow of its slots seeded again on the card. Its
   max_abs_err: the SMEMs that differ, over every comparison. Then mem
   --backend fmi on the main run's reads and on the paired-end head's 64
   pairs under -I, whose SAM must be the default mem's.

Prints a JSON line of per-kernel numbers (a seeding kernel's every
variant and root, with ptxas's registers), then, last, {"ok": true, ...}.
Exits 2 with no result when no CUDA device is visible or the port is not
beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "bwameme_tpu_torch/csrc/"
# name -> (source, the TPU program it replaces)
KERNELS = {
    "banded_sw_coord": ("banded_sw.cu", "bwameme_tpu/ops/banded_sw_pallas.py:199"),
    "banded_sw_pairs": ("banded_sw.cu", "bwameme_tpu/ops/banded_sw_pallas.py:199"),
    "gather_flat": ("gather_bench.cu", "tools/microbench_pallas_gather.py:107"),
    "gather_window": ("gather_bench.cu", "tools/microbench_pallas_gather.py:144"),
    "gather_chain": ("gather_bench.cu", "tools/microbench_pallas_gather.py:203"),
    "prmi_window": ("seed_smem.cu", "bwameme_tpu/ops/sa_search.py:563"),
    "kmer_window": ("seed_smem.cu", "bwameme_tpu/ops/sa_search.py:556"),
    "sa_query": ("seed_smem.cu", "bwameme_tpu/ops/sa_search.py:1083"),
    "seed_round1": ("seed_smem.cu", "bwameme_tpu/seeding/engine.py:1081"),
    "seed_round2": ("seed_smem.cu", "bwameme_tpu/seeding/engine.py:823"),
    "seed_round3": ("seed_smem.cu", "bwameme_tpu/seeding/engine.py:1281"),
    "sw_full": ("sw_full.cu", "bwameme_tpu/ops/sw_full.py:25"),
    "fmi_backward_ext": ("fmi_search.cu",
                         "bwameme_tpu/ops/fmi_search.py:133"),
    "fmi_smem": ("fmi_search.cu", "bwameme_tpu/seeding/fmi_engine.py:265"),
    "fmi_sa_lookup": ("fmi_search.cu", "bwameme_tpu/ops/fmi_search.py:167"),
}
# the one run whose launches a kernel's "launches" counts, from 0
MEM_PATH = "mem, default engine, 151 bp reads"
LAUNCH_PATH = {
    "banded_sw_coord": MEM_PATH, "seed_round1": MEM_PATH,
    "seed_round2": MEM_PATH, "seed_round3": MEM_PATH,
    "banded_sw_pairs": "mem --engine host, 1 kbp reads",
    "gather_flat": "gather microbenchmark, 4-word rows, 4096 lanes",
    "gather_window": "gather microbenchmark, 4-word rows, 4096 lanes",
    "gather_chain": "gather microbenchmark, 4-word rows, 4096 lanes",
    "prmi_window": "the search entry points, one call each",
    "sa_query": "the search entry points, one call each",
    "sw_full": "mem, default engine, 2 x 151 bp pairs",
    "fmi_smem": "mem --backend fmi, 151 bp reads",
    "fmi_backward_ext": "one call, 2^20 units",
    "fmi_sa_lookup": "one call, 2^16 ranks",
}
ERT_PATH = "mem -Z, 151 bp reads"


def launch_path(name: str) -> str:
    """The path a kernel's variant is counted on: the seeding rounds of mode
    1 on mem --mode 1, those of the other layouts on the engine over the
    side genome's reads (phase 4b), the primitives on one call each; with
    the k-mer root, mode 4's rounds on mem -Z, mode 1's on the engine over
    the bench genome's reads (phase 4) and the other layouts' on the side
    genome's (phase 4b)."""
    base, _, tag = name.partition("[")
    tags = tag.rstrip("]").split(",") if tag else []
    if base in ("prmi_window", "kmer_window", "sa_query"):
        return LAUNCH_PATH["sa_query"]
    if "kmer" in tags:
        mode = next((int(t[1:]) for t in tags if t.startswith("m")), 4)
        if "wide" not in tags and mode == 4:
            return ERT_PATH
        if "wide" not in tags and mode == 1:
            return (f"{layout_path(1, False, 'kmer')}, {BATCH} reads of the "
                    f"{GENOME_MBP:g} Mbp genome")
        return (f"{layout_path(mode, 'wide' in tags, 'kmer')}, "
                f"{LAYOUT_READS} reads of the {SIDE_MBP:g} Mbp genome")
    if not tag:
        return LAUNCH_PATH[base]
    if tag == "m1]":
        return "mem --mode 1, 151 bp reads"
    mode, _, wide = tag.rstrip("]").partition(",")
    return (f"engine, mode {mode[1:]}{' wide' if wide else ''}, "
            f"{LAYOUT_READS} reads of the {SIDE_MBP:g} Mbp genome")


SW_KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
# published peaks of one H100 SXM: HBM bytes/s; int32 operations/s outside
# the tensor cores, taken as half the 67 TFLOP/s float32 rate (an SM has half
# as many int32 lanes as float32 lanes)
HBM_BPS = 3.35e12
INT32_OPS = 33.5e12
SECTOR = 32
# phase 2 workloads: pair jobs (B, Q, T) and coordinate jobs (reads, alnregs)
PAIRS_SHAPE = (4096, 151, 512)
LONG_PAIRS_SHAPE = (50, 1030, 1250)
SLIDING_PAIRS_SHAPE = (9000, 9100)
COORD_SHAPE = (1024, 4096)
# phase 2b: mate-rescue jobs (N, Q, T). A 2 x 151 bp library of insert
# N(400, 40) gives windows of high - low + 151 = 529 rows (bwa's pestat:
# quartiles +/- 3 IQR); a long-insert library's windows; queries past
# sw_full_cuda.SHARED_CELLS, whose rows live in device memory
RESCUE_SHAPE = (1024, 151, 529)
LONG_INSERT_SHAPE = (16, 151, 12000)
WIDE_QUERY_SHAPE = (8, 1100, 1400)
N_SCALAR = 16
# phase 3: a 1 GiB table at both row widths; lanes; window rows; chain rounds
GATHER_BYTES = 1 << 30
GATHER_WIDTHS = (128, 4)
GATHER_LANES = (4096, 65536)
GATHER_WINDOW = 16
GATHER_ROUNDS = 15
# phases 4-5: genome size (the bench's; the smoke's time limit allows a cut
# to no less than 10 Mbp), 151 bp reads in batches, 1 kbp reads; the bench
# genome cut to SIDE_MBP for the runs that are held against each other
# (CPU, --engine host), so that only the main paths pay 100 Mbp
GENOME_MBP = 100
SIDE_MBP = 2
BATCH = 4096
N_READS = 8192
N_CMP = 128
N_LONG = 8
N_KEYS = 1 << 20
JOBS_PER_READ = 26
# phase 4's stress cases: reads (a count that fills no block of four warps),
# and the cut genome whose coarse P-RMI gives windows wider than 32 x 30
N_STRESS = 253
COARSE_MBP = 2
COARSE_RMI_BITS = 2
# phase 4b: the layouts no main path takes, on the side genome (reads a
# layout, keys for prmi_window); phase 4c: the jumbo index of more than 2^31
# suffixes (a block of JUMBO_P bases tiled, windows of JUMBO_M bases tell
# its rotations apart), queried on JUMBO_ROTATIONS rotations, JUMBO_KEYS
# keys and JUMBO_READS reads
LAYOUTS = ((2, False), (3, False), (1, True), (2, True), (3, True),
           (4, True))
LAYOUT_READS = 512
LAYOUT_KEYS = 1 << 16
JUMBO_P, JUMBO_M = 4096, 16
JUMBO_N = (2**31 + 2**27) // JUMBO_P * JUMBO_P
JUMBO_ROTATIONS = 96
JUMBO_KEYS = 1 << 16
JUMBO_READS = 256
# phase 5b: 2 x 151 bp pairs, insert N(mean, sd); every RESCUED-th pair's
# second mate only a rescue can place
N_PAIRS = 4096
N_CMP_PAIRS = 64
INSERT = (400, 40)
RESCUED = 8
# phase 7 (FM-index): units of backward_ext, ranks of sa_lookup, reads of
# the side genome held against the scalar FmiHostEngine (computed by a
# process of its own while the card works)
FMI_UNITS = 1 << 20
FMI_RANKS = 1 << 16
FMI_SIDE_READS = 1024


class SmokeFailure(RuntimeError):
    pass


# the stages and peak device memory of the last run_mem
LAST_RUN: dict = {}


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1: card


def phase_card():
    from bwameme_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    res = build.build()
    libs = ", ".join(os.path.relpath(p, ROOT) for p in res.paths.values())
    log(f"kernel build: {res.seconds:.1f} s -> {libs}")
    for line in res.log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            log(f"  nvcc: {line.strip()}")
    return smi, res.log


# ---------------------------------------- phase 2: banded SW, kernel vs plain


def edge_pairs(rng, Q: int, T: int, w: int):
    """123 jobs, a count that leaves the last block short: query lengths
    around multiples of the 32 lanes and at Q, the band-retry ladder's widths
    and a negative band, empty and one-row targets, all-N queries, h0 = 0."""
    import numpy as np

    from bwameme_tpu_torch.bench_util import random_pairs

    q, t, qlen, tlen, h0, ws = random_pairs(rng, 123, Q, T, w)
    qlen[0:18] = [0, 1, 31, 32, 33, 63, 64, 65, Q] * 2
    tlen[0:18] = np.minimum(qlen[0:18] + rng.integers(0, 2 * w + 1, 18), T)
    ws[18:32] = [1, 2, w, 2 * w, 4 * w, 8 * w, -1] * 2
    tlen[32:36] = 0
    tlen[36:40] = 1
    q[40:44] = 4
    h0[44:48] = 0
    return q, t, qlen, tlen, h0, ws


def tie_pairs(rng, B: int):
    """Short jobs over three letters: under unit gap costs and a small
    z-drop, rows whose maximum ties between cells decide where the
    extension stops, so the tie rule (largest j) shows in the result."""
    import numpy as np

    q = rng.integers(0, 3, (B, 12)).astype(np.int32)
    t = rng.integers(0, 3, (B, 16)).astype(np.int32)
    qlen = rng.integers(2, 13, B).astype(np.int32)
    tlen = rng.integers(2, 17, B).astype(np.int32)
    h0 = rng.integers(1, 24, B).astype(np.int32)
    ws = rng.integers(1, 8, B).astype(np.int32)
    return q, t, qlen, tlen, h0, ws


def sliding_pairs(rng, Q: int, T: int):
    """Six jobs on queries past the 4095 bases whose row state gets a slot
    a cell: targets that follow the query (substitutions, and 7 bases fewer
    from base 900 on) under bands whose state slides along the query in the
    kernel's window of 4096 slots (100, 800), that just fit the window's
    half (1023), and that pass it, so that the job runs on device memory
    (1024; unbounded, on a short target; a short query never slides)."""
    import numpy as np

    q = rng.integers(0, 4, (6, Q)).astype(np.int32)
    t = rng.integers(0, 4, (6, T)).astype(np.int32)
    n = Q - 7
    t[:, :n] = np.where(rng.random((6, n)) < 0.02, (q[:, :n] + 1) % 4,
                        q[:, :n])
    t[:, 900:n] = q[:, 907:]
    qlen = np.array([Q, Q - 3700, 4096, 5000, Q, 64], np.int32)
    tlen = np.array([T, Q - 3600, 4200, 5100, 120, 70], np.int32)
    ws = np.array([100, 800, 1023, 1024, 1 << 20, 1 << 20], np.int32)
    return q, t, qlen, tlen, np.full(6, 60, np.int32), ws


def sw_bound(qlen, ws, res, n_bytes: int) -> dict:
    """The least time the card could take for a batch of extension jobs: the
    bytes it must move over the HBM rate, or the int32 operations of the
    cells this run's data needed over the int32 rate - the rows that
    certainly ran (up to the reported target ends) times the band's cells in
    a row, at about 12 operations a cell (three maxima, the score lookup,
    the gap updates, the row maximum). lane_share: of the slots those rows
    offer the kernel's 32 lanes (a row's cells a lane, rounded up, times 32),
    the share that holds a cell - an estimate from the same rows and widths,
    not a count."""
    import numpy as np

    rows = np.maximum(np.maximum(res["tle"].cpu().numpy(),
                                 res["gtle"].cpu().numpy()), 1)
    rows = rows.astype(np.int64)
    width = np.minimum(qlen, 2 * ws.astype(np.int64) + 1)
    cells = int((rows * width).sum())
    slots = int((rows * 32 * -(-width // 32)).sum())
    by_ops, by_bytes = 12 * cells / INT32_OPS * 1e3, n_bytes / HBM_BPS * 1e3
    return dict(bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                lane_share=cells / slots if slots else 0.0)


def abs_err(got, want) -> int:
    """Largest absolute difference of two integer tensors of one shape."""
    check(got.shape == want.shape, f"shapes {tuple(got.shape)} and "
          f"{tuple(want.shape)} differ")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def max_err(a: dict, b: dict) -> int:
    return max(abs_err(a[k], b[k]) for k in a)


def compare_pairs(opt, arrays, zdrop: int, dev):
    import torch

    from bwameme_tpu_torch.ops import banded_sw as bsw
    from bwameme_tpu_torch.ops import banded_sw_cuda

    ts = [torch.from_numpy(a).to(dev) for a in arrays]
    mat = torch.from_numpy(opt.mat.astype("int32")).to(dev)
    args = (*ts, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.pen_clip5, zdrop)
    got = banded_sw_cuda.banded_sw_pairs(*args)
    want = bsw.sw_core_torch(*args)
    torch.cuda.synchronize()
    return got, want, args


def phase_kernels(dev):
    """K1, both forms, against its plain version on the card, all outputs
    exactly equal. Returns the report and a function that times both forms,
    called once the host has no other work."""
    import numpy as np
    import torch

    from bwameme_tpu_torch.align.sw_scalar import sw_extend
    from bwameme_tpu_torch.bench_util import (coord_workload, cuda_ms,
                                              random_pairs, run_coord_round)
    from bwameme_tpu_torch.utils.config import MemOptions
    from bwameme_tpu_torch.ops import banded_sw as bsw
    from bwameme_tpu_torch.ops import banded_sw_cuda

    opt = MemOptions()
    rng = np.random.default_rng(7)
    report = {}

    # pair form: 4096 jobs at Q = 151, T = 512, then the edge cases
    B, Q, T = PAIRS_SHAPE
    arrays = random_pairs(rng, B, Q, T, opt.w)
    got, want, args = compare_pairs(opt, arrays, opt.zdrop, dev)
    err = max_err(got, want)
    check(err == 0, f"banded_sw_pairs differs from sw_core_torch: {err}")
    n_edge = 0
    for zdrop in (0, opt.zdrop):
        edge = edge_pairs(rng, Q, T, opt.w)
        n_edge = len(edge[2])
        g, w_, _ = compare_pairs(opt, edge, zdrop, dev)
        e = max_err(g, w_)
        check(e == 0, f"banded_sw_pairs edge cases (zdrop={zdrop}) differ: {e}")
        err = max(err, e)
    tie_opt = MemOptions(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1)
    g, w_, _ = compare_pairs(tie_opt, tie_pairs(rng, 4096), 5, dev)
    e = max_err(g, w_)
    check(e == 0, f"banded_sw_pairs tie cases differ: {e}")
    err = max(err, e)
    Bl, Ql, Tl = LONG_PAIRS_SHAPE
    long_arrays = random_pairs(rng, Bl, Ql, Tl, opt.w)
    long_arrays[2][::2] = rng.integers(900, Ql + 1, len(long_arrays[2][::2]))
    long_arrays[2][0] = Ql
    long_arrays[3][::2] = np.minimum(long_arrays[2][::2] + 2 * opt.w, Tl)
    g, w_, _ = compare_pairs(opt, long_arrays, opt.zdrop, dev)
    e = max_err(g, w_)
    check(e == 0, f"banded_sw_pairs at Q={Ql}, T={Tl} differs: {e}")
    check(int(g["qle"].max()) > 1000, "no long job ran past 1000 bases")
    err = max(err, e)
    Qr, Tr = SLIDING_PAIRS_SHAPE
    ring = sliding_pairs(rng, Qr, Tr)
    g, w_, _ = compare_pairs(opt, ring, opt.zdrop, dev)
    e = max_err(g, w_)
    check(e == 0, f"banded_sw_pairs at Q={Qr}, T={Tr} differs: {e}")
    check(g["qle"][:4].tolist() == ring[2][:4].tolist(),
          f"the jobs at Q={Qr} stopped before their queries' ends")
    err = max(err, e)
    log(f"banded_sw_pairs == sw_core_torch on {B} + 2x{n_edge} edge + 4096 "
        f"tie jobs + {Bl} jobs at Q={Ql}, T={Tl} + {len(ring[2])} at Q={Qr}, "
        f"T={Tr} in the sliding window and past it (max abs err {err})")
    q, t, qlen, tlen, h0, ws = arrays
    for b in range(64):
        r = sw_extend(q[b, : qlen[b]], t[b, : tlen[b]], opt.mat, opt.o_del,
                      opt.e_del, opt.o_ins, opt.e_ins, int(ws[b]),
                      opt.pen_clip5, opt.zdrop, int(h0[b]))
        check([getattr(r, k) for k in SW_KEYS]
              == [int(got[k][b]) for k in SW_KEYS],
              f"banded_sw_pairs job {b} differs from sw_scalar.sw_extend")
    log("banded_sw_pairs == sw_scalar.sw_extend on 64 jobs")
    report["banded_sw_pairs"] = dict(
        max_abs_err=err, library_ms=None,
        **sw_bound(qlen, ws, got, 4 * (B * (Q + T) + 10 * B)))

    # coordinate form: one left and one right job per alnreg
    n_reads, n_regs = COORD_SHAPE
    host = coord_workload(opt, rng, n_reads, n_regs, 151)
    t32, cd, lj, rj, h0t, mat = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (*host, opt.mat.astype(np.int32)))
    k_l, k_r, k_reg = run_coord_round(banded_sw_cuda.banded_sw_coord, opt,
                                      t32, cd, lj, rj, h0t, mat)
    p_l, p_r, p_reg = run_coord_round(bsw.extend_side_round_torch, opt, t32,
                                      cd, lj, rj, h0t, mat)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in ((k_l, p_l), (k_r, p_r), (k_reg, p_reg)))
    check(err == 0, f"banded_sw_coord differs from its plain version: {err}")
    # a batch that leaves the last block short
    short = [j[:, : n_regs - 1].contiguous() for j in (lj, rj)]
    k_s = run_coord_round(banded_sw_cuda.banded_sw_coord, opt, t32, cd,
                          *short, h0t, mat)
    torch.cuda.synchronize()
    e = max(abs_err(a[:, : n_regs - 1], b) for a, b in
            ((k_l, k_s[0]), (k_r, k_s[1])))
    check(e == 0, f"banded_sw_coord on {n_regs - 1} jobs differs: {e}")
    log(f"banded_sw_coord == decode_text + gather_query + sw_core_torch on "
        f"{n_regs} left + {n_regs} right jobs (max abs err {err}), and on "
        f"{n_regs - 1}")
    bounds = [sw_bound(j[3].cpu().numpy(), j[6].cpu().numpy(),
                       dict(tle=r[2], gtle=r[3]),
                       4 * 15 * n_regs + cd.numel() // 2
                       + int(j[5].sum()) // 4)
              for j, r in ((lj, k_l), (rj, k_r))]
    by_ops = sum(b["bound_ms"] for b in bounds if b["bound_by"] == "operations")
    by_bytes = sum(b["bound_ms"] for b in bounds if b["bound_by"] == "bytes")
    report["banded_sw_coord"] = dict(
        max_abs_err=err, library_ms=None,
        lane_share=bounds[1]["lane_share"], bound_ms=by_ops + by_bytes,
        bound_by="operations" if by_ops >= by_bytes else "bytes")
    # the coordinate form timed as the flat path launches its jobs: sorted
    # by target length
    lj_s = lj[:, torch.argsort(lj[5], descending=True, stable=True)]
    rj_s = rj[:, torch.argsort(rj[5], descending=True, stable=True)]

    def timings():
        ms = cuda_ms(lambda: banded_sw_cuda.banded_sw_pairs(*args), 10)
        plain_ms = cuda_ms(lambda: bsw.sw_core_torch(*args), 3)
        log(f"banded_sw_pairs: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"({B} jobs, Q={Q}, T={T}; median)")
        report["banded_sw_pairs"].update(ms=ms, plain_ms=plain_ms)
        ms = cuda_ms(lambda: run_coord_round(
            banded_sw_cuda.banded_sw_coord, opt, t32, cd, lj_s, rj_s, h0t,
            mat), 10)
        plain_ms = cuda_ms(lambda: run_coord_round(
            bsw.extend_side_round_torch, opt, t32, cd, lj_s, rj_s, h0t, mat),
            3)
        log(f"banded_sw_coord: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(one round: {n_regs} left + {n_regs} right jobs, 151 bp reads; "
            f"median)")
        report["banded_sw_coord"].update(ms=ms, plain_ms=plain_ms)

    return report, timings


# ------------------------------- phase 2b: mate rescue's full SW, kernel vs plain


def rescue_jobs(rng, text, shape):
    """Mate-rescue jobs as a paired-end library makes them: each target a
    window of the text (T rows, fewer where the window met a contig's end),
    each query a mate cut from it with Poisson(1) substitutions; one in
    eight with a substitution every 12 bases (no 19-mer seed: the mates
    only a rescue places), one in sixteen with its mate's copy a second
    time in the window (score2), one in sixteen not from the window at all.
    Returns q (N, Q) uint8, jobs (3, N) int32 rows qlen, tstart, tlen."""
    import numpy as np

    N, Q, T = shape
    tlen = np.where(rng.random(N) < 0.2, rng.integers(Q, T + 1, N), T)
    tstart = rng.integers(0, len(text) - T, N)
    q = np.zeros((N, Q), np.uint8)
    for b in range(N):
        off = int(rng.integers(0, tlen[b] - Q + 1))
        src = text[tstart[b] + off: tstart[b] + off + Q].copy()
        kind = b % 16
        if kind in (0, 8):
            src[6::12] = (src[6::12] + 1) % 4
        elif kind == 3:
            src = rng.integers(0, 4, Q).astype(np.uint8)
        for _ in range(rng.poisson(1.0)):
            p = int(rng.integers(0, Q))
            src[p] = (src[p] + rng.integers(1, 4)) % 4
        if kind == 5 and tlen[b] >= 2 * Q + off + 20:
            text[tstart[b] + tlen[b] - Q - 5: tstart[b] + tlen[b] - 5] = src
        q[b] = src
    return q, np.stack([np.full(N, Q), tstart, tlen]).astype(np.int32)


def full_sw_edges(rng, text, Q: int):
    """Jobs a warp-a-job kernel can get wrong: query lengths around the
    lanes' multiples, 1 and 0, all-N queries, empty and one-row targets,
    targets shorter than their queries. Same layout as rescue_jobs."""
    import numpy as np

    qlen = np.array([0, 1, 2, 31, 32, 33, 63, 64, 65, 100, Q, Q, Q, Q, 40,
                     Q, 9], np.int32)
    tlen = np.array([50, 80, 80, 300, 300, 300, 300, 300, 300, 300, 0, 1, 5,
                     120, 20, 300, 300], np.int32)
    N = len(qlen)
    tstart = rng.integers(0, len(text) - 400, N).astype(np.int32)
    q = np.zeros((N, Q), np.uint8)
    for b in range(N):
        src = text[tstart[b] + 7: tstart[b] + 7 + qlen[b]]
        q[b, : len(src)] = src
    q[15:, :] = 4
    return q, np.stack([qlen, tstart, tlen]).astype(np.int32)


def ptxas_usage(build_log: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported for a kernel's entry (None
    when the libraries were already built and nothing was compiled)."""
    import re

    usage, entry = dict(registers=None, spill_stores=None,
                        spill_loads=None), False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = kernel in line
        elif entry and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage.update(spill_stores=int(st), spill_loads=int(ld))
        elif entry and "registers" in line:
            usage["registers"] = int(re.search(r"Used (\d+) registers",
                                               line).group(1))
    return usage


def phase_sw_full(dev, build_log: str):
    """sw_full, both forms, against its plain version on the card, all seven
    outputs exactly equal: the rescue batch (RESCUE_SHAPE), the edge jobs,
    ties under unit costs (pair form), a long-insert library's windows
    (LONG_INSERT_SHAPE) and queries past the shared-memory cap (their rows
    in device memory); 64 jobs against the scalar contract. Returns the
    report and a function that times the kernel, called once the host has
    no other work."""
    import numpy as np
    import torch

    from bwameme_tpu_torch.align.sw_scalar import sw_align
    from bwameme_tpu_torch.bench_util import cuda_ms, queued_us
    from bwameme_tpu_torch.index.packing import pack_words
    from bwameme_tpu_torch.ops import sw_full, sw_full_cuda
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.utils.config import MemOptions

    opt = MemOptions()
    rng = np.random.default_rng(23)
    text = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    batches = {"rescue": rescue_jobs(rng, text, RESCUE_SHAPE),
               "edge": full_sw_edges(rng, text, RESCUE_SHAPE[1]),
               "long insert": rescue_jobs(rng, text, LONG_INSERT_SHAPE),
               "wide query": rescue_jobs(rng, text, WIDE_QUERY_SHAPE)}
    # every other wide job a mate's length: shared and device memory in
    # one launch
    batches["wide query"][1][0, ::2] = RESCUE_SHAPE[1]
    t32 = torch.from_numpy(np.concatenate(
        [pack_words(text, pad_code=3),
         np.full(12, 0xFFFFFFFF, np.uint32)]).view(np.int32)).to(dev)
    mat = torch.from_numpy(opt.mat.astype(np.int32)).to(dev)
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    min_sc = opt.min_seed_len * opt.a

    def coord_args(q, jobs):
        N = q.shape[0]
        return (t32, torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                torch.from_numpy(np.ascontiguousarray(jobs)).to(dev), mat,
                torch.full((N,), min_sc, dtype=torch.int32, device=dev),
                *gaps, int(jobs[2].max()))

    def pair_arrays(q, jobs):
        """The same jobs in the pair form: the targets' codes shipped."""
        T = int(jobs[2].max())
        t = np.zeros((q.shape[0], T), np.int32)
        for b, (st, n) in enumerate(zip(jobs[1], jobs[2])):
            t[b, :n] = text[st: st + n]
        return q.astype(np.int32), t, jobs[0].copy(), jobs[2].copy()

    def pair_args(o, arrays):
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in arrays]
        B = ts[0].shape[0]
        return (*ts, torch.from_numpy(o.mat.astype(np.int32)).to(dev),
                torch.full((B,), min_sc, dtype=torch.int32, device=dev),
                o.o_del, o.e_del, o.o_ins, o.e_ins)

    err, n_jobs, results = 0, 0, {}
    for label, (q, jobs) in batches.items():
        args = coord_args(q, jobs)
        got = sw_full_cuda.sw_full_coord(*args)
        want = sw_full.sw_full_coord_torch(*args)
        pargs = pair_args(opt, pair_arrays(q, jobs))
        got_p = sw_full_cuda.sw_full_pairs(*pargs)
        torch.cuda.synchronize()
        e = max(abs_err(got, want), abs_err(got_p, want))
        check(e == 0, f"sw_full on the {label} jobs differs from its plain "
              f"version: {e}")
        err, n_jobs, results[label] = max(err, e), n_jobs + q.shape[0], got
    check(int(results["wide query"][0][1::2].max()) > 1000,
          "the queries past the shared cells did not align")
    tie_opt = MemOptions(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1)
    tq = rng.integers(0, 2, (1024, 90)).astype(np.int32)
    tt = np.tile(tq, 3)[:, :200]
    tt = np.where(rng.random(tt.shape) < 0.1, 1 - tt, tt).astype(np.int32)
    tql = rng.integers(1, 91, 1024).astype(np.int32)
    ttl = rng.integers(1, 201, 1024).astype(np.int32)
    targs = pair_args(tie_opt, (tq, tt, tql, ttl))
    want = sw_full.sw_full_torch(*targs)
    # the coordinate form: the same targets one after another in a text
    tie_t32 = torch.from_numpy(np.concatenate(
        [pack_words(tt.astype(np.uint8).reshape(-1), pad_code=3),
         np.full(12, 0xFFFFFFFF, np.uint32)]).view(np.int32)).to(dev)
    tie_jobs = torch.from_numpy(np.stack(
        [tql, np.arange(1024) * tt.shape[1], ttl]).astype(np.int32)).to(dev)
    got_c = sw_full_cuda.sw_full_coord(
        tie_t32, torch.from_numpy(tq.astype(np.uint8)).to(dev), tie_jobs,
        *targs[4:], tt.shape[1])
    e = max(abs_err(sw_full_cuda.sw_full_pairs(*targs), want),
            abs_err(got_c, want))
    check(e == 0, f"sw_full on the tie jobs differs: {e}")
    err = max(err, e)
    q, jobs = batches["rescue"]
    res = results["rescue"].cpu().numpy()
    for b in range(N_SCALAR):
        st, n = int(jobs[1, b]), int(jobs[2, b])
        r = sw_align(q[b], text[st: st + n], opt.mat, *gaps, xtra_start=True,
                     min_sc=min_sc)
        got = [int(x) for x in res[:, b]]
        check([r.score, r.te, r.qe, r.score2] == got[:4]
              and (r.score <= 0 or [r.tb, r.qb] == got[5:]),
              f"sw_full job {b} differs from sw_scalar.sw_align")
    sizes = ", ".join(f"{k} {v[0].shape[0]}" for k, v in batches.items())
    log(f"sw_full == plain, both forms, on {n_jobs} jobs ({sizes}) + 1024 "
        f"tie jobs (max abs err {err}); == sw_scalar.sw_align on {N_SCALAR}")

    # one launch a call, both passes: each form counted on a call of its own
    args = coord_args(q, jobs)
    pargs = pair_args(opt, pair_arrays(q, jobs))
    a_call = {}
    for form, fn, fargs in (("coord", sw_full_cuda.sw_full_coord, args),
                            ("pairs", sw_full_cuda.sw_full_pairs, pargs)):
        stats.reset()
        fn(*fargs)
        a_call[form] = stats.launches["sw_full"]
        check(a_call[form] == 1, f"sw_full_{form}: {a_call[form]} launches "
              "for one call")
    torch.cuda.synchronize()
    # the steps each job's passes ran: the forward pass tlen + (lanes
    # holding columns) - 1, the reverse pass up to the row where it reached
    # the forward score (te_rev = te - tb), where it must stop
    steps = torch.zeros((2, q.shape[0]), dtype=torch.int32, device=dev)
    sw_full_cuda.sw_full_coord(*args, steps=steps)
    steps = steps.cpu().numpy().astype(np.int64)
    ok = res[0] > 0
    te_rev = np.where(ok, res[1] - res[5], -1)
    check(((steps[1] == te_rev + 1 + last_lane(res[2] + 1)) | ~ok).all()
          and (steps[1][~ok] == 0).all(),
          "the reverse pass did not stop at the forward score")
    whole = np.where(ok, res[1] + 1 + last_lane(res[2] + 1), 0)
    chain = steps.sum(0)
    worst = int(chain.argmax())
    # bound: the cells these jobs need at about 12 int32 operations a cell
    # (three maxima, the score lookup, the gap updates, the F carry and the
    # row maximum) - the forward pass's qlen x tlen and the reverse pass's
    # (qe + 1) x (te_rev + 1), the rows until it reaches the score - or the
    # bytes: the mates' codes, the jobs, the windows' packed text and the
    # results, each once. Beside it the reverse pass over the whole prefix
    # (qe + 1) x (te + 1)
    fwd_cells = int((jobs[0].astype(np.int64) * jobs[2]).sum())
    rev_cells = int(((res[2] + 1) * (te_rev + 1))[ok].sum())
    prefix_cells = int(((res[2] + 1) * (res[1] + 1))[ok].sum())
    cells = fwd_cells + rev_cells
    n_bytes = q.size + 16 * q.shape[0] + int(jobs[2].sum()) // 4 \
        + 28 * q.shape[0]
    by_ops, by_bytes = 12 * cells / INT32_OPS * 1e3, n_bytes / HBM_BPS * 1e3
    usage = ptxas_usage(build_log, "sw_full_coord")
    log(f"sw_full: one launch a call of each form ({a_call}); cells: forward "
        f"{fwd_cells}, reverse pass to the score {rev_cells} (over the whole "
        f"prefix {prefix_cells}); bound {max(by_ops, by_bytes):.4f} ms; "
        f"longest chain {int(chain[worst])} steps (job {worst}: forward "
        f"{int(steps[0, worst])}, reverse {int(steps[1, worst])} of the "
        f"{int(whole[worst])} over its whole prefix); reverse steps run "
        f"{int(steps[1].sum())} of {int(whole.sum())}; ptxas {usage}")
    report = dict(
        max_abs_err=err, library_ms=None, bound_ms=max(by_ops, by_bytes),
        bound_by="operations" if by_ops >= by_bytes else "bytes",
        cells=cells, forward_cells=fwd_cells, reverse_cells=rev_cells,
        reverse_prefix_cells=prefix_cells, launches_a_call=a_call["coord"],
        pairs_launches_a_call=a_call["pairs"],
        longest_chain_steps=int(chain[worst]),
        longest_chain_forward_steps=int(steps[0, worst]),
        longest_chain_reverse_steps=int(steps[1, worst]), **usage)

    def timings():
        """The coordinate form (the mate-rescue path) on the rescue batch,
        both passes; the job of the longest chain alone on the card with
        the host out of the way, its time over its steps the time of a
        step; the long-insert windows."""
        ms = cuda_ms(lambda: sw_full_cuda.sw_full_coord(*args), 20)
        device_ms = queued_us(lambda: sw_full_cuda.sw_full_coord(*args),
                              50) / 1e3
        fwd_ms = cuda_ms(lambda: sw_full_cuda.sw_full_coord(
            *args, with_start=False), 20)
        plain_ms = cuda_ms(lambda: sw_full.sw_full_coord_torch(*args), 2)
        pairs_ms = cuda_ms(lambda: sw_full_cuda.sw_full_pairs(*pargs), 20)
        one = coord_args(q[worst: worst + 1], jobs[:, worst: worst + 1])
        one_ms = queued_us(lambda: sw_full_cuda.sw_full_coord(*one),
                           20) / 1e3
        step_us = 1e3 * one_ms / int(chain[worst])
        long_args = coord_args(*batches["long insert"])
        long_ms = cuda_ms(lambda: sw_full_cuda.sw_full_coord(*long_args), 5)
        log(f"sw_full_coord: {ms:.4f} ms a call alone (one launch, both "
            f"passes), {device_ms:.4f} ms on the card, forward pass alone "
            f"{fwd_ms:.4f}, plain {plain_ms:.1f} ms ({q.shape[0]} jobs, "
            f"Q={q.shape[1]}, T<={int(jobs[2].max())}; median); pair form "
            f"{pairs_ms:.4f} ms; the longest job alone on the card "
            f"{one_ms:.4f} ms = {step_us:.4f} us a step of its "
            f"{int(chain[worst])}; {LONG_INSERT_SHAPE[0]} long-insert jobs "
            f"at T={LONG_INSERT_SHAPE[2]}: {long_ms:.3f} ms")
        report.update(ms=ms, device_ms=device_ms, forward_ms=fwd_ms,
                      pairs_ms=pairs_ms, plain_ms=plain_ms, step_us=step_us,
                      longest_job_alone_ms=one_ms, long_insert_ms=long_ms)

    return {"sw_full": report}, timings


def last_lane(qlen):
    """The wavefront's last lane holding columns for queries of qlen bases
    (K = ceil(qlen / 32) columns a lane), as numpy."""
    import numpy as np

    qlen = np.maximum(np.asarray(qlen, np.int64), 1)
    k = -(-qlen // 32)
    return -(-qlen // k) - 1


# ------------------------------------------------------- phase 3: gathers


def phase_gather(dev):
    """K2-K4 against their plain versions (all words equal), then the
    microbenchmark. The kernels' line reads the rank-row case (4-word rows,
    a batch's lanes): its launches are counted on their own, from 0."""
    import torch

    from bwameme_tpu_torch.bench_util import cuda_ms, host_us, queued_us
    from bwameme_tpu_torch.ops import gather_bench as gb
    from bwameme_tpu_torch.ops.launch import stats

    names = ("gather_flat", "gather_window", "gather_chain")
    errs = dict.fromkeys(names, 0)
    results = []
    for width in GATHER_WIDTHS:
        n_rows = GATHER_BYTES // (4 * width)
        src = gb.make_table(n_rows, width, dev, seed=width)
        for lanes in GATHER_LANES:
            idx = gb.make_lanes(n_rows, lanes, dev, seed=lanes)
            idxw = idx.clamp(max=n_rows - GATHER_WINDOW)
            pairs = (
                ("gather_flat", gb.gather_flat(src, idx),
                 gb.gather_flat_torch(src, idx)),
                ("gather_window", gb.gather_window(src, idxw, GATHER_WINDOW),
                 gb.gather_window_torch(src, idxw, GATHER_WINDOW)),
                ("gather_chain", gb.gather_chain(src, idx, GATHER_ROUNDS),
                 gb.gather_chain_torch(src, idx, GATHER_ROUNDS)))
            torch.cuda.synchronize()
            for name, got, want in pairs:
                err = abs_err(got, want)
                check(err == 0, f"{name} differs from its plain version at "
                      f"width {width}, {lanes} lanes: {err}")
                errs[name] = max(errs[name], err)
            del pairs, got, want
            results.append((src, idx, idxw, width, lanes))
        log(f"gather_flat/window/chain == plain at {width}-word rows, "
            f"{n_rows} rows, lanes {GATHER_LANES} (max abs err "
            f"{max(errs.values())})")
    # the microbenchmark proper, the rank-row case last and counted alone
    main_case = next(r for r in results if r[3] == 4 and r[4] == BATCH)
    results.sort(key=lambda r: r is main_case)      # stable: the others first
    for case in results:
        src, idx, idxw, width, lanes = case
        if case is main_case:
            stats.reset()
        r = gb.microbench(src, idx, GATHER_WINDOW, GATHER_ROUNDS)
        log(f"gather {width:3d}-word rows, {lanes:5d} lanes: flat "
            f"{r['flat_ns_per_row']:.2f} ns/row ({r['flat_gbs']:.0f} GB/s), "
            f"window {r['window_ns_per_row']:.2f} ns/row "
            f"({r['window_gbs']:.0f} GB/s), chain {r['chain_ms']:.4f} ms for "
            f"{GATHER_ROUNDS} rounds, {r['chain_us_per_round']:.3f} us a "
            f"dependent round (from a {64 * GATHER_ROUNDS}-round chain)")
    chain_us = r["chain_us_per_round"]      # the main case's: 16-byte rows
    launches = {k: stats.launches[k] for k in names}
    log(f"launches of the {width}-word, {lanes}-lane microbenchmark: "
        f"{launches}")

    # bounds: sectors moved over the HBM rate. The chain's byte bound says
    # little: it is K dependent loads, so the measured time of one dependent
    # round times K stands beside it as its latency bound
    src, idx, idxw, width, lanes = main_case
    row_sectors = -(-4 * width // SECTOR) * SECTOR
    win = GATHER_WINDOW
    win_sectors = (-(-4 * width * win // SECTOR) + 1) * SECTOR
    flat_idx = (idxw.long()[:, None]
                + torch.arange(win, device=dev)).reshape(-1)
    cases = {
        "gather_flat": (
            lambda: gb.gather_flat(src, idx),
            lambda: gb.gather_flat_torch(src, idx),
            lambda: torch.index_select(src, 0, idx),
            lanes * (row_sectors + 4 * width + 4)),
        "gather_window": (
            lambda: gb.gather_window(src, idxw, win),
            lambda: gb.gather_window_torch(src, idxw, win),
            lambda: torch.index_select(src, 0, flat_idx),
            lanes * (win_sectors + 4 * width * win + 4)),
        "gather_chain": (
            lambda: gb.gather_chain(src, idx, GATHER_ROUNDS),
            lambda: gb.gather_chain_torch(src, idx, GATHER_ROUNDS),
            None, lanes * (GATHER_ROUNDS * SECTOR + 8)),
    }
    report = {}
    for name, (kern, plain, lib, n_bytes) in cases.items():
        report[name] = dict(
            max_abs_err=errs[name], ms=cuda_ms(kern, 20),
            plain_ms=cuda_ms(plain, 5),
            library_ms=cuda_ms(lib, 20) if lib else None,
            bound_ms=n_bytes / HBM_BPS * 1e3, bound_by="bytes",
            launches=launches[name])
        check(launches[name] > 0, f"{name} was not launched by the benchmark")
    report["gather_chain"]["latency_bound_ms"] = GATHER_ROUNDS * chain_us / 1e3

    # where the call's time goes at 64 KB a call: the host's time a launch
    # and the card's time a call, beside index_select's
    kern, _, lib, _ = cases["gather_flat"]
    flat = report["gather_flat"]
    flat.update(host_us=host_us(kern), library_host_us=host_us(lib),
                device_us=queued_us(kern), library_device_us=queued_us(lib))
    log(f"gather_flat at {4 * width} B rows x {lanes} lanes: "
        f"{flat['ms'] * 1e3:.1f} us a call (index_select "
        f"{flat['library_ms'] * 1e3:.1f}); host {flat['host_us']:.2f} us a "
        f"launch (index_select {flat['library_host_us']:.2f}); card "
        f"{flat['device_us']:.2f} us a call when queued (index_select "
        f"{flat['library_device_us']:.2f})")
    # and where the card is measured, not the host: 32 MB each way, the
    # calls queued so that no launch waits for the host
    src, idx, _, width, lanes = next(
        r for r in results if r[3] == 128 and r[4] == 65536)
    wide_ms = queued_us(lambda: gb.gather_flat(src, idx), 100) / 1e3
    wide_lib_ms = queued_us(lambda: torch.index_select(src, 0, idx), 100) / 1e3
    n_bytes = 2 * lanes * 4 * width
    flat.update(wide_ms=wide_ms, wide_library_ms=wide_lib_ms,
                wide_gbs=n_bytes / wide_ms / 1e6,
                wide_library_gbs=n_bytes / wide_lib_ms / 1e6)
    log(f"gather_flat at {4 * width} B rows x {lanes} lanes: {wide_ms:.4f} "
        f"ms = {flat['wide_gbs']:.0f} GB/s (index_select {wide_lib_ms:.4f} "
        f"ms = {flat['wide_library_gbs']:.0f} GB/s)")
    return report, chain_us


# -------------------------------------------------------- phase 4: search


def round_err(a, b) -> int:
    """Largest absolute difference of two rounds' results: the counts, the
    dropped counts, and the slots either side used."""
    import torch

    used = (torch.arange(a[0].shape[2], device=a[0].device)[None, :]
            < torch.maximum(a[1], b[1])[:, None])
    return max(abs_err(a[1], b[1]), abs_err(a[2], b[2]),
               abs_err(a[0][:, used], b[0][:, used]))


def stress_reads(text, l_pac: int, n: int, rng, regions):
    """Reads that stress a warp-a-read search, in turns: 151 bp from
    ``regions`` ((start, length) of repeats: runs of equal suffixes that can
    reach past the probed ranks), 19 to 40 bp, 500 bp with two N and some
    substitutions (ties far past the rank row's 48 bases), and 151 bp with
    three N, reverse-complemented."""
    import numpy as np

    reads = []
    for i in range(n):
        kind = i % 4
        ln = (151, int(rng.integers(19, 41)), 500, 151)[kind]
        if kind == 0:
            lo, span = regions[int(rng.integers(0, len(regions)))]
            st = int(lo + rng.integers(0, max(span - ln, 1)))
        else:
            st = int(rng.integers(0, l_pac - ln - 1))
        c = np.array(text[min(st, l_pac - ln - 1):][:ln])
        if kind == 2:
            for _ in range(4):
                q = int(rng.integers(0, ln))
                c[q] = (c[q] + rng.integers(1, 4)) % 4
        for _ in range((0, 0, 2, 3)[kind]):
            c[int(rng.integers(0, ln))] = 4
        if kind == 3:
            c = np.where(c < 4, 3 - c, c)[::-1].astype(np.uint8)
        reads.append(c)
    return reads


def coarse_index(mbp: float, rmi_bits: int):
    """A cut genome under a coarse P-RMI, so that windows are wider than 32
    x 30 ranks, with a 60-base unit tiled 40 times and a 200-base element
    dispersed 300 times: runs of equal suffixes wider than any probe. Returns
    the index and the repeats' (start, length)."""
    import numpy as np

    from bwameme_tpu_torch.index import bntseq
    from bwameme_tpu_torch.index.build import build_index

    rng = np.random.default_rng(2025)
    n = int(mbp * 1e6)
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[5000:7400] = np.tile(code[5000:5060], 40)
    element = code[9000:9200].copy()
    spots = rng.integers(10000, n - 1000, 300)
    for st in spots:
        code[st: st + 200] = element
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("chrC", "", 0, n, 0)],
                        ambs=[], code=code)
    regions = [(5000, 2400)] + [(int(st) - 60, 320) for st in spots[:20]]
    return build_index(bns, rmi_bits=rmi_bits), regions


def compare_rounds(batch, dev, count_work: bool):
    """Each round's kernel against its plain version on one batch
    (bench_util.Rounds), all values equal. Yields (k, the kernel's result,
    max abs err, the plain version's wall ms, the work it counted on that
    run (ops.sa_search.Work; None unless asked: the wall ms then includes
    the counting), the kernel's own counts (2, R))."""
    import torch

    from bwameme_tpu_torch.ops.sa_search import Work

    for k in range(3):
        counts = torch.zeros((2, batch.R), dtype=torch.int32, device=dev)
        res = batch.run(k, batch.kernels[k], counts=counts)
        work = Work(batch.R, dev) if count_work else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = batch.run(k, batch.plain[k], work=work)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = round_err(res, want)
        check(err == 0, f"{variant_of(batch.eng.di, f'seed_round{k + 1}')} "
              f"differs from its plain version: {err}")
        yield k, res, err, plain_ms, work, counts


def seeding_row(err, kern, plain_ms, work, counts, chain_us: float,
                fixed_bytes: int, di=None) -> dict:
    """A seeding kernel's numbers: ms, the median time of a call made alone
    (the wrapper and the launch included), and device_ms, the card's time a
    call with the host out of the way. The byte bound is a floor under every
    design: the distinct index sectors this launch's answers stand on, as
    the plain version gathered them by address (the leaf record of each
    longest-match search, the rank rows at ip - 1 and ip and on both sides
    of both borders of every interval a caller reads, the text that decides
    their compares; a sector shared by rows, queries or reads once), plus
    the tables read and the results written once. Beside it: the sectors
    the scalar contract's binary searches read (work_sectors, one a probe),
    the kernel's own (rank rows and text, whole windows a step; their ratio
    to the work's, and to the answers' rank-row and text sectors). The
    latency figure is the slowest warp's dependent steps, as it counted
    them, times the least a dependent 16-byte random read takes (the chain
    microbenchmark of this run at a batch's lanes): the chain no batch can
    be faster than. ``di``: an index of the same planes under the other root
    than the one ``work`` was counted under (the same answers, counted once
    a layout): the bound takes its root's records, and the scalar searches'
    sectors, which were those of the other root, are not given."""
    own = di is None
    n_answer = work.answer_sectors(root=di)
    n_work = int(work.probes.sum()) if own else None
    n_rows_text = work.answer_sectors(leaves=False)
    n_kernel, steps = int(counts[0].sum()), int(counts[1].max())
    check(n_kernel >= n_rows_text, "the kernel read fewer sectors than its "
          "answers stand on: the bound is no floor")
    from bwameme_tpu_torch.bench_util import cuda_ms, queued_us

    return dict(
        max_abs_err=err, ms=cuda_ms(kern, 10),
        device_ms=queued_us(kern, 100) / 1e3, plain_ms=plain_ms,
        library_ms=None,
        bound_ms=(n_answer * SECTOR + fixed_bytes) / HBM_BPS * 1e3,
        bound_by="bytes", answer_sectors=n_answer, work_sectors=n_work,
        kernel_sectors=n_kernel,
        kernel_sectors_ratio=n_kernel / max(n_work, 1) if own else None,
        kernel_to_answer_ratio=n_kernel / max(n_rows_text, 1),
        latency_steps=steps, latency_bound_ms=steps * chain_us / 1e3)


def variant_of(di, name: str) -> str:
    from bwameme_tpu_torch.ops.launch import variant

    return variant(name, di.mode, di.wide, di.root)


def window_fns(di):
    """The window kernel of the index's root and its plain version."""
    from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda

    if di.root == "kmer":
        return seed_smem_cuda.kmer_window, seed_smem.kmer_window_torch
    return seed_smem_cuda.prmi_window, seed_smem.prmi_window_torch


def window_keys(idx, rng, n_keys: int):
    """Keys for prmi_window: stored keys of random ranks, a third cut to
    19..31 bases and padded with zeros, a third padded with ones, as
    interval_at and find_longest pad them; returns (ranks, khi, klo) with
    the key words as int32 storage on the host."""
    import numpy as np

    ranks = rng.integers(0, idx.n_sa, n_keys)
    khi = np.asarray(idx.key_hi)[ranks].astype(np.uint32)
    klo = np.asarray(idx.key_lo)[ranks].astype(np.uint32)
    keep = rng.integers(19, 33, n_keys)
    mh = ~(np.uint64(0xFFFFFFFF) >> np.minimum(keep * 2, 32).astype(np.uint64))
    ml = ~(np.uint64(0xFFFFFFFF) >> np.maximum(keep * 2 - 32, 0).astype(np.uint64))
    mh, ml = mh.astype(np.uint32), ml.astype(np.uint32)
    third = n_keys // 3
    khi[:third] &= mh[:third]
    klo[:third] &= ml[:third]
    khi[third: 2 * third] = (khi & mh | ~mh)[third: 2 * third]
    klo[third: 2 * third] = (klo & ml | ~ml)[third: 2 * third]
    return ranks, khi.view(np.int32), klo.view(np.int32)


def query_jobs(batch, rng, per_read: int, dev):
    """sa_query jobs cut from a batch's reads: both strands, whole windows
    and cut ones, min_intv from 1 up; (row, pivot, v, min_intv) int32."""
    import numpy as np
    import torch

    R = batch.R
    _, nf, nr, _ = batch.prep
    rd = np.repeat(np.arange(R), per_read)
    lens = batch.lens.cpu().numpy()[rd]
    piv = (rng.random(R * per_read) * np.maximum(lens, 1)).astype(np.int64)
    rev = rng.integers(0, 2, R * per_read)
    nf_h, nr_h = nf.cpu().numpy(), nr.cpu().numpy()
    full = np.where(rev == 1, nr_h[rd, piv], nf_h[rd, piv]) - piv
    v = np.where(rng.random(R * per_read) < 0.7, full,
                 (rng.random(R * per_read) * (full + 1)).astype(np.int64))
    mi = rng.choice([1, 1, 1, 2, 3, 11, 21, 501], R * per_read)
    return [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (rd + rev * R, piv, v, mi)]


def check_layout(eng, reads, kh, kl, dev, chain_us: float, rng,
                 counted=None):
    """Every seeding kernel of the engine's layout and root against its
    plain version on the card: the root's window on the keys kh, kl (host
    int32 storage), sa_query on JOBS_PER_READ jobs a read, the three rounds on the
    reads; each one's report row (times, bound, the plain version's
    counts), keyed by the variant's name. ``counted``: what this check
    returned for the same planes, reads and keys under the other root (the
    jobs, and the work its plain versions counted): its jobs are taken, and
    the plain versions run without counting, the bounds taken from that
    work (the answers are the same). Returns (report, the batch, the jobs,
    the sa_query result, (the jobs, the work counted))."""
    import torch

    from bwameme_tpu_torch.bench_util import Rounds, cuda_ms
    from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda
    from bwameme_tpu_torch.ops.sa_search import Work

    di, report = eng.di, {}
    rb = 8 if di.wide else 4
    khd, kld = (torch.from_numpy(k).to(dev) for k in (kh, kl))
    win, win_plain = window_fns(di)
    got = win(di, khd, kld)
    want = win_plain(di, khd, kld)
    torch.cuda.synchronize()
    err = max(abs_err(got[0], want[0]), abs_err(got[1], want[1]))
    name = variant_of(di, "prmi_window")
    check(err == 0, f"{name} differs from its plain version: {err}")
    n = len(kh)
    # a key's root in one sector (the leaf record, and a wide index's leaf
    # starts in another; or the k-mer table's two entries), the key read
    # and the window written once
    wide_leaf = di.wide and di.root == "prmi"
    report[name] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: win(di, khd, kld), 20),
        plain_ms=cuda_ms(lambda: win_plain(di, khd, kld), 5),
        library_ms=None, bound_by="bytes",
        bound_ms=n * (SECTOR * (2 if wide_leaf else 1) + 8 + 2 * rb)
        / HBM_BPS * 1e3)

    batch = Rounds(eng, reads, dev)
    qbuf, nf, _, _ = batch.prep
    R = batch.R
    if counted is None:
        jobs = query_jobs(batch, rng, JOBS_PER_READ, dev)
        works, other = {}, None
    else:
        (jobs, works), other = counted, di
    n = jobs[0].shape[0]
    counts = torch.zeros((2, n), dtype=torch.int32, device=dev)
    work = Work(n, dev) if other is None else None
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs, counts=counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = seed_smem.sa_query_torch(di, qbuf, *jobs, work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = abs_err(got, want)
    name = variant_of(di, "sa_query")
    check(err == 0, f"{name} differs from its plain version: {err}")
    works.setdefault("sa_query", work)
    report[name] = seeding_row(
        err, lambda: seed_smem_cuda.sa_query(di, qbuf, *jobs), plain_ms,
        works["sa_query"], counts, chain_us, n * (16 + 3 * rb), other)
    table_bytes = 4 * (qbuf.numel() + 3 * nf.numel() + R)
    for k, res, err, plain_ms, work, counts in compare_rounds(
            batch, dev, other is None):
        name = variant_of(di, f"seed_round{k + 1}")
        check(int(res[2].sum()) == 0, f"{name} ran out of emission slots")
        works.setdefault(k, work)
        report[name] = seeding_row(
            err, lambda: batch.run(k, batch.kernels[k]), plain_ms, works[k],
            counts, chain_us, table_bytes + int(res[1].sum()) * 4 * rb,
            other)
    return report, batch, jobs, got, (jobs, works)


def log_rounds(report, di, R: int) -> None:
    for k in range(3):
        name = variant_of(di, f"seed_round{k + 1}")
        row = report[name]
        log(f"{name} == plain on {R} reads (max abs err "
            f"{row['max_abs_err']}): the answers stand on "
            f"{row['answer_sectors']} distinct index sectors, "
            f"{row['answer_sectors'] / R:.0f} a read; "
            + (f"the scalar searches read {row['work_sectors'] / R:.0f} a "
               "read; " if row["work_sectors"] is not None else "")
            + f"the kernel "
            f"{row['kernel_sectors'] / R:.0f} sectors a read, the slowest "
            f"read {row['latency_steps']} dependent steps "
            f"({row['latency_bound_ms']:.3f} ms); kernel {row['ms']:.4f} ms "
            f"a call alone, {row['device_ms']:.4f} ms on the card, plain "
            f"{row['plain_ms']:.0f} ms (one run"
            + (", counting its work)" if row["work_sectors"] is not None
               else ")"))


def fastq_codes(path: str):
    """The reads of a FASTQ file as code arrays (the pipeline's encoding)."""
    import numpy as np

    from bwameme_tpu_torch.index.packing import NT4_TABLE
    from bwameme_tpu_torch.io.fastq import read_chunks

    return [NT4_TABLE[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for chunk in read_chunks(path, chunk_bp=1 << 30) for r in chunk]


def flat_smems(eng, reads, batch: int):
    """The engine's FlatSmems of the reads, batch by batch, as tuples."""
    out = []
    for i in range(0, len(reads), batch):
        flat = eng.sorted_smems_batch_flat(reads[i: i + batch])
        check(flat is not None, "the packed SMEM buffer overflowed")
        out += [[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
                for lst in flat.to_lists()]
    return out


def phase_search(dev, mbp: float, n_reads: int, n_cmp: int, n_keys: int,
                 chain_us: float, main_fq: str):
    """``chain_us``: us a dependent 16-byte load at a batch's lanes, as
    ``phase_gather`` measured it; ``main_fq``: the main mem run's reads."""
    import numpy as np
    import torch

    from bwameme_tpu_torch.bench_util import (Rounds, get_index,
                                              planted_repeats,
                                              simulated_reads)
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops import seed_smem_cuda
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    idx = load_index(get_index(mbp))
    opt = MemOptions()
    t0 = time.perf_counter()
    eng = DeviceSeedingEngine(idx, opt, lanes=n_reads, device=dev)
    torch.cuda.synchronize()
    di = eng.di
    check((di.mode, di.wide) == (4, False), "the bench index's default "
          f"layout is mode {di.mode}{' wide' if di.wide else ''}")
    log(f"device index: {di.nbytes / 2**30:.2f} GiB (rank rows "
        f"{di.rk.shape[0]} x 16 B, {di.params.shape[0]} leaves, widest "
        f"window {di.max_width}) built and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(17)
    ranks, kh, kl = window_keys(idx, rng, n_keys)
    reads = simulated_reads(idx.text, idx.l_pac, n_reads, 151, rng,
                            planted_repeats(mbp))
    report, batch, jobs, got, counted = check_layout(eng, reads, kh, kl,
                                                     dev, chain_us, rng)
    lo, hi = (w.cpu().numpy()[2 * (n_keys // 3):]
              for w in seed_smem_cuda.prmi_window(
                  di, *(torch.from_numpy(k).to(dev) for k in (kh, kl))))
    exact = ranks[2 * (n_keys // 3):]
    # a window holds its key's lower bound: the key's own rank too, unless
    # the key repeats (the planted repeats)
    inside = ((lo <= exact) & (exact <= hi)).mean()
    check(inside >= 0.99, f"only {inside:.4f} of the stored keys' ranks lie "
          "inside their windows")
    log(f"prmi_window == plain on {n_keys} keys (a third zero-padded, a "
        f"third one-padded; {100 * inside:.3f}% of the stored keys' ranks "
        f"inside their windows, mean width {float((hi - lo).mean()):.1f})")
    row = report["sa_query"]
    n = jobs[0].shape[0]
    log(f"sa_query == plain on {n} jobs (longest match "
        f"{int(got[0].max())}, {int((got[0] > 48).sum())} past 48 bases; "
        f"the answers stand on {row['answer_sectors']} distinct index "
        f"sectors, {row['answer_sectors'] / n:.1f} a job; the scalar "
        f"searches read {row['work_sectors'] / n:.1f} a job; the kernel "
        f"{row['kernel_sectors'] / n:.1f} sectors a job, at most "
        f"{row['latency_steps']} dependent steps); kernel {row['ms']:.4f} ms "
        f"a call alone, {row['device_ms']:.4f} ms on the card")
    log_rounds(report, di, n_reads)

    # reads that stress a warp-a-read search on a cut genome under a coarse
    # P-RMI (windows wider than 32 x 30 ranks, runs of equal suffixes wider
    # than any probe); a batch size that fills no block
    t0 = time.perf_counter()
    coarse, regions = coarse_index(COARSE_MBP, COARSE_RMI_BITS)
    coarse_eng = DeviceSeedingEngine(coarse, opt, lanes=N_STRESS, device=dev)
    check(coarse_eng.di.max_width > 32 * 30, "the coarse index's windows are "
          f"only {coarse_eng.di.max_width} ranks wide")
    sreads = stress_reads(coarse.text, coarse.l_pac, N_STRESS, rng, regions)
    stress = Rounds(coarse_eng, sreads, dev)
    found = [(int(res[1].sum()), int(res[1].max()), int(res[2].sum()),
              int(counts[1].max()))
             for _, res, _, _, _, counts in compare_rounds(stress, dev, False)]
    log(f"stress reads on the coarse index (widest window "
        f"{coarse_eng.di.max_width}): the three rounds == plain on "
        f"{N_STRESS} reads of 19-500 bp (from repeats, with N); a round's "
        f"SMEMs, the most a read emits (of its {coarse_eng.max_smems} slots "
        f"in rounds 1 and 3, {coarse_eng.max_reseeds} in round 2), "
        f"emissions past the slots, most steps of a read: {found}; "
        f"{time.perf_counter() - t0:.1f} s")
    del coarse_eng, stress

    # through the engine, against the scalar oracle
    host = HostSeedingEngine(idx, opt)
    t0 = time.perf_counter()
    want = [[(s.start, s.end, s.sa_lo, s.hitcount)
             for s in host.sorted_smems(c)] for c in reads[:n_cmp]]
    host_s = time.perf_counter() - t0
    flat = flat_smems(eng, reads, n_reads)
    check(flat[:n_cmp] == want, "device SMEMs differ from the "
          "HostSeedingEngine's")
    lists = eng.sorted_smems_batch(reads[:n_cmp])
    check([[(s.start, s.end, s.sa_lo, s.hitcount) for s in lst]
           for lst in lists] == want, "device SMEM lists differ from the "
          "HostSeedingEngine's")
    log(f"device SMEMs == HostSeedingEngine on {n_cmp} reads "
        f"({sum(map(len, want))} SMEMs; the oracle took {host_s:.1f} s); "
        f"{sum(map(len, flat))} SMEMs in the batch of {n_reads}")
    # the k-mer root (the ERT backend) on the same planes, keys and reads
    kmer, paths = ert_full_size(eng, reads, kh, kl, ranks, dev, chain_us,
                                want, counted)
    report.update(kmer)

    # the primitives have no caller on the mem path (the rounds inline
    # them): their path is this run of the two entry points, counted from 0
    qbuf = batch.prep[0]
    stats.reset()
    seed_smem_cuda.prmi_window(di, *(torch.from_numpy(k).to(dev)
                                     for k in (kh, kl)))
    seed_smem_cuda.sa_query(di, qbuf, *jobs)
    torch.cuda.synchronize()
    for name in ("prmi_window", "sa_query"):
        report[name]["launches"] = stats.launches[name]
        check(report[name]["launches"] > 0, f"{name} was not launched")

    # mode 1 (positions only) at full width: the same keys, jobs and reads
    t0 = time.perf_counter()
    eng1 = DeviceSeedingEngine(idx, opt, lanes=n_reads, device=dev, mode=1)
    torch.cuda.synchronize()
    up1 = time.perf_counter() - t0
    r1, b1, jobs1, _, counted1 = check_layout(
        eng1, reads, kh, kl, dev, chain_us, np.random.default_rng(17 + 1))
    # prmi_window is one kernel in every mode: its row stays mode 4's
    r1.pop("prmi_window")
    report.update(r1)
    log(f"mode 1 at {mbp:g} Mbp: {eng1.di.nbytes / 2**30:.2f} GiB of planes "
        f"(mode 4: {di.nbytes / 2**30:.2f}), built and uploaded in "
        f"{up1:.1f} s; prmi_window, sa_query ({jobs1[0].shape[0]} jobs) and "
        "the three rounds == plain")
    log_rounds(report, eng1.di, n_reads)
    stats.reset()
    seed_smem_cuda.sa_query(eng1.di, b1.prep[0], *jobs1)
    torch.cuda.synchronize()
    report["sa_query[m1]"]["launches"] = stats.launches["sa_query[m1]"]
    kmer, paths1 = ert_full_size(eng1, reads, kh, kl, None, dev, chain_us,
                                 None, counted1)
    report.update(kmer)
    paths.update(paths1)
    del eng1, b1

    # the wide mode-1 engine over the main run's reads: its SMEMs == the
    # narrow mode-4 engine's (the wide variants' launches on this path)
    main_reads = fastq_codes(main_fq)
    t0 = time.perf_counter()
    eng1w = DeviceSeedingEngine(idx, opt, lanes=n_reads, device=dev, mode=1,
                                wide=True)
    torch.cuda.synchronize()
    up1w = time.perf_counter() - t0
    stats.reset()
    wide = flat_smems(eng1w, main_reads, n_reads)
    launches = {k: v for k, v in stats.launches.items() if v}
    check(all(launches.get(variant_of(eng1w.di, f"seed_round{k}"), 0) > 0
              for k in (1, 2, 3)), f"the wide engine launched {launches}")
    check(flat_smems(eng, main_reads, n_reads) == wide, "the wide mode-1 "
          "engine's SMEMs differ from the narrow mode-4 engine's")
    log(f"wide mode-1 engine ({eng1w.di.nbytes / 2**30:.2f} GiB of planes, "
        f"uploaded in {up1w:.1f} s): FlatSmems == the narrow mode-4 "
        f"engine's on the main run's {len(main_reads)} reads "
        f"({sum(map(len, wide))} SMEMs); launches {launches}")
    return report, {"engine, mode 1 wide": launches, **paths}


def layout_path(mode: int, wide: bool, root: str = "prmi") -> str:
    return (f"engine, mode {mode}{' kmer' if root == 'kmer' else ''}"
            f"{' wide' if wide else ''}")


def phase_layouts(dev, chain_us: float):
    """The layouts the main paths do not take (modes 2 and 3, and 1-4
    wide), each with both roots, on the bench genome cut to SIDE_MBP: each
    engine's path, over LAYOUT_READS reads with every count at 0, then every
    kernel of the layout against its plain version, timed, with its bound;
    the plain versions count the work under the P-RMI only, the k-mer
    root's bounds come from that count (check_layout's ``counted``)."""
    import numpy as np
    import torch

    from bwameme_tpu_torch.bench_util import (get_index, planted_repeats,
                                              simulated_reads)
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops import seed_smem_cuda
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    idx = load_index(get_index(SIDE_MBP))
    opt = MemOptions()
    rng = np.random.default_rng(23)
    _, kh, kl = window_keys(idx, rng, LAYOUT_KEYS)
    reads = simulated_reads(idx.text, idx.l_pac, LAYOUT_READS, 151, rng,
                            planted_repeats(SIDE_MBP))
    report, by_path = {}, {}
    for mode, wide in LAYOUTS:
        counted = None
        for root in ("prmi", "kmer"):
            t0 = time.perf_counter()
            eng = DeviceSeedingEngine(idx, opt, lanes=LAYOUT_READS,
                                      device=dev, mode=mode, wide=wide,
                                      root=root)
            di = eng.di
            path = layout_path(mode, wide, root)
            stats.reset()
            flat = flat_smems(eng, reads, LAYOUT_READS)
            by_path[path] = {k: v for k, v in stats.launches.items() if v}
            rows, batch, jobs, _, counted = check_layout(
                eng, reads, kh, kl, dev, chain_us, rng, counted)
            # the window is one kernel in every mode: its narrow row is the
            # search phase's, its wide row the first wide layout's
            narrow_window = "kmer_window" if root == "kmer" else "prmi_window"
            rows = {k: v for k, v in rows.items()
                    if k != narrow_window and k not in report}
            stats.reset()
            if f"{narrow_window}[wide]" in rows:
                window_fns(di)[0](di, *(torch.from_numpy(k).to(dev)
                                        for k in (kh, kl)))
            seed_smem_cuda.sa_query(di, batch.prep[0], *jobs)
            torch.cuda.synchronize()
            for name in rows:
                rows[name]["launches"] = (
                    by_path[path].get(name, 0)
                    if name.startswith("seed_round") else stats.launches[name])
            report.update(rows)
            log(f"{path} at {SIDE_MBP:g} Mbp ({di.nbytes / 2**20:.1f} MiB of "
                f"planes): {sum(map(len, flat))} SMEMs of {LAYOUT_READS} "
                "reads; the window, sa_query and the rounds == plain"
                + (" (the work counted under the P-RMI)" if root == "kmer"
                   else "") + "; ms alone / on the card: " + ", ".join(
                    f"{n} {r['ms']:.4f}" + (f" / {r['device_ms']:.4f}"
                                            if "device_ms" in r else "")
                    for n, r in rows.items())
                + f"; {time.perf_counter() - t0:.1f} s")
            del eng, batch
    return report, by_path


def phase_jumbo(dev):
    """More than 2^31 suffixes on one card, mode 1 wide: the analytic
    periodic index (bench_util.periodic_index: a block of JUMBO_P bases
    tiled to JUMBO_N), built on the card. sa_query against the closed form
    on JUMBO_ROTATIONS rotations, some lb past 2^31; prmi_window and the
    three rounds against their plain versions (keys of every leaf, reads cut
    from the text)."""
    import types

    import numpy as np
    import torch

    from bwameme_tpu_torch.bench_util import (Rounds, expected_hit,
                                              periodic_index, periodic_reads)
    from bwameme_tpu_torch.index.packing import pack_words
    from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    p, m, n = JUMBO_P, JUMBO_M, JUMBO_N
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    di, block, rot = periodic_index(n, p, m, seed=9, device=dev)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    check(di.n_sa > 2**31 and (di.mode, di.wide) == (1, True),
          "the jumbo index is not a wide mode-1 index past 2^31 suffixes")

    # sa_query against the closed form
    rng = np.random.default_rng(31)
    ks = np.unique(np.concatenate([[0, 1, p // 2, p - 2, p - 1],
                                   rng.integers(0, p, JUMBO_ROTATIONS)]))
    L = 48
    tile2 = np.tile(block, 2)
    pats = np.stack([tile2[int(rot[k]): int(rot[k]) + L] for k in ks])
    words = np.stack([pack_words(c) for c in pats])
    qbuf = np.full((len(ks), L // 16 + 3), 0xFFFFFFFF, np.uint32)
    qbuf[:, : L // 16] = words
    qbuf = torch.from_numpy(qbuf.view(np.int32)).to(dev)
    jobs = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        np.arange(len(ks)), np.zeros(len(ks)), np.full(len(ks), L),
        np.ones(len(ks)))]
    got = seed_smem_cuda.sa_query(di, qbuf, *jobs)
    want = seed_smem.sa_query_torch(di, qbuf, *jobs)
    err = abs_err(got, want)
    check(err == 0, f"sa_query[m1,wide] differs from its plain version on "
          f"the jumbo index: {err}")
    hits = got.cpu().numpy()
    closed = np.array([expected_hit(block, rot, n, p, m, int(k), L)
                       for k in ks]).T
    check((hits == closed).all(), "sa_query on the jumbo index differs "
          "from the closed form")
    n_big = int((hits[1] > 2**31).sum())
    check(n_big > 0, "no lb of the jumbo queries passes 2^31")

    # prmi_window on keys of every leaf (a base, then random bits)
    leaf = rng.integers(0, 4, JUMBO_KEYS).astype(np.uint64)
    key = (leaf << np.uint64(62)) | rng.integers(
        0, 1 << 62, JUMBO_KEYS, dtype=np.uint64)
    kh = torch.from_numpy((key >> np.uint64(32)).astype(np.uint32)
                          .view(np.int32)).to(dev)
    kl = torch.from_numpy((key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                          .view(np.int32)).to(dev)
    wg = seed_smem_cuda.prmi_window(di, kh, kl)
    wp = seed_smem.prmi_window_torch(di, kh, kl)
    werr = max(abs_err(wg[0], wp[0]), abs_err(wg[1], wp[1]))
    check(werr == 0, f"prmi_window[wide] differs from its plain version on "
          f"the jumbo index: {werr}")

    # the three rounds on reads cut from the text
    eng = types.SimpleNamespace(
        di=di, opt=MemOptions(), max_smems=96, max_reseeds=16,
        _batch_matrix=DeviceSeedingEngine._batch_matrix)
    reads = periodic_reads(block, JUMBO_READS, 151, rng)
    batch = Rounds(eng, reads, dev)
    found = []
    for _, res, _, _, _, _ in compare_rounds(batch, dev, False):
        used = (torch.arange(res[0].shape[2], device=dev)[None, :]
                < res[1][:, None])
        lbs = res[0][2][used]
        found.append((int(res[1].sum()), int(lbs.max()) if lbs.numel() else 0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"jumbo: {n} suffixes (2^31 + {n - 2**31}; a {p}-base block, m = "
        f"{m}), mode 1 wide, {di.nbytes / 2**30:.2f} GiB of planes built on "
        f"the card in {built:.1f} s; sa_query == closed form == plain on "
        f"{len(ks)} rotations ({n_big} lb past 2^31, the largest "
        f"{int(hits[1].max())}); prmi_window == plain on {JUMBO_KEYS} keys "
        f"of the 4 leaves (windows up to {int((wg[1] - wg[0]).max())} "
        f"ranks); the three rounds == plain on {JUMBO_READS} reads (SMEMs, "
        f"largest first sa_lo: {found}); peak device memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    del di, batch, eng


# ---------------------------------------------------- phase 5: end to end


def write_reads(path: str, text, l_pac: int, n: int, read_len: int, rng):
    """n reads from the forward strand, Poisson(1) substitutions, every other
    one reverse-complemented; the name holds the source position."""
    import numpy as np

    with open(path, "w") as f:
        for i in range(n):
            st = int(rng.integers(0, l_pac - read_len - 1))
            c = np.array(text[st: st + read_len])
            for _ in range(rng.poisson(1.0)):
                p = int(rng.integers(0, read_len))
                c[p] = (c[p] + rng.integers(1, 4)) % 4
            if i % 2:
                c = (3 - c[::-1]).astype(np.uint8)
            seq = "".join("ACGT"[x] for x in c)
            f.write(f"@r{i}_{st}_{i % 2}\n{seq}\n+\n{'I' * read_len}\n")


def write_deletion_reads(path: str, text, l_pac: int, n: int, rng):
    """151 bp reads with a 16-40 bp deletion on each side of a middle
    segment: under a narrow band (-w 20) their extensions run the
    band-retry ladder."""
    import numpy as np

    with open(path, "w") as f:
        for i in range(n):
            g1, g2 = (int(x) for x in rng.integers(16, 41, 2))
            st = int(rng.integers(0, l_pac - 300))
            c = np.concatenate([text[st: st + 45],
                                text[st + 45 + g1: st + 105 + g1],
                                text[st + 105 + g1 + g2: st + 151 + g1 + g2]])
            seq = "".join("ACGT"[x] for x in c)
            f.write(f"@d{i}_{st}_0\n{seq}\n+\n{'I' * len(c)}\n")


def sam_records(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@")]


def mapped_to_source(records: list[str]) -> tuple[int, int]:
    ok = n = 0
    for ln in records:
        f = ln.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        n += 1
        _, st, rc = f[0].split("_")
        if (not flag & 4 and abs(int(f[3]) - 1 - int(st)) <= 10
                and bool(flag & 16) == (rc == "1")):
            ok += 1
    return ok, n


def run_mem(cli, prefix: str, reads: str, out: str, device: str,
            flags=(), reads2: str | None = None) -> tuple[float, dict]:
    """cli.main mem on one device (the default engine unless the flags say
    otherwise), with every kernel's launch count set to 0 just before;
    returns its wall time and the counts read just after, and leaves the
    run's stages (index_load, index_upload, align, write, s) and, on the
    card, its peak device memory (peak_mib) in LAST_RUN. reads2: the second
    mates' file of a paired-end run."""
    import torch

    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.utils import timer

    old = os.environ.pop("BWAMEME_PLATFORM", None)
    if device == "cpu":
        os.environ["BWAMEME_PLATFORM"] = "cpu"
    made = []

    class Recording(timer.StageTimer):
        def __init__(self):
            super().__init__()
            made.append(self)

    plain_timer, timer.StageTimer = timer.StageTimer, Recording
    try:
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        stats.reset()
        t0 = time.perf_counter()
        rc = cli.main(["mem", *flags, prefix, reads,
                       *([reads2] if reads2 else []), "-o", out])
        wall = time.perf_counter() - t0
        launches = dict(stats.launches)
    finally:
        timer.StageTimer = plain_timer
        os.environ.pop("BWAMEME_PLATFORM", None)
        if old is not None:
            os.environ["BWAMEME_PLATFORM"] = old
    LAST_RUN.clear()
    LAST_RUN.update(dict(made[0].totals) if made else {})
    if device != "cpu":
        LAST_RUN["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    check(rc == 0, f"mem on {device} exited {rc}")
    check(device != "cpu" or not any(launches.values()),
          f"a CPU run launched kernels: {launches}")
    return wall, launches


def run_mem_timed(cli, prefix: str, reads: str, out: str, flags=()):
    """run_mem on the card with the pipeline's sub-stages counted from 0 and
    each launch's device time recorded: (wall, launches, the sub-stages'
    seconds, the kernels' device ms)."""
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.utils.timer import TPROF

    TPROF.totals.clear()
    TPROF.counts.clear()
    stats.events = []
    try:
        wall, launches = run_mem(cli, prefix, reads, out, "cuda", flags)
        gpu_ms = stats.device_ms()
    finally:
        stats.events = None
    return wall, launches, dict(TPROF.totals), gpu_ms


def log_stages(what: str, stages: dict, gpu_ms: dict) -> None:
    log(f"{what}: kernel device ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(gpu_ms.items())) + "; stages (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            stages.items(), key=lambda kv: -kv[1])))


def write_main_reads(mbp: float, n_reads: int) -> str:
    """The main single-end run's reads (phase 5), written before the search
    phase, whose wide mode-1 engine seeds them too."""
    import numpy as np

    from bwameme_tpu_torch.bench_util import CACHE, get_index
    from bwameme_tpu_torch.index.build import load_index

    work = os.path.join(CACHE, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "short.fq")
    idx = load_index(get_index(mbp))
    write_reads(path, idx.text, idx.l_pac, n_reads, 151,
                np.random.default_rng(11))
    return path


def no_isa_copy(prefix: str) -> str:
    """The index at ``prefix`` saved again without its inverse suffix array,
    as ``index --no-isa`` builds it."""
    import dataclasses

    from bwameme_tpu_torch.index.build import load_index, save_index

    out = prefix + "_noisa"
    if not os.path.isdir(out + ".meme"):
        save_index(dataclasses.replace(load_index(prefix), isa=None), out)
    return out


def phase_end_to_end(mbp: float, n_reads: int, n_long: int, batch: int,
                     n_cmp: int, short_fq: str):
    """The main path, the default engine on the n_reads short reads of the
    bench genome at ``mbp`` in ``short_fq``, and the same reads with --mode
    1, SAM for SAM; then, on the bench genome cut to SIDE_MBP (its index
    built in seconds, and no run pays 100 Mbp of rank rows), the runs held
    against each other: n_cmp short reads on the card (modes 4, 3, 2 and 1
    and an index without the ISA), on the CPU and with --engine host, the
    long reads (--engine host) and the deletion reads (-w 20) on the card
    and on the CPU."""
    import numpy as np
    import torch

    from bwameme_tpu_torch import cli
    from bwameme_tpu_torch.bench_util import CACHE, get_index
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.utils.timer import TPROF

    prefix, side = get_index(mbp), get_index(SIDE_MBP)
    work = os.path.join(CACHE, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(12)
    main_head_fq = os.path.join(work, "short_main_head.fq")
    with open(short_fq) as f, open(main_head_fq, "w") as g:
        g.writelines(f.readlines()[: 4 * n_cmp])
    idx = load_index(side)
    head_fq = os.path.join(work, "short_head.fq")
    write_reads(head_fq, idx.text, idx.l_pac, n_cmp, 151, rng)
    long_fq = os.path.join(work, "long.fq")
    write_reads(long_fq, idx.text, idx.l_pac, n_long, 1000, rng)
    del_fq = os.path.join(work, "deletions.fq")
    write_deletion_reads(del_fq, idx.text, idx.l_pac, 64, rng)
    del idx

    # each path is driven with the counts at 0 and read just after (run_mem)
    seeding = ("seed_round1", "seed_round2", "seed_round3")
    stats.events = []
    TPROF.totals.clear()
    TPROF.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    sam = lambda name: os.path.join(work, name)
    by_path = {}
    wall, by_path["device"] = run_mem(
        cli, prefix, short_fq, sam("short.gpu.sam"), "cuda",
        ("--batch", str(batch)))
    gpu_ms = stats.device_ms()
    stages = dict(TPROF.totals)
    main_run = dict(LAST_RUN)
    peak = main_run["peak_mib"] * 2**20
    stats.events = None
    n_batches = -(-n_reads // batch)
    got = by_path["device"]
    for name in seeding:
        check(got[name] == n_batches, f"{name}: {got[name]} launches for "
              f"{n_batches} batches of the default mem path")
    check(got["banded_sw_coord"] >= 2 * n_batches, "banded_sw_coord: "
          f"{got['banded_sw_coord']} launches for {n_batches} batches")
    # mode 1 (positions only) on the same reads: the same SAM
    wall1, by_path["mode1"] = run_mem(
        cli, prefix, short_fq, sam("short.m1.gpu.sam"), "cuda",
        ("--batch", str(batch), "--mode", "1"))
    mode1_run = dict(LAST_RUN)
    for name in seeding:
        check(by_path["mode1"][f"{name}[m1]"] == n_batches,
              f"{name}[m1]: {by_path['mode1'][f'{name}[m1]']} launches for "
              f"{n_batches} batches of mem --mode 1")
    check(sam_records(sam("short.m1.gpu.sam")) == sam_records(
        sam("short.gpu.sam")), "mem --mode 1 SAM differs from mode 4's")
    log(f"mem --mode 1 == mode 4, SAM for SAM, on {n_reads} reads at {mbp:g} "
        "Mbp; index_upload / align / peak device memory: mode 4 "
        f"{main_run['index_upload']:.2f} s / {main_run['align']:.2f} s / "
        f"{main_run['peak_mib']:.1f} MiB (wall {wall:.2f} s), mode 1 "
        f"{mode1_run['index_upload']:.2f} s / {mode1_run['align']:.2f} s / "
        f"{mode1_run['peak_mib']:.1f} MiB (wall {wall1:.2f} s)")
    _, by_path["head"] = run_mem(cli, side, head_fq, sam("short_head.gpu.sam"),
                                 "cuda", ("--batch", str(batch)))
    # the side genome in modes 3, 2 and 1, and without its ISA (auto: mode 2)
    side_runs = {}
    for label, pre, flags in (("m3", side, ("--mode", "3")),
                              ("m2", side, ("--mode", "2")),
                              ("m1", side, ("--mode", "1")),
                              ("noisa", no_isa_copy(side), ())):
        _, side_runs[label] = run_mem(
            cli, pre, head_fq, sam(f"short_head.{label}.gpu.sam"), "cuda",
            ("--batch", str(batch), *flags))
    mode_of = {"m3": "[m3]", "m2": "[m2]", "m1": "[m1]", "noisa": "[m2]"}
    for label, counts in side_runs.items():
        check(all(counts[f"{k}{mode_of[label]}"] for k in seeding),
              f"the {label} run on the side genome launched {counts}")
    by_path.update((f"head_{k}", v) for k, v in side_runs.items())
    check(all(by_path["head"][k] for k in seeding),
          f"the device engine on the short reads launched {by_path['head']}")
    wall_long, by_path["host_long"] = run_mem(
        cli, side, long_fq, sam("long.gpu.sam"), "cuda", ("--engine", "host"))
    check(by_path["host_long"]["banded_sw_pairs"] > 0,
          "banded_sw_pairs was not launched on the long reads' path")
    _, by_path["deletions"] = run_mem(
        cli, side, del_fq, sam("deletions.gpu.sam"), "cuda", ("-w", "20"))
    retry = by_path["deletions"]["banded_sw_coord"] - 2
    check(retry > 0, "the band-retry ladder launched nothing on the card")
    _, by_path["host_short"] = run_mem(
        cli, side, head_fq, sam("short_head.host.sam"), "cuda",
        ("--engine", "host"))
    check(by_path["host_short"]["banded_sw_coord"] > 0 and not any(
        by_path["host_short"][k] for k in seeding),
        f"--engine host on short reads launched {by_path['host_short']}")
    for path, counts in by_path.items():
        log(f"kernel launches, {path}: "
            f"{ {k: v for k, v in counts.items() if v} }")

    recs = sam_records(sam("short.gpu.sam"))
    names = [ln.split("\t")[0] for ln in recs
             if not int(ln.split("\t")[1]) & 0x900]
    check(len(names) == n_reads and len(set(names)) == n_reads,
          f"{len(names)} primary records for {n_reads} reads")
    ok, n = mapped_to_source(recs)
    check(ok >= 0.95 * n, f"only {ok}/{n} reads mapped to their source")
    log(f"short reads: {n} primary records, {ok} ({100 * ok / n:.1f}%) at "
        f"their source")
    kernel_ms = sum(gpu_ms.values())
    log(f"end to end ({mbp:g} Mbp, {n_reads} x 151 bp in batches of {batch}, "
        f"device seeding): {n_reads / wall:.1f} reads/s over {wall:.2f} s "
        f"wall (index load and upload included), kernel device time "
        f"{kernel_ms:.2f} ms = {100 * kernel_ms / (wall * 1e3):.3f}% of the "
        f"wall; peak device memory {peak / 2**20:.1f} MiB")
    log("kernel device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(gpu_ms.items())))
    log("stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   sorted(stages.items(), key=lambda kv: -kv[1])))
    align_s = sum(v for k, v in stages.items() if k in (
        "seed.submit", "seed.finish", "extend.submit", "extend.finish",
        "finalize"))
    if align_s:
        log(f"aligning alone (seed, chain, extend, finalize stages): "
            f"{n_reads / align_s:.1f} reads/s")
    log(f"long reads (--engine host, {SIDE_MBP:g} Mbp): {n_long} x 1000 bp "
        f"in {wall_long:.2f} s")

    # the main run's first n_cmp reads against the CPU's --engine host on
    # the same index (scalar seeding, plain banded SW: no rank rows)
    main_head = [ln for ln in recs if int(ln.split("_")[0][1:]) < n_cmp]
    wall_cmp, _ = run_mem(cli, prefix, main_head_fq,
                          sam("short_main_head.cpu.sam"), "cpu",
                          ("--engine", "host"))
    check(main_head == sam_records(sam("short_main_head.cpu.sam")),
          f"the main run's SAM differs from the CPU's --engine host SAM on "
          f"its first {n_cmp} reads")
    log(f"on the {mbp:g} Mbp genome: the main run's SAM == CPU --engine host "
        f"SAM on its first {n_cmp} reads ({len(main_head)} records; the "
        f"CPU run took {wall_cmp:.2f} s)")

    gpu_head = sam_records(sam("short_head.gpu.sam"))
    run_mem(cli, side, head_fq, sam("short_head.cpu.sam"), "cpu",
            ("--batch", str(batch)))
    check(gpu_head == sam_records(sam("short_head.cpu.sam")),
          f"GPU SAM differs from CPU SAM on {n_cmp} short reads")
    check(gpu_head == sam_records(sam("short_head.host.sam")),
          f"device-engine SAM differs from --engine host SAM on {n_cmp} "
          "short reads")
    for label in side_runs:
        check(gpu_head == sam_records(sam(f"short_head.{label}.gpu.sam")),
              f"the {label} SAM differs from mode 4's on {n_cmp} short reads")
    run_mem(cli, side, long_fq, sam("long.cpu.sam"), "cpu",
            ("--engine", "host"))
    check(sam_records(sam("long.gpu.sam")) == sam_records(sam("long.cpu.sam")),
          "GPU SAM differs from CPU SAM on long reads")
    ok_l, n_l = mapped_to_source(sam_records(sam("long.cpu.sam")))
    run_mem(cli, side, del_fq, sam("deletions.cpu.sam"), "cpu",
            ("--engine", "host", "-w", "20"))
    check(sam_records(sam("deletions.gpu.sam"))
          == sam_records(sam("deletions.cpu.sam")),
          "GPU SAM differs from CPU SAM on the band-retry reads")
    log(f"on the {SIDE_MBP:g} Mbp genome: GPU SAM (device engine, modes 4, "
        f"3, 2, 1 and the index without the ISA) == CPU SAM (plain "
        f"versions) == --engine host SAM on {n_cmp} short reads; GPU "
        f"== CPU on all {n_long} long reads ({ok_l}/{n_l} long at source) "
        f"and 64 two-deletion reads at -w 20 (device engine against the "
        f"CPU's --engine host; {retry} band-retry launches)")
    return by_path


# ------------------------------------------------- phase 5b: paired-end


def write_pairs(path1: str, path2: str, text, l_pac: int, n: int,
                read_len: int, rng) -> None:
    """n FR pairs from the forward strand: insert N(INSERT), Poisson(1)
    substitutions in each mate, in every other pair the first mate on the
    reverse strand; in every eighth pair (RESCUED) the second mate also has
    a substitution every 12 bases, so it has no 19-mer seed and only a mate
    rescue places it. The name holds both mates' leftmost source positions
    and whether the pair is one of those."""
    import numpy as np

    mean, sd = INSERT
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i in range(n):
            isize = max(int(round(rng.normal(mean, sd))), read_len)
            p = int(rng.integers(0, l_pac - isize - 1))
            left = np.array(text[p: p + read_len])
            right = np.array(text[p + isize - read_len: p + isize])
            for c in (left, right):
                for _ in range(rng.poisson(1.0)):
                    k = int(rng.integers(0, read_len))
                    c[k] = (c[k] + rng.integers(1, 4)) % 4
            right = (3 - right[::-1]).astype(np.uint8)
            (m1, s1), (m2, s2) = ((left, p), (right, p + isize - read_len))
            if i % 2:
                (m1, s1), (m2, s2) = (m2, s2), (m1, s1)
            rescued = i % RESCUED == RESCUED - 1
            if rescued:
                m2[6::12] = (m2[6::12] + 1) % 4
            name = f"p{i}_{s1}_{s2}_{int(rescued)}"
            for f, m in ((f1, m1), (f2, m2)):
                seq = "".join("ACGT"[x] for x in m)
                f.write(f"@{name}\n{seq}\n+\n{'I' * read_len}\n")


def interleave(path1: str, path2: str, out: str, n_pairs: int) -> None:
    """The first n_pairs pairs of two FASTQ files as one interleaved file
    (the -p form)."""
    with open(path1) as f1, open(path2) as f2, open(out, "w") as g:
        a, b = f1.readlines(), f2.readlines()
        for i in range(0, 4 * n_pairs, 4):
            g.writelines(a[i: i + 4] + b[i: i + 4])


def pairs_placed(records: list[str]) -> dict:
    """Per pair: both primaries flagged proper (0x2); each mate mapped within
    10 bases of its source; for the rescued mates apart."""
    out = dict(pairs=0, proper=0, at_source=0, mates=0, rescued=0,
               rescued_at_source=0)
    for ln in records:
        f = ln.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        _, s1, s2, rescued = f[0].split("_")
        second = bool(flag & 0x80)
        src = int(s2 if second else s1)
        ok = not flag & 4 and abs(int(f[3]) - 1 - src) <= 10
        out["mates"] += 1
        out["at_source"] += ok
        if not second:
            out["pairs"] += 1
            out["proper"] += bool(flag & 2)
        elif rescued == "1":
            out["rescued"] += 1
            out["rescued_at_source"] += ok
    return out


def phase_pairs(mbp: float, n_pairs: int, batch: int, n_cmp: int):
    """Paired-end mem on the bench genome: the whole library through the
    default engine (the main path: seeding and extension of both mates in
    the kernels, the chunk's rescue SW in one call of sw_full); then n_cmp
    pairs of the bench genome cut to SIDE_MBP under a fixed -I insert size,
    whose SAM must be the same from the card (as one -p interleaved file),
    from a CPU run of the plain versions and from --engine host (the serial
    host rescue)."""
    import numpy as np

    from bwameme_tpu_torch import cli
    from bwameme_tpu_torch.bench_util import CACHE, get_index
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.ops import sw_full
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.utils.timer import TPROF

    prefix, side = get_index(mbp), get_index(SIDE_MBP)
    work = os.path.join(CACHE, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(29)
    r1, r2 = (os.path.join(work, f"pairs_{k}.fq") for k in (1, 2))
    idx = load_index(prefix)
    write_pairs(r1, r2, idx.text, idx.l_pac, n_pairs, 151, rng)
    h1, h2, hp = (os.path.join(work, f"pairs_head_{k}.fq")
                  for k in (1, 2, "p"))
    idx = load_index(side)
    write_pairs(h1, h2, idx.text, idx.l_pac, n_cmp, 151, rng)
    del idx
    interleave(h1, h2, hp, n_cmp)
    sam = lambda name: os.path.join(work, name)

    # the main path, its rescue jobs noted as they go to the kernel
    jobs_seen = []
    coord = sw_full.sw_full_coord

    def noting(text32, q, jobs, *rest, **kw):
        jobs_seen.append(jobs.cpu().numpy())
        return coord(text32, q, jobs, *rest, **kw)

    sw_full.sw_full_coord = noting
    stats.events = []
    TPROF.totals.clear()
    TPROF.counts.clear()
    by_path = {}
    try:
        wall, by_path["pe"] = run_mem(cli, prefix, r1, sam("pairs.gpu.sam"),
                                      "cuda", ("--batch", str(batch)),
                                      reads2=r2)
        pe_run = dict(LAST_RUN)
        gpu_ms = stats.device_ms()
    finally:
        sw_full.sw_full_coord = coord
        stats.events = None
    stages = dict(TPROF.totals)
    got = by_path["pe"]
    n_batches = -(-2 * n_pairs // batch)
    check(got["sw_full"] > 0, "sw_full was not launched on the paired-end "
          "path")
    for name in ("seed_round1", "seed_round2", "seed_round3"):
        check(got[name] == n_batches, f"{name}: {got[name]} launches for "
              f"{n_batches} batches of the paired-end path")
    check(got["banded_sw_coord"] >= 2 * n_batches, "banded_sw_coord: "
          f"{got['banded_sw_coord']} launches on the paired-end path")
    placed = pairs_placed(sam_records(sam("pairs.gpu.sam")))
    check(placed["pairs"] == n_pairs and placed["mates"] == 2 * n_pairs,
          f"{placed['mates']} primary records for {n_pairs} pairs")
    check(placed["proper"] >= 0.95 * n_pairs, f"only {placed['proper']}/"
          f"{n_pairs} pairs are flagged proper")
    check(placed["rescued_at_source"] >= 0.9 * placed["rescued"],
          f"only {placed['rescued_at_source']}/{placed['rescued']} rescued "
          "mates lie at their source")
    jobs = np.concatenate(jobs_seen, axis=1)
    cells = int((jobs[0].astype(np.int64) * jobs[2]).sum())
    log(f"paired-end ({mbp:g} Mbp, {n_pairs} pairs of 2 x 151 bp, insert "
        f"N{INSERT}, default engine, batches of {batch}): {n_pairs / wall:.1f}"
        f" pairs/s over {wall:.2f} s wall (index_upload "
        f"{pe_run['index_upload']:.2f} s, align {pe_run['align']:.2f} s, peak "
        f"device memory {pe_run['peak_mib']:.1f} MiB); "
        f"{placed['proper']} proper, {placed['at_source']}/{placed['mates']} "
        f"mates at their source, {placed['rescued_at_source']}/"
        f"{placed['rescued']} of the mates only a rescue places")
    log(f"rescue: {len(jobs_seen)} call(s) of sw_full, {jobs.shape[1]} jobs, "
        f"T {int(jobs[2].min())}-{int(jobs[2].max())}, {cells} cells (forward"
        f" pass); sw_full {gpu_ms.get('sw_full', 0.0):.3f} ms on the card for "
        f"{got['sw_full']} launches")
    log("kernel device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(gpu_ms.items())))
    log("stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(stages.items(),
                                           key=lambda kv: -kv[1])))

    # the head under a fixed insert size (so that its SAM is its own, not
    # the whole library's statistics'): the card with the pairs in one -p
    # file, the plain versions, the host engine with its serial rescue
    fixed = ("-I", ",".join(map(str, INSERT)))
    _, by_path["pe_head"] = run_mem(cli, side, hp, sam("head.gpu.sam"),
                                    "cuda", ("-p", *fixed))
    _, by_path["pe_head_m1"] = run_mem(cli, side, hp, sam("head.m1.gpu.sam"),
                                       "cuda", ("-p", *fixed, "--mode", "1"))
    run_mem(cli, side, h1, sam("head.cpu.sam"), "cpu", fixed, reads2=h2)
    _, by_path["pe_head_host"] = run_mem(
        cli, side, h1, sam("head.host.sam"), "cuda",
        ("--engine", "host", *fixed), reads2=h2)
    head = sam_records(sam("head.gpu.sam"))
    check(head == sam_records(sam("head.cpu.sam")), "paired-end GPU SAM "
          f"differs from CPU SAM on {n_cmp} pairs")
    check(head == sam_records(sam("head.host.sam")), "paired-end "
          f"device-engine SAM differs from --engine host SAM on {n_cmp} "
          "pairs")
    check(head == sam_records(sam("head.m1.gpu.sam")), "paired-end mem "
          f"--mode 1 SAM differs from mode 4's on {n_cmp} pairs")
    check(all(by_path["pe_head_m1"][f"seed_round{k}[m1]"] for k in (1, 2, 3)),
          f"mem -p --mode 1 launched {by_path['pe_head_m1']}")
    check(by_path["pe_head"]["sw_full"] > 0, "sw_full was not launched on "
          "the head's path")
    check(by_path["pe_head_host"]["sw_full"] == 0, "--engine host launched "
          "sw_full: its rescue is the serial host SW")
    for path, counts in by_path.items():
        log(f"kernel launches, {path}: "
            f"{ {k: v for k, v in counts.items() if v} }")
    log(f"paired-end GPU SAM (device engine, -p {' '.join(fixed)}, modes 4 "
        f"and 1) == CPU SAM (plain versions) == --engine host SAM on "
        f"{n_cmp} pairs of the "
        f"{SIDE_MBP:g} Mbp genome ({len(head)} records)")
    return by_path


# ------------------------------------------------------------ phase 6: ERT


def with_kmer_root(eng):
    """The learned engine's planes with the ERT root added, at the size
    index/ert.pick_ert_bits gives: what DeviceSeedingEngine(root="kmer")
    builds, without assembling the rank rows again. Returns the engine and
    the seconds the table took to build and upload."""
    import copy
    import dataclasses

    import torch

    from bwameme_tpu_torch.index.device import kmer_root
    from bwameme_tpu_torch.index.ert import pick_ert_bits

    t0 = time.perf_counter()
    bits = pick_ert_bits(eng.di.n_sa)
    table = torch.from_numpy(kmer_root(eng.idx.key_hi, bits, eng.di.wide))
    di = dataclasses.replace(eng.di, kmer_table=table.to(eng.di.device),
                             kmer_bits=bits)
    torch.cuda.synchronize()
    kmer = copy.copy(eng)
    kmer.di = di
    return kmer, time.perf_counter() - t0


def ert_full_size(eng, reads, kh, kl, ranks, dev, chain_us: float, want,
                  counted):
    """The k-mer root's variants at the bench genome's size, on the learned
    engine's planes (phase 4's keys, reads, sa_query jobs and the work its
    plain versions counted, ``counted``, and for mode 4 the host oracle's
    SMEMs ``want`` of the first N_CMP reads and the keys' ``ranks``): the
    engine's path over the reads (counted from 0), then kmer_window (every
    stored key's rank inside its window: the table is exact), sa_query and
    the three rounds against their plain versions, timed, with their
    bounds. Returns the rows and the path's launches."""
    import torch

    from bwameme_tpu_torch.ops import seed_smem_cuda
    from bwameme_tpu_torch.ops.launch import stats

    eng, up = with_kmer_root(eng)
    di = eng.di
    widths = (di.kmer_table[1:] - di.kmer_table[:-1]).float()
    path = layout_path(di.mode, False, "kmer")
    stats.reset()
    flat = flat_smems(eng, reads, len(reads))
    launches = {k: v for k, v in stats.launches.items() if v}
    rows, batch, jobs, _, _ = check_layout(eng, reads, kh, kl, dev, chain_us,
                                           None, counted)
    stats.reset()
    if want is not None:
        lo, hi = (w.cpu().numpy() for w in seed_smem_cuda.kmer_window(
            di, *(torch.from_numpy(k).to(dev) for k in (kh, kl))))
        check(bool(((lo <= ranks) & (ranks < hi)).all()),
              "a stored key's rank lies outside its k-mer window")
        check(flat[:N_CMP] == want, "the k-mer root's SMEMs differ from the "
              "HostSeedingEngine's")
    else:       # the window is one kernel in every mode: mode 4's row
        rows.pop("kmer_window")
    seed_smem_cuda.sa_query(di, batch.prep[0], *jobs)
    torch.cuda.synchronize()
    for name in rows:
        rows[name]["launches"] = (launches.get(name, 0)
                                  if name.startswith("seed_round")
                                  else stats.launches[name])
    log(f"{path} at {GENOME_MBP:g} Mbp: a {di.kmer_bits}-base root, "
        f"{di.kmer_table.numel()} entries ("
        f"{di.kmer_table.numel() * di.kmer_table.element_size() / 2**20:.1f}"
        f" MiB; windows of {float(widths.mean()):.2f} ranks on average, "
        f"{int(widths.max())} at most), built and uploaded beside the "
        f"learned planes in {up:.2f} s; {sum(map(len, flat))} SMEMs of "
        f"{len(reads)} reads; the window, sa_query and the three rounds == "
        "plain" + (f", SMEMs == HostSeedingEngine on {N_CMP} reads"
                   if want is not None else ""))
    log_rounds(rows, di, len(reads))
    return rows, {f"{path}, {len(reads)} reads": launches}


def phase_ert(dev, main_fq: str):
    """The ERT backend (-Z) beyond phase 4's bench-genome checks
    (ert_full_size) and phase 4b's layouts (phase_layouts): the stress reads
    on the coarse genome under its k-mer root; then mem -Z on the main run's
    reads, whose SAM must be the default mem's. Returns the paths'
    launches."""
    import numpy as np

    from bwameme_tpu_torch import cli
    from bwameme_tpu_torch.bench_util import CACHE, Rounds, get_index
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    prefix = get_index(GENOME_MBP)
    opt = MemOptions()
    by_path = {}
    t0 = time.perf_counter()
    coarse, regions = coarse_index(COARSE_MBP, COARSE_RMI_BITS)
    coarse_eng = DeviceSeedingEngine(coarse, opt, lanes=N_STRESS, device=dev,
                                     root="kmer")
    cw = coarse_eng.di.kmer_table
    sreads = stress_reads(coarse.text, coarse.l_pac, N_STRESS,
                          np.random.default_rng(43), regions)
    stress = Rounds(coarse_eng, sreads, dev)
    found = [(int(res[1].sum()), int(res[1].max()), int(res[2].sum()),
              int(counts[1].max()))
             for _, res, _, _, _, counts in compare_rounds(stress, dev, False)]
    log(f"stress reads on the coarse genome with a "
        f"{coarse_eng.di.kmer_bits}-base root (widest window "
        f"{int((cw[1:] - cw[:-1]).max())}): the three rounds == plain on "
        f"{N_STRESS} reads; a round's SMEMs, the most a read emits, "
        f"emissions past the slots, most steps of a read: {found}; "
        f"{time.perf_counter() - t0:.1f} s")
    del coarse_eng, stress, cw

    work = os.path.join(CACHE, "chip_smoke")
    sam = lambda name: os.path.join(work, name)
    wall, by_path["ert"], stages, gpu_ms = run_mem_timed(
        cli, prefix, main_fq, sam("short.ert.gpu.sam"),
        ("--batch", str(BATCH), "-Z"))
    run = dict(LAST_RUN)
    log_stages("mem -Z", stages, gpu_ms)
    n_batches = -(-N_READS // BATCH)
    for k in (1, 2, 3):
        name = f"seed_round{k}[kmer]"
        check(by_path["ert"][name] == n_batches, f"{name}: "
              f"{by_path['ert'][name]} launches for {n_batches} batches of "
              "mem -Z")
    same_sam("mem -Z", sam("short.ert.gpu.sam"), sam("short.gpu.sam"))
    log(f"mem -Z == default mem, SAM for SAM, on {N_READS} reads at "
        f"{GENOME_MBP:g} Mbp: index_upload {run['index_upload']:.2f} s (rank "
        f"rows and the k-mer root), align {run['align']:.2f} s, wall "
        f"{wall:.2f} s, peak device memory {run['peak_mib']:.1f} MiB")
    log(f"kernel launches, mem -Z: "
        f"{ {k: v for k, v in by_path['ert'].items() if v} }")
    return by_path


def same_sam(what: str, got: str, want: str) -> None:
    """The records of two SAM files equal, or the run fails naming the reads
    that differ and showing the first records on either side."""
    a, b = sam_records(got), sam_records(want)
    if a == b:
        return
    only_a, only_b = sorted(set(a) - set(b)), sorted(set(b) - set(a))
    names = sorted({x.split("\t")[0] for x in only_a + only_b})
    raise SmokeFailure(
        f"{what}: the SAM differs from the default mem's on {len(names)} "
        f"reads, e.g. {names[:5]}; its records " + " | ".join(only_a[:3])
        + "; the default's " + " | ".join(only_b[:3]))


# ---------------------------------------------------- phase 7: FM-index


def fmi_side_reads(idx):
    """The side genome's reads that fmi_smem is held against the scalar
    FmiHostEngine on (the same in the oracle's process and the smoke's)."""
    import numpy as np

    from bwameme_tpu_torch.bench_util import planted_repeats, simulated_reads

    return simulated_reads(idx.text, idx.l_pac, FMI_SIDE_READS, 151,
                           np.random.default_rng(41),
                           planted_repeats(SIDE_MBP))


def fmi_stress():
    """The coarse genome's index, its FM-index and its stress reads."""
    import numpy as np

    from bwameme_tpu_torch.index.fmindex import build_fm_index

    coarse, regions = coarse_index(COARSE_MBP, COARSE_RMI_BITS)
    reads = stress_reads(coarse.text, coarse.l_pac, N_STRESS,
                         np.random.default_rng(47), regions)
    return coarse, build_fm_index(coarse.bns.code), reads


def fmi_oracle() -> None:
    """FmiHostEngine's SMEMs, in emission order, of the side genome's reads
    and of the stress reads, into .bench_cache/chip_smoke/fmi_oracle.npz
    (run by a process of its own while the card works: the scalar engine
    takes some 15 ms a read). Also builds the side genome's index and its
    FM-index files."""
    import numpy as np

    from bwameme_tpu_torch.bench_util import CACHE, get_fm_index, get_index
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.index.fmindex import load_fm_index
    from bwameme_tpu_torch.seeding.fmi_engine import FmiHostEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    t0 = time.perf_counter()
    side = get_fm_index(SIDE_MBP)
    get_index(SIDE_MBP)
    idx = load_index(side)
    opt = MemOptions()
    out = {}
    sets = [("side", FmiHostEngine(idx, opt, fm=load_fm_index(side)),
             fmi_side_reads(idx))]
    coarse, cfm, sreads = fmi_stress()
    sets.append(("stress", FmiHostEngine(coarse, opt, fm=cfm), sreads))
    for name, host, reads in sets:
        lists = [host.collect_smems(np.asarray(c)) for c in reads]
        out[f"{name}_off"] = np.cumsum([0] + [len(x) for x in lists])
        out[f"{name}_smems"] = np.array(
            [(s.start, s.end, s.sa_lo, s.hitcount) for x in lists
             for s in x], np.int64).reshape(-1, 4)
    work = os.path.join(CACHE, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    np.savez(os.path.join(work, "fmi_oracle.npz"), **out)
    print(f"FmiHostEngine on {FMI_SIDE_READS} side and {N_STRESS} stress "
          f"reads: {time.perf_counter() - t0:.1f} s", flush=True)


def oracle_lists(z, name: str):
    off, sm = z[f"{name}_off"], z[f"{name}_smems"]
    return [[tuple(int(v) for v in row) for row in sm[off[i]: off[i + 1]]]
            for i in range(len(off) - 1)]


def smem_tuples(lists):
    return [[(s.start, s.end, s.sa_lo, s.hitcount) for s in x] for x in lists]


def sorted_tuples(lists):
    return [sorted(x, key=lambda t: (t[0], t[1])) for x in lists]


def list_err(got, want) -> int:
    """The (read, slot) places where two reads' SMEM lists differ, a read's
    missing or extra SMEMs included."""
    check(len(got) == len(want), f"{len(got)} reads against {len(want)}")
    return sum(sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
               for g, w in zip(got, want))


def phase_fmi(dev, chain_us: float, main_fq: str):
    """The FM-index backend (--backend fmi) on the bench genome, whose
    FM-index files (index -a mem2's) were built by a process of their own:
    its kernels (fmi_kernels), then mem --backend fmi on the main run's
    reads and on the paired-end head's pairs under -I, whose SAM must be
    the default mem's."""
    from bwameme_tpu_torch import cli
    from bwameme_tpu_torch.bench_util import CACHE, get_index

    prefix, side = get_index(GENOME_MBP), get_index(SIDE_MBP)
    report = fmi_kernels(dev, chain_us, main_fq)
    work_dir = os.path.join(CACHE, "chip_smoke")
    sam = lambda name: os.path.join(work_dir, name)
    by_path = {}
    wall, by_path["fmi"], stages, gpu_ms = run_mem_timed(
        cli, prefix, main_fq, sam("short.fmi.gpu.sam"),
        ("--batch", str(BATCH), "--backend", "fmi"))
    run = dict(LAST_RUN)
    log_stages("mem --backend fmi", stages, gpu_ms)
    n_batches = -(-N_READS // BATCH)
    check(by_path["fmi"]["fmi_smem"] == n_batches, "fmi_smem: "
          f"{by_path['fmi']['fmi_smem']} launches for {n_batches} batches")
    report["fmi_smem"]["launches"] = by_path["fmi"]["fmi_smem"]
    same_sam("mem --backend fmi", sam("short.fmi.gpu.sam"),
             sam("short.gpu.sam"))
    fixed = ("-I", ",".join(map(str, INSERT)))
    _, by_path["fmi_pe_head"] = run_mem(
        cli, side, sam("pairs_head_p.fq"), sam("head.fmi.gpu.sam"), "cuda",
        ("-p", *fixed, "--backend", "fmi"))
    check(by_path["fmi_pe_head"]["fmi_smem"] > 0
          and by_path["fmi_pe_head"]["sw_full"] > 0,
          f"mem -p --backend fmi launched {by_path['fmi_pe_head']}")
    same_sam("mem -p --backend fmi", sam("head.fmi.gpu.sam"),
             sam("head.gpu.sam"))
    log(f"mem --backend fmi == default mem, SAM for SAM, on {N_READS} reads "
        f"at {GENOME_MBP:g} Mbp (fmi_load {run['fmi_load']:.2f} s, "
        f"index_upload {run['index_upload']:.2f} s, align "
        f"{run['align']:.2f} s, wall {wall:.2f} s, peak device memory "
        f"{run['peak_mib']:.1f} MiB) and on {N_CMP_PAIRS} pairs of the "
        f"{SIDE_MBP:g} Mbp genome under -p {' '.join(fixed)}")
    for path, counts in by_path.items():
        log(f"kernel launches, {path}: "
            f"{ {k: v for k, v in counts.items() if v} }")
    return report, by_path


def fmi_kernels(dev, chain_us: float, main_fq: str) -> dict:
    """The FM-index kernels on the bench genome: fmi_backward_ext on
    FMI_UNITS units and fmi_sa_lookup on FMI_RANKS ranks against their
    plain versions (and the ranks' positions against the index's sa);
    fmi_smem on one batch of the main reads, as mem --backend fmi
    launches it: against the plain wave engine, and on N_CMP of them
    against FmiHostEngine in emission order, timed there with its bound
    from the waves' work; and against FmiHostEngine on the side genome's
    FMI_SIDE_READS reads and on the stress reads (the oracle's process
    computed the scalar engine's); the main batch's warp steps by round
    (launched again with round 2, then rounds 2 and 3, off by their
    options). Returns the kernels' rows."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from bwameme_tpu_torch.bench_util import (CACHE, cuda_ms, get_index,
                                              queued_us)
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.index.fmindex import load_fm_index
    from bwameme_tpu_torch.ops import fmi_search, fmi_search_cuda
    from bwameme_tpu_torch.ops.launch import stats
    from bwameme_tpu_torch.seeding.fmi_engine import (FmiDeviceEngine,
                                                      FmiHostEngine, FmiWork)
    from bwameme_tpu_torch.utils.config import MemOptions

    prefix, side = get_index(GENOME_MBP), get_index(SIDE_MBP)
    opt = MemOptions()
    t0 = time.perf_counter()
    fm = load_fm_index(prefix)
    t_load = time.perf_counter() - t0
    idx = load_index(prefix)
    t0 = time.perf_counter()
    eng = FmiDeviceEngine(idx, opt, fm=fm, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    dfm = eng.dfm
    log(f"FM-index at {GENOME_MBP:g} Mbp: loaded in {t_load:.1f} s (its host "
        f"sa {fm.sa.nbytes / 2**20:.0f} MiB), {dfm.nbytes / 2**20:.1f} MiB "
        f"uploaded in {t_up:.2f} s")
    report = {}
    rng = np.random.default_rng(37)

    # backward_ext: random bi-intervals, any base
    n1 = fm.n + 1
    k = rng.integers(0, n1, FMI_UNITS)
    s = np.minimum(rng.integers(0, 64, FMI_UNITS), n1 - k)
    l = rng.integers(0, n1, FMI_UNITS)
    a = rng.integers(0, 4, FMI_UNITS)
    units = [torch.from_numpy(x.astype(np.int32)).to(dev)
             for x in (k, l, s, a)]
    stats.reset()
    got = fmi_search_cuda.backward_ext(dfm, *units)
    launches = stats.launches["fmi_backward_ext"]
    want = fmi_search.backward_ext_torch(dfm, *units)
    err = abs_err(got, want)
    check(err == 0, f"fmi_backward_ext differs from its plain version: {err}")
    host = FmiHostEngine(idx, opt, fm=fm)
    g = got[:, :256].cpu().numpy()
    check(all(tuple(int(v) for v in g[:, t]) == host.backward_ext(
        int(k[t]), int(l[t]), int(s[t]), int(a[t])) for t in range(256)),
        "fmi_backward_ext differs from FmiHostEngine.backward_ext")
    sectors = fmi_search.ext_sectors(dfm, units[0], units[2])
    kern = lambda: fmi_search_cuda.backward_ext(dfm, *units)
    report["fmi_backward_ext"] = dict(
        launches=launches, max_abs_err=err, ms=cuda_ms(kern, 10),
        device_ms=queued_us(kern, 100) / 1e3,
        plain_ms=cuda_ms(lambda: fmi_search.backward_ext_torch(dfm, *units),
                         3),
        library_ms=None, bound_by="bytes",
        bound_ms=(sectors * SECTOR + FMI_UNITS * (16 + 12)) / HBM_BPS * 1e3,
        answer_sectors=sectors, latency_steps=1,
        latency_bound_ms=chain_us / 1e3)

    # sa_lookup: random ranks, their positions == the index's sa
    ranks = rng.integers(0, n1, FMI_RANKS)
    rk = torch.from_numpy(ranks.astype(np.int32)).to(dev)
    stats.reset()
    got = fmi_search_cuda.sa_lookup(dfm, rk)
    launches = stats.launches["fmi_sa_lookup"]
    steps = torch.zeros(FMI_RANKS, dtype=torch.int64, device=dev)
    want = fmi_search.sa_lookup_torch(dfm, rk, steps)
    err = abs_err(got, want)
    check(err == 0, f"fmi_sa_lookup differs from its plain version: {err}")
    check(np.array_equal(got.cpu().numpy(), fm.sa[ranks]),
          "fmi_sa_lookup differs from the FM-index's sa")
    n_steps, most = int(steps.sum()), int(steps.max())
    kern = lambda: fmi_search_cuda.sa_lookup(dfm, rk)
    # an LF step reads one block (16 bytes of counts, 32 of bitmaps), the
    # end a stored entry; each rank read and each position written once
    report["fmi_sa_lookup"] = dict(
        launches=launches, max_abs_err=err, ms=cuda_ms(kern, 10),
        device_ms=queued_us(kern, 100) / 1e3,
        plain_ms=cuda_ms(lambda: fmi_search.sa_lookup_torch(dfm, rk), 3),
        library_ms=None, bound_by="bytes",
        bound_ms=(n_steps * 48 + FMI_RANKS * (4 + 4 + 4)) / HBM_BPS * 1e3,
        lf_steps=n_steps, latency_steps=most + 1,
        latency_bound_ms=(most + 1) * chain_us / 1e3)
    log(f"fmi_backward_ext == plain == FmiHostEngine on {FMI_UNITS} units "
        f"({sectors} distinct sectors of occ blocks); fmi_sa_lookup == plain "
        f"== sa on {FMI_RANKS} ranks ({n_steps} LF steps, {most} at most); "
        "ms alone / on the card: " + ", ".join(
            f"{n} {report[n]['ms']:.4f} / {report[n]['device_ms']:.4f}"
            for n in ("fmi_backward_ext", "fmi_sa_lookup")))

    # fmi_smem: one batch of the main reads, as mem --backend fmi launches
    # it, against the plain wave engine (SMEM sets; its work gives the
    # bound) and, on its first N_CMP reads, against FmiHostEngine in
    # emission order; the side genome's and the stress reads against the
    # oracle's FmiHostEngine lists (and the stress reads against the waves)
    def held(what, got, want, order=True):
        if not order:
            got, want = sorted_tuples(got), sorted_tuples(want)
        err = list_err(got, want)
        check(err == 0, f"fmi_smem differs from {what}: {err} SMEMs")
        return err

    batch = fastq_codes(main_fq)[:BATCH]
    got = smem_tuples(eng.collect_smems_batch(batch))
    want = [smem_tuples([host.collect_smems(np.asarray(c))])[0]
            for c in batch[:N_CMP]]
    err = held(f"FmiHostEngine on {N_CMP} main reads", got[:N_CMP], want)
    work = FmiWork(len(batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waves = smem_tuples(eng.collect_smems_waves(batch, work))
    plain_s = time.perf_counter() - t0
    err += held(f"the plain wave engine on {BATCH} main reads", got, waves,
                order=False)
    with np.load(os.path.join(CACHE, "chip_smoke", "fmi_oracle.npz")) as z:
        oracle = {n: oracle_lists(z, n) for n in ("side", "stress")}
    sidx = load_index(side)
    seng = FmiDeviceEngine(sidx, opt, fm=load_fm_index(side), device=dev)
    err += held(f"FmiHostEngine on {FMI_SIDE_READS} side reads", smem_tuples(
        seng.collect_smems_batch(fmi_side_reads(sidx))), oracle["side"])
    coarse, cfm, stress = fmi_stress()
    ceng = FmiDeviceEngine(coarse, opt, fm=cfm, device=dev)
    sgot = smem_tuples(ceng.collect_smems_batch(stress))
    err += held(f"FmiHostEngine on {N_STRESS} stress reads", sgot,
                oracle["stress"])
    err += held(f"the plain wave engine on {N_STRESS} stress reads", sgot,
                smem_tuples(ceng.collect_smems_waves(stress)), order=False)
    reruns = seng.reruns + ceng.reruns + eng.reruns
    # timed on the batch already on the card, as the other kernels are
    codes, lens = eng._upload(batch)
    kern = lambda: eng._smem(codes, lens, eng.max_smems)
    _, k_nsm, k_steps = eng._smem(codes, lens, eng.max_smems, steps=True)
    # the warp's dependent steps: forward extensions and backward chunks of
    # 32 entries; with the backward extensions, the waves' extensions
    fwd, bwd, bwd_ext = (x.cpu().numpy().astype(np.int64) for x in k_steps)
    chain = fwd + bwd
    slow = int(np.argmax(chain))
    if int(k_nsm.max()) <= eng.max_smems:
        check(int((fwd + bwd_ext).sum()) == work.extensions,
              f"fmi_smem ran {int((fwd + bwd_ext).sum())} extensions, the "
              f"waves {work.extensions}")

    def steps_without(**off):
        """(forward, backward chunks) of each read, rounds off"""
        e = copy.copy(eng)
        e.opt = dataclasses.replace(opt, **off)
        st = e._smem(codes, lens, eng.max_smems, steps=True)[2][:2]
        return st.cpu().numpy().astype(np.int64)

    # rounds 2 and 3 change neither round 1 nor each other's steps
    r13 = steps_without(split_width=-1)
    r1 = steps_without(split_width=-1, max_mem_intv=0)
    by_round = [r1, np.stack([fwd, bwd]) - r13, r13 - r1]
    slow_by_round = [[int(x[0, slow]), int(x[1, slow])] for x in by_round]
    chain_r2 = by_round[1].sum(0)
    n_sm = sum(map(len, got))
    # the occ blocks every extension stands on, the reads read and the
    # lengths, each SMEM (start, end, k, s) written once
    report["fmi_smem"] = dict(
        max_abs_err=err, ms=cuda_ms(kern, 10),
        device_ms=queued_us(kern, 50) / 1e3, plain_ms=plain_s * 1e3,
        library_ms=None, bound_by="bytes",
        bound_ms=(work.sectors() * SECTOR + codes.numel() + 4 * len(batch)
                  + 16 * n_sm) / HBM_BPS * 1e3,
        answer_sectors=work.sectors(), extensions=work.extensions,
        kernel_extensions=int((fwd + bwd_ext).sum()),
        latency_steps=int(work.waves.max()),
        latency_bound_ms=int(work.waves.max()) * chain_us / 1e3,
        kernel_steps_max=int(chain.max()),
        kernel_steps_slowest=[int(fwd[slow]), int(bwd[slow])],
        kernel_steps_total=[int(fwd.sum()), int(bwd.sum())],
        kernel_steps_slowest_by_round=slow_by_round,
        kernel_steps_max_round2=int(chain_r2.max()),
        kernel_steps_max_without_round2=int(r13.sum(0).max()),
        reruns=reruns)
    log(f"fmi_smem on {BATCH} main reads at {GENOME_MBP:g} Mbp ({n_sm} "
        f"SMEMs) == the plain wave engine, its first {N_CMP} == "
        f"FmiHostEngine in emission order; == FmiHostEngine on "
        f"{FMI_SIDE_READS} side reads and {N_STRESS} stress reads (most "
        f"SMEMs a read {max(map(len, sgot))} of {ceng.max_smems} slots; "
        f"{reruns} rerun launches), the stress reads == the waves; main "
        f"reads: {work.extensions} extensions in {int(work.waves.max())} "
        f"waves at most a read, {work.sectors()} distinct sectors of occ "
        f"blocks; the kernel's warps {int(chain.max())} steps at most "
        f"({int(fwd[slow])} forward, {int(bwd[slow])} backward chunks; "
        f"{int(fwd.sum())} and {int(bwd.sum())} in all; the slowest "
        f"read's (forward, backward) by round {slow_by_round}, round 2's "
        f"{int(chain_r2.max())} steps at most a read, rounds 1 and 3 "
        f"{int(r13.sum(0).max())}); kernel "
        f"{report['fmi_smem']['ms']:.4f} ms alone, "
        f"{report['fmi_smem']['device_ms']:.4f} ms on the card, waves "
        f"{plain_s * 1e3:.0f} ms")

    return report


def start_process(call: str) -> subprocess.Popen:
    """A Python statement run by a process of its own beside this one."""
    code = f"import sys; sys.path.insert(0, {ROOT!r}); {call}"
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def start_index_build(mbp: float) -> subprocess.Popen:
    """The bench genome's index (bench_util.get_index), built in a process
    of its own while the kernel phases run on the card: its build is a
    minute or more of host work that nothing before the search phase
    needs. A cached index returns at once."""
    return start_process("from bwameme_tpu_torch.bench_util import "
                         f"get_index; get_index({mbp!r})")


def start_host_work() -> dict:
    """Every process of host work that runs while the kernel phases do:
    the bench genome's learned index and FM-index (index -a mem2's files,
    bench_util.get_fm_index) and the scalar FmiHostEngine on the side and
    stress reads (fmi_oracle)."""
    return {"index build": start_index_build(GENOME_MBP),
            "FM-index build": start_process(
                "from bwameme_tpu_torch.bench_util import get_fm_index; "
                f"get_fm_index({GENOME_MBP!r})"),
            "FmiHostEngine": start_process(
                "import chip_smoke; chip_smoke.fmi_oracle()")}


def finish_index_build(proc: subprocess.Popen,
                       what: str = "index build") -> None:
    out, _ = proc.communicate()
    for line in out.splitlines():
        log(f"  {what}: {line}")
    check(proc.returncode == 0, f"the {what} exited {proc.returncode}")


def mangled(name: str) -> str:
    """The part of a seeding variant's mangled kernel name that ptxas
    reports it under: seed_round1[m1,kmer,wide] ->
    seed_round1_kernelILi1ExLb1EE."""
    base, _, tag = name.partition("[")
    tags = tag.rstrip("]").split(",") if tag else []
    mode = next((int(t[1:]) for t in tags if t.startswith("m")), 4)
    rank = "x" if "wide" in tags else "i"
    kmer = int("kmer" in tags or base == "kmer_window")
    if base in ("prmi_window", "kmer_window"):
        return f"window_kernelI{rank}Lb{kmer}EE"
    return f"{base}_kernelILi{mode}E{rank}Lb{kmer}EE"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "bwameme_tpu_torch")):
        print("chip_smoke: the bwameme_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bwameme_tpu_torch.ops.launch import SEEDING, variant, variants

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t, 1)
        torch.cuda.empty_cache()
        return out

    host_work = start_host_work()
    try:
        smi, build_log = timed("card", phase_card)
        report, time_banded = timed("banded_sw", phase_kernels, dev)
        sw, time_sw_full = timed("sw_full", phase_sw_full, dev, build_log)
        report.update(sw)
        # every timing from here on, those of phases 2 and 2b first, runs
        # with the host to itself
        timed("index_wait", lambda: [finish_index_build(p, what) for what, p
                                     in host_work.items()])
        timed("kernel_times", lambda: (time_banded(), time_sw_full()))
        gather, chain_us = timed("gather", phase_gather, dev)
        report.update(gather)
        main_fq = timed("main_reads", write_main_reads, GENOME_MBP, N_READS)
        search, by_path = timed("search", phase_search, dev, GENOME_MBP,
                                BATCH, N_CMP, N_KEYS, chain_us, main_fq)
        report.update(search)
        layouts, layout_paths = timed("layouts", phase_layouts, dev,
                                      chain_us)
        report.update(layouts)
        by_path.update(layout_paths)
        timed("jumbo", phase_jumbo, dev)
        by_path.update(timed("single_end", phase_end_to_end, GENOME_MBP,
                             N_READS, N_LONG, BATCH, N_CMP, main_fq))
        by_path.update(timed("paired_end", phase_pairs, GENOME_MBP, N_PAIRS,
                             BATCH, N_CMP_PAIRS))
        by_path.update(timed("ert", phase_ert, dev, main_fq))
        for k in (1, 2, 3):
            report[f"seed_round{k}[kmer]"]["launches"] = by_path["ert"][
                f"seed_round{k}[kmer]"]
        fmi, fmi_paths = timed("fmi", phase_fmi, dev, chain_us, main_fq)
        report.update(fmi)
        by_path.update(fmi_paths)
    finally:
        for proc in host_work.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # the default mem run's counts; the pair form runs on the long reads'
    # path; mode 1's rounds on mem --mode 1
    for name in ("banded_sw_coord", "seed_round1", "seed_round2",
                 "seed_round3"):
        report[name]["launches"] = by_path["device"][name]
    for k in (1, 2, 3):
        name = variant(f"seed_round{k}", 1, False)
        report[name]["launches"] = by_path["mode1"][name]
    report["banded_sw_pairs"]["launches"] = by_path["host_long"][
        "banded_sw_pairs"]
    report["sw_full"]["launches"] = by_path["pe"]["sw_full"]
    log(f"smoke passed in {time.perf_counter() - t0:.1f} s; phases (s): "
        f"{took}")
    kernels = []
    for name, (src, repl) in KERNELS.items():
        if name == "kmer_window":
            names = variants("prmi_window", "kmer")
        elif name == "prmi_window" or name not in SEEDING:
            names = variants(name) if name in SEEDING else [name]
        else:
            names = variants(name) + variants(name, "kmer")
        for v in names:
            entry = dict(name=v, route="cuda", source=CSRC + src,
                         replaces=repl, launch_path=launch_path(v),
                         **report[v])
            if name in SEEDING or name.startswith(("kmer_", "fmi_")):
                usage = ptxas_usage(build_log, f"{name}_kernel"
                                    if name.startswith("fmi_")
                                    else mangled(v))
                entry.update(registers=usage["registers"],
                             spill_stores=usage["spill_stores"])
            kernels.append(entry)
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched by no path")
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
