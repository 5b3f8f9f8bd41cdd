#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (bwameme_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; imports no JAX. Phases, each of which ends the run with
a non-zero exit and no result line when it fails:

1. card: the card's name and power limit (nvidia-smi); the kernels built
   from csrc/ with nvcc, and the build's time.
2. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, on random jobs at the main path's shapes plus edge cases, all
   outputs exactly equal; 64 jobs against the scalar contract
   (align/sw_scalar.py); the median times of both versions.
3. end to end: ``bwameme_tpu_torch.cli mem --engine host`` on single-end
   151 bp reads against a synthetic genome (bench.py's generator, seed 2024,
   index cached under .bench_cache/) through the flat path, on 1 kbp reads
   through the dataclass path, and on reads with two deletions under -w 20
   through the band-retry ladder. Every kernel's launch count, reset just
   before, must have risen; at least 95% of the short reads map to their
   source; the SAM records of the first 256 short reads, of the long reads
   and of the deletion reads are byte-identical to a CPU run of the plain
   version.

Prints a JSON line of per-kernel numbers, then, last, {"ok": true, ...}.
Exits 2 with no result when no CUDA device is visible or the port is not
beside this file.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache")
KERNEL_SOURCE = "bwameme_tpu_torch/csrc/banded_sw.cu"
REPLACES = "bwameme_tpu/ops/banded_sw_pallas.py:199"
SW_KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
# phase 2 workloads: pair jobs (B, Q, T) and coordinate jobs (reads, alnregs)
PAIRS_SHAPE = (4096, 151, 512)
COORD_SHAPE = (1024, 4096)
# phase 3: genome size (the bench's; the smoke's time limit allows a cut to
# no less than 10 Mbp), 151 bp reads, 1 kbp reads
GENOME_MBP = 100
N_READS = 1024
N_LONG = 16


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1: card


def phase_card():
    from bwameme_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    res = build.build()
    log(f"kernel build: {res.seconds:.1f} s -> {os.path.relpath(res.path, ROOT)}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  nvcc: {line.strip()}")
    return smi


# ------------------------------------------------- phase 2: kernel vs plain


def random_pairs(rng, B: int, Q: int, T: int, w: int):
    """Extension pairs at the main path's shapes: queries up to Q, targets
    a noisy copy of the query plus the gap allowance (up to 2w), a quarter
    of them uniform up to T; h0 a seed score; band w or 2w."""
    import numpy as np

    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    q[rng.random((B, Q)) < 0.01] = 4
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    t[:, :Q] = np.where(rng.random((B, Q)) < 0.03,
                        rng.integers(0, 4, (B, Q)), q)
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 2 * w + 1, B), T).astype(np.int32)
    wide = rng.random(B) < 0.25
    tlen[wide] = rng.integers(0, T + 1, int(wide.sum()))
    h0 = rng.integers(19, 152, B).astype(np.int32)
    ws = rng.choice([w, 2 * w], B).astype(np.int32)
    return q, t, qlen, tlen, h0, ws


def edge_pairs(rng, Q: int, T: int):
    q, t, qlen, tlen, h0, ws = random_pairs(rng, 64, Q, T, 100)
    qlen[0:4] = 0
    tlen[4:8] = 0
    tlen[8:12] = 1
    ws[12:20] = 1
    q[20:24] = 4
    h0[24:28] = 0
    qlen[28:32] = 1
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


def max_err(a: dict, b: dict) -> int:
    return max(int((a[k].long() - b[k].long()).abs().max()) if a[k].numel()
               else 0 for k in a)


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


def coord_workload(opt, rng, n_reads: int, n_regs: int, read_len: int):
    """A 4 Mbp random text, reads copied from it with substitutions and N
    codes, and one left and one right job per alnreg, shaped as the flat
    path makes them (target window = query part + cal_max_gap)."""
    import numpy as np

    from bwameme_tpu.align.chain import cal_max_gap
    from bwameme_tpu.index.packing import pack_words

    n = 4_000_000
    text = rng.integers(0, 4, n).astype(np.uint8)
    text32 = np.concatenate([pack_words(text, pad_code=3),
                             np.full(12, 0xFFFFFFFF, np.uint32)])
    src = rng.integers(400, n - read_len - 400, n_reads)
    codes = text[src[:, None] + np.arange(read_len)]
    codes = np.where(rng.random(codes.shape) < 0.01,
                     rng.integers(0, 4, codes.shape), codes).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4
    row = rng.integers(0, n_reads, n_regs)
    qbeg = rng.integers(0, read_len - 19, n_regs)
    slen = np.minimum(rng.integers(19, read_len + 1, n_regs), read_len - qbeg)
    qe = qbeg + slen
    rbeg = src[row] + qbeg
    lgap = np.array([cal_max_gap(opt, int(x)) for x in qbeg])
    rgap = np.array([cal_max_gap(opt, int(read_len - x)) for x in qe])
    left = np.zeros((7, n_regs), np.int64)
    left[0] = np.arange(n_regs)
    left[1] = row
    left[3] = qbeg
    left[5] = qbeg + lgap
    left[4] = rbeg - left[5]
    left[6] = opt.w
    right = np.zeros((7, n_regs), np.int64)
    right[0] = np.arange(n_regs)
    right[1] = row
    right[2] = qe
    right[3] = read_len - qe
    right[4] = rbeg + slen
    right[5] = read_len - qe + rgap
    right[6] = opt.w
    h0 = (slen * opt.a).astype(np.int32)
    return (text32.view(np.int32), codes, left.astype(np.int32),
            right.astype(np.int32), h0)


def run_coord_round(fn, opt, text32, codes, left, right, h0, mat):
    """Left launch (writes its scores), then right launch reading them."""
    score_reg = h0.clone()
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    lres = fn(text32, codes, left, score_reg, mat, *gaps, opt.pen_clip5,
              opt.zdrop, True, True)
    rres = fn(text32, codes, right, score_reg, mat, *gaps, opt.pen_clip3,
              opt.zdrop, False, False)
    return lres, rres, score_reg


def phase_kernels(dev):
    import numpy as np
    import torch

    from bwameme_tpu.align.sw_scalar import sw_extend
    from bwameme_tpu.utils.config import MemOptions
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
    for zdrop in (0, opt.zdrop):
        g, w_, _ = compare_pairs(opt, edge_pairs(rng, Q, T), zdrop, dev)
        e = max_err(g, w_)
        check(e == 0, f"banded_sw_pairs edge cases (zdrop={zdrop}) differ: {e}")
        err = max(err, e)
    tie_opt = MemOptions(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1)
    g, w_, _ = compare_pairs(tie_opt, tie_pairs(rng, 4096), 5, dev)
    e = max_err(g, w_)
    check(e == 0, f"banded_sw_pairs tie cases differ: {e}")
    err = max(err, e)
    log(f"banded_sw_pairs == sw_core_torch on {B} + 2x64 edge + 4096 tie "
        f"jobs (max abs err {err})")
    q, t, qlen, tlen, h0, ws = arrays
    for b in range(64):
        r = sw_extend(q[b, : qlen[b]], t[b, : tlen[b]], opt.mat, opt.o_del,
                      opt.e_del, opt.o_ins, opt.e_ins, int(ws[b]),
                      opt.pen_clip5, opt.zdrop, int(h0[b]))
        check([getattr(r, k) for k in SW_KEYS]
              == [int(got[k][b]) for k in SW_KEYS],
              f"banded_sw_pairs job {b} differs from sw_scalar.sw_extend")
    log("banded_sw_pairs == sw_scalar.sw_extend on 64 jobs")
    ms = cuda_ms(lambda: banded_sw_cuda.banded_sw_pairs(*args), 10)
    plain_ms = cuda_ms(lambda: bsw.sw_core_torch(*args), 3)
    log(f"banded_sw_pairs: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"({B} jobs, Q={Q}, T={T}; median)")
    report["banded_sw_pairs"] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms)

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
    log(f"banded_sw_coord == decode_text + gather_query + sw_core_torch on "
        f"{n_regs} left + {n_regs} right jobs (max abs err {err})")
    # timed as the flat path launches them: jobs sorted by target length
    lj_s = lj[:, torch.argsort(lj[5], descending=True, stable=True)]
    rj_s = rj[:, torch.argsort(rj[5], descending=True, stable=True)]
    ms = cuda_ms(lambda: run_coord_round(banded_sw_cuda.banded_sw_coord, opt,
                                         t32, cd, lj_s, rj_s, h0t, mat), 10)
    plain_ms = cuda_ms(lambda: run_coord_round(bsw.extend_side_round_torch,
                                               opt, t32, cd, lj_s, rj_s, h0t,
                                               mat), 3)
    log(f"banded_sw_coord: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(one round: {n_regs} left + {n_regs} right jobs, 151 bp reads; "
        f"median)")
    report["banded_sw_coord"] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms)
    return report


# ---------------------------------------------------- phase 3: end to end


def get_index(mbp: float) -> str:
    """The bench genome (bench.py:get_index: seed 2024, 200 planted
    repeats), built once and cached under .bench_cache/."""
    import numpy as np

    from bwameme_tpu.index import bntseq
    from bwameme_tpu.index.build import build_index, save_index

    prefix = os.path.join(CACHE, f"bench_{int(mbp)}mbp")
    if os.path.isdir(prefix + ".meme"):
        log(f"index: cached {os.path.relpath(prefix, ROOT)}")
        return prefix
    os.makedirs(CACHE, exist_ok=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    n = int(mbp * 1e6)
    code = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(200):
        src = int(rng.integers(0, n - 5000))
        dst = int(rng.integers(0, n - 5000))
        ln = int(rng.integers(300, 3000))
        code[dst: dst + ln] = code[src: src + ln]
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("chrB", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns)
    save_index(idx, prefix)
    log(f"index: built {mbp:g} Mbp in {time.perf_counter() - t0:.1f} s "
        f"(n_sa={idx.n_sa}, rmi_bits={idx.rmi_bits})")
    return prefix


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
            flags=()) -> float:
    """cli.main mem on one device; returns its wall time."""
    old = os.environ.pop("BWAMEME_PLATFORM", None)
    if device == "cpu":
        os.environ["BWAMEME_PLATFORM"] = "cpu"
    try:
        t0 = time.perf_counter()
        rc = cli.main(["mem", *flags, prefix, reads, "--engine", "host",
                       "-o", out])
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("BWAMEME_PLATFORM", None)
        if old is not None:
            os.environ["BWAMEME_PLATFORM"] = old
    check(rc == 0, f"mem on {device} exited {rc}")
    return wall


def phase_end_to_end(mbp: float, n_reads: int, n_long: int):
    import numpy as np
    import torch

    from bwameme_tpu.index.build import load_index
    from bwameme_tpu.utils.timer import TPROF
    from bwameme_tpu_torch import cli
    from bwameme_tpu_torch.ops import banded_sw_cuda

    prefix = get_index(mbp)
    idx = load_index(prefix)
    work = os.path.join(CACHE, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(11)
    short_fq = os.path.join(work, "short.fq")
    write_reads(short_fq, idx.text, idx.l_pac, n_reads, 151, rng)
    long_fq = os.path.join(work, "long.fq")
    write_reads(long_fq, idx.text, idx.l_pac, n_long, 1000, rng)
    del_fq = os.path.join(work, "deletions.fq")
    write_deletion_reads(del_fq, idx.text, idx.l_pac, 64, rng)
    n_cmp = min(256, n_reads)
    head_fq = os.path.join(work, "short_head.fq")
    with open(short_fq) as f, open(head_fq, "w") as g:
        g.writelines(f.readlines()[: 4 * n_cmp])
    del idx

    stats = banded_sw_cuda.stats
    stats.reset()
    stats.events = []
    TPROF.totals.clear()
    TPROF.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    wall = run_mem(cli, prefix, short_fq, os.path.join(work, "short.gpu.sam"),
                   "cuda")
    gpu_ms = stats.device_ms()
    stages = dict(TPROF.totals)
    stats.events = None
    wall_long = run_mem(cli, prefix, long_fq,
                        os.path.join(work, "long.gpu.sam"), "cuda")
    before = stats.launches["banded_sw_coord"]
    run_mem(cli, prefix, del_fq, os.path.join(work, "deletions.gpu.sam"),
            "cuda", ("-w", "20"))
    retry = stats.launches["banded_sw_coord"] - before - 2
    check(retry > 0, "the band-retry ladder launched nothing on the card")
    launches = dict(stats.launches)
    log(f"kernel launches in the end-to-end run: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    recs = sam_records(os.path.join(work, "short.gpu.sam"))
    names = [ln.split("\t")[0] for ln in recs
             if not int(ln.split("\t")[1]) & 0x900]
    check(len(names) == n_reads and len(set(names)) == n_reads,
          f"{len(names)} primary records for {n_reads} reads")
    ok, n = mapped_to_source(recs)
    check(ok >= 0.95 * n, f"only {ok}/{n} reads mapped to their source")
    log(f"short reads: {n} primary records, {ok} ({100 * ok / n:.1f}%) at "
        f"their source")
    log(f"end to end ({mbp:g} Mbp, {n_reads} x 151 bp, host seeding): "
        f"{n_reads / wall:.1f} reads/s over {wall:.2f} s wall, kernel "
        f"device time {gpu_ms:.2f} ms = {100 * gpu_ms / (wall * 1e3):.3f}% "
        f"of the wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log("stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   sorted(stages.items(), key=lambda kv: -kv[1])))
    log(f"long reads: {n_long} x 1000 bp in {wall_long:.2f} s")

    cpu_head = os.path.join(work, "short_head.cpu.sam")
    run_mem(cli, prefix, head_fq, cpu_head, "cpu")
    gpu_head = [ln for ln in recs if int(ln.split("_")[0][1:]) < n_cmp]
    check(gpu_head == sam_records(cpu_head),
          f"GPU SAM differs from CPU SAM on the first {n_cmp} reads")
    cpu_long = os.path.join(work, "long.cpu.sam")
    run_mem(cli, prefix, long_fq, cpu_long, "cpu")
    check(sam_records(os.path.join(work, "long.gpu.sam"))
          == sam_records(cpu_long), "GPU SAM differs from CPU SAM on long reads")
    ok_l, n_l = mapped_to_source(sam_records(cpu_long))
    cpu_del = os.path.join(work, "deletions.cpu.sam")
    run_mem(cli, prefix, del_fq, cpu_del, "cpu", ("-w", "20"))
    check(sam_records(os.path.join(work, "deletions.gpu.sam"))
          == sam_records(cpu_del),
          "GPU SAM differs from CPU SAM on the band-retry reads")
    log(f"GPU SAM == CPU SAM (plain version) on the first {n_cmp} short "
        f"reads, all {n_long} long reads ({ok_l}/{n_l} long at source) and "
        f"64 two-deletion reads at -w 20 ({retry} band-retry launches)")
    return launches


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
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    phase_card()
    report = phase_kernels(dev)
    launches = phase_end_to_end(GENOME_MBP, N_READS, N_LONG)
    log(f"smoke passed in {time.perf_counter() - t0:.1f} s")
    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES, launches=launches[name], **report[name])
               for name in ("banded_sw_coord", "banded_sw_pairs")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
