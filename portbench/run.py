"""One run of one cell of the port's benchmark (see README.md).

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's configuration, traffic mix, limits
and metrics are found by name (BENCHMARK.json, configs/, traffic/, limits/,
metrics/). The run builds or finds the configuration's index under
portbench/.cache/, sets up the port as its ``mem`` command does, makes the
reads from the seed, warms up, aligns for ``--seconds``, checks a sample of
what the window wrote against the plain reference (reference/), and prints
one JSON line last on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import genome as genome_mod  # noqa: E402
from pbench import names, wgsim  # noqa: E402
from pbench.trace import WINDOW_RANGE, Trace  # noqa: E402


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _load_json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def _reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """A workload resolved by name: its configuration, traffic mix and
    limits, the chips it asks for and the metrics it reports with the
    trace off (end to end) and on (per layer): [(name, unit)]."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    cache: str = CACHE


def resolve(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` of BENCHMARK.json, its files found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    shown = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in shown)]
    return Cell(workload, config, _load_json("traffic", w["traffic"]),
                limits, w["chips"], [(m["name"], m["unit"]) for m in e2e],
                [(m["name"], m["unit"]) for m in per])


# ------------------------------------------------------------ the index


def genome_dir(cell: Cell) -> str:
    """The directory of the configuration's genome and index."""
    return os.path.join(cell.cache, genome_mod.key(cell.config["genome"]))


def index_prefix(cell: Cell, genome) -> tuple[str, float]:
    """The prefix of the configuration's index under the cache, built by the
    port's own offline step (as its ``index`` command, ``-a mem2`` for the
    FM-index) when it is not there; returns it and the seconds a build
    took. A build is written into a directory of its own and renamed into
    place, so a killed build leaves no index."""
    d = genome_dir(cell)
    prefix = os.path.join(d, "genome")
    need_fmi = cell.config["backend"] == "fmi"
    have = os.path.isdir(prefix + ".meme") and (
        not need_fmi or os.path.exists(prefix + ".fmi.npz"))
    if have:
        return prefix, 0.0
    t0 = time.perf_counter()
    from bwameme_tpu_torch.index import bntseq
    from bwameme_tpu_torch.index.build import build_index, save_index

    code = genome.code
    os.makedirs(d, exist_ok=True)
    if not os.path.isdir(prefix + ".meme"):
        bns = bntseq.BntSeq(
            l_pac=len(code), contigs=[
                bntseq.Contig(nm, "", int(o), int(ln), 0) for nm, o, ln in
                zip(genome.names, genome.offsets, genome.lengths)],
            ambs=[], code=code)
        idx = build_index(bns)
        tmp = tempfile.mkdtemp(prefix=".building.", dir=cell.cache)
        try:
            save_index(idx, os.path.join(tmp, "genome"))
            del idx
            for f in sorted(os.listdir(tmp), key=lambda f: f.endswith(
                    ".meme")):
                os.replace(os.path.join(tmp, f), os.path.join(d, f))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"index: built {len(code)} bp in "
            f"{time.perf_counter() - t0:.1f} s")
    if need_fmi and not os.path.exists(prefix + ".fmi.npz"):
        from bwameme_tpu_torch.index.fmi_store import save_fm_index
        from bwameme_tpu_torch.index.fmindex import build_fm_index

        t1 = time.perf_counter()
        fm = build_fm_index(code)
        save_fm_index(prefix, fm)
        log(f"FM-index: built in {time.perf_counter() - t1:.1f} s")
    return prefix, time.perf_counter() - t0


# ------------------------------------------------------------ the window


class Spans:
    """The benchmark's own spans around the calls into the port; with
    ``ranges``, each is also a profiler range, ``portbench.<name>``."""

    def __init__(self, ranges: bool = False):
        self.totals: dict = {}
        self.ranges = ranges

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            if self.ranges:
                import torch

                with torch.profiler.record_function("portbench." + name):
                    yield
            else:
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0)


@dataclasses.dataclass
class Window:
    units: int = 0          # reads (single-end) or pairs completed
    seconds: float = 0.0
    passes: int = 0
    # (names, quals, SAM blocks) of each batch or chunk: strings in lists,
    # so that what the window keeps adds little for the collector to scan
    kept: list = dataclasses.field(default_factory=list)
    marks: list = dataclasses.field(default_factory=list)   # (t, units)


def _chunks(fastq, text: str, chunk_bp: int, paired: bool):
    """The port's FASTQ reader over ``text`` given as its standard input
    (``mem ... -``, as a pipeline feeds it)."""
    stdin, sys.stdin = sys.stdin, io.StringIO(text)
    try:
        yield from fastq.read_chunks("-", None, chunk_bp, keep_pairs=paired)
    finally:
        sys.stdin = stdin


def _keep(win: Window, reads: list, blocks: list, keep: bool) -> None:
    if keep:
        win.kept.append(([r.name for r in reads], [r.qual for r in reads],
                         blocks))


def missing(win: Window) -> int:
    """Reads of the window with no SAM block, or whose block is another
    read's."""
    n = 0
    for names_, _, blocks in win.kept:
        n += abs(len(names_) - len(blocks))
        n += sum(not b.startswith(name + "\t")
                 for name, b in zip(names_, blocks))
    return n


def drive(aligner, fastq, text: str, sink, spans: Spans, paired: bool,
          batch: int, chunk_bp: int, seconds: float | None,
          keep: bool = True) -> Window:
    """Align ``text`` as the port's ``mem`` does, chunk by chunk (single-end
    in batches through ``align_stream``, paired-end a chunk through
    ``align_pairs``), writing each SAM block. With ``seconds`` the window
    ends at the first batch (single-end) or chunk (paired-end) that
    finishes after it, going round the text again if it runs out; without,
    it aligns the text once."""
    win = Window()
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    done = False
    while not done:
        win.passes += 1
        chunks = _chunks(fastq, text, chunk_bp, paired)
        while True:
            with spans.span("io"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            if paired:
                blocks = aligner.align_pairs(chunk)
                with spans.span("io"):
                    sink.writelines(blocks)
                _keep(win, chunk, blocks, keep)
                win.units += len(chunk) // 2
                win.marks.append((time.perf_counter() - t0, win.units))
                done = deadline is not None and (
                    time.perf_counter() >= deadline)
            else:
                parts = [chunk[i: i + batch]
                         for i in range(0, len(chunk), batch)]
                stream = aligner.align_stream(iter(parts))
                for part, blocks in zip(parts, stream):
                    with spans.span("io"):
                        sink.writelines(blocks)
                    _keep(win, part, blocks, keep)
                    win.units += len(part)
                    if deadline is not None and (
                            time.perf_counter() >= deadline):
                        done = True
                        break
                stream.close()
                win.marks.append((time.perf_counter() - t0, win.units))
            if done:
                break
        if deadline is None:
            break
    win.seconds = time.perf_counter() - t0
    return win


# ------------------------------------------------------------ the check


def check(cell: Cell, win: Window, pool, genome, seed: int) -> dict:
    """The numbers compared: every read of the window has its SAM block
    (``missing``), and a sample of the units drawn from the seed judged by
    the plain reference."""
    import numpy as np

    from reference import bwa_sam

    t = cell.traffic
    paired = t["paired"]
    mates = 2 if paired else 1
    sites = []
    for names_, quals, blocks in win.kept:
        for k in range(0, len(names_), mates):
            sites.append((names_, quals, blocks, k))
    rng = np.random.default_rng([seed, 99])
    n = min(t["sample_units"], len(sites))
    pick = np.sort(rng.choice(len(sites), n, replace=False)) if n else []
    units = []
    for s in pick:
        names_, quals, blocks, k = sites[s]
        name = names_[k]
        u = int(name)
        got = blocks[k: k + mates]
        units.append((
            name, got + [""] * (mates - len(got)),
            [pool.seq[m][u] for m in range(mates)],
            quals[k: k + mates],
            [(int(pool.lo[m][u]), int(pool.hi[m][u]), bool(pool.rev[m][u]))
             for m in range(mates)]))
    sc = bwa_sam.Scoring(**cell.config["scoring"])
    j = bwa_sam.judge(units, genome, sc, paired)
    out = {"missing": missing(win), "field_faults": j["faults"],
           "finalize_faults": j["finalize"],
           "score_gap_pct": 100.0 * j["score_gap"] / max(j["reads"], 1)}
    if paired:
        out["improper_pct"] = 100.0 * j["improper"] / max(
            j["pairs_at_source"], 1)
    for text in j["fault_texts"]:
        log(f"fault: {text}")
    log(f"check: {n} sampled {'pairs' if paired else 'reads'} of "
        f"{len(sites)}, {j['score_gap']} of {j['reads']} reads below the "
        f"best score at their source; MAPQ held exactly on "
        f"{j['exact_mapq']} reads, {j['twins']} reads with a twin")
    return out


# ------------------------------------------------------------ the run


@dataclasses.dataclass
class RunView:
    """What a metric reader reads (metrics/<name>.py: read(run))."""

    kind: str               # "se" or "pe"
    units: int              # reads (se) or pairs (pe) in the window
    window_s: float
    setup_s: float
    peak_bytes: int
    spans: dict             # the benchmark's: index_load, index_upload,
    #                         fmi_load, io (seconds)
    tprof: dict             # the port's TPROF totals over the window
    launches: dict          # the port's launch counts over the window
    trace: object = None    # pbench.trace.Trace of the window, or None
    seeding_kernels: tuple = ()


def _card(need: int, want_card: bool):
    """(platform, kind) of the device the run measures, or None when the
    cell's cards are not there."""
    import torch

    if not want_card:
        return "cpu", "cpu"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < need:
        log(f"{need} CUDA device(s) needed, {n} found")
        return None
    return "gpu", torch.cuda.get_device_name(0)


def make_reads(cell: Cell, genome, seed: int, seconds: float):
    """The window's pool and the warm-up's reads from the seed, with their
    FASTQ text: the pool holds what ``pool_per_s`` reads or pairs a second
    need for ``seconds``, and one chunk more."""
    t = cell.traffic
    if t["generator"] != "wgsim":
        raise ValueError(f"unknown read generator {t['generator']!r}")
    haps = wgsim.haplotypes(genome.code, t, seed)
    mates = 2 if t["paired"] else 1
    chunk_units = -(-int(cell.config["chunk_bp"]) // sum(
        t["read_len"][:mates]))
    n_pool = math.ceil(t["pool_per_s"] * seconds) + chunk_units
    pool = wgsim.generate(haps, t, seed, 2, n_pool, genome.offsets)
    warm = wgsim.generate(haps, t, seed, 1, t["warmup_units"],
                          genome.offsets)
    return (pool, wgsim.fastq_text(pool, 0, t["error_rate"]),
            wgsim.fastq_text(warm, 0, t["error_rate"]))


class Port:
    """The port set up as its ``mem`` command sets it up (cli.cmd_mem):
    the configuration's flags (and ``extra``), load_index, the seeding
    engine of its backend, the Aligner, and a SAM sink with the header."""

    def __init__(self, cell: Cell, prefix: str, on_card: bool, extra=()):
        from bwameme_tpu_torch import __version__, cli
        from bwameme_tpu_torch.index.build import load_index
        from bwameme_tpu_torch.io import fastq, sam
        from bwameme_tpu_torch.pipeline import Aligner
        from bwameme_tpu_torch.utils import timer

        cfg = cell.config
        self.paired = cell.traffic["paired"]
        self.chunk_bp = int(cfg["chunk_bp"])
        self.fastq = fastq
        args = cli.build_parser().parse_args(
            ["mem", *cfg["mem_args"], *extra,
             *(["-p"] if self.paired else []), prefix, "-"])
        self.batch = args.batch
        opt = cli.mem_options(args)
        device = cli.select_device()
        if device is None or (on_card and device.type != "cuda"):
            raise RuntimeError("the port found no CUDA device")
        self.stages = stages = timer.StageTimer()
        with stages.stage("index_load"):
            self.idx = idx = load_index(prefix)
        if cfg["backend"] == "fmi":
            args.backend = "fmi"
            engine = cli.fmi_engine(args, idx, opt, device, stages)
            with stages.stage("index_upload"):
                self.aligner = Aligner(idx, opt, seeding_engine=engine,
                                       device=device)
        else:
            from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine

            with stages.stage("index_upload"):
                engine = DeviceSeedingEngine(idx, opt, lanes=args.batch,
                                             device=device, mode=args.mode)
                self.aligner = Aligner(idx, opt, seeding_engine=engine,
                                       device=device)
        self.sink = open(os.devnull, "w")
        self.sink.write(sam.sam_header(idx.bns, pg_line=sam.make_pg_line(
            __version__, "portbench " + cell.name)))

    def align(self, text: str, seconds, spans: Spans | None = None,
              keep: bool = True) -> Window:
        return drive(self.aligner, self.fastq, text, self.sink,
                     spans or Spans(), self.paired, self.batch, self.chunk_bp,
                     seconds, keep)

    def close(self) -> None:
        self.sink.close()
        del self.aligner, self.idx


def _sync(on_card: bool) -> None:
    if on_card:
        import torch

        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        want_card: bool = True) -> int:
    """One run of the cell; prints its result line and returns 0, or
    returns another code and prints none. ``want_card`` False runs the
    port's plain versions on the CPU (the tests)."""
    # any kernel cache of torch's own stays in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    import torch

    found = _card(cell.chips, want_card)
    if found is None:
        return 1
    platform, kind = found
    on_card = platform == "gpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    paired = cell.traffic["paired"]

    # the benchmark's own data: the genome, its index, the reads
    t0 = time.perf_counter()
    genome = genome_mod.cached(cell.config["genome"], genome_dir(cell))
    prefix, build_s = index_prefix(cell, genome)
    t1 = time.perf_counter()
    pool, text, warm_text = make_reads(cell, genome, seed, seconds)
    own_s = time.perf_counter() - t0
    log(f"index {'built' if build_s else 'cached'} ({build_s:.1f} s); "
        f"{pool.n} {'pairs' if paired else 'reads'} made in "
        f"{time.perf_counter() - t1:.1f} s ({len(text) / 2**20:.0f} MiB "
        "of FASTQ)")

    from bwameme_tpu_torch.ops import launch
    from bwameme_tpu_torch.utils import timer

    try:
        port = Port(cell, prefix, on_card)
    except RuntimeError as e:
        log(str(e))
        return 1
    port.align(warm_text, None, keep=False)
    del warm_text
    _sync(on_card)

    timer.TPROF.totals.clear()
    timer.TPROF.counts.clear()
    launch.stats.reset()
    spans = Spans(ranges=trace)
    prof = trace_dir = None
    if trace:
        trace_dir = tempfile.mkdtemp(prefix="portbench-trace-")
        prof = timer.start_trace(trace_dir, cuda=on_card)
    t_win = time.perf_counter()
    cpu0 = os.times()
    setup_s = t_win - T_START - own_s
    with torch.profiler.record_function(WINDOW_RANGE) if trace else \
            contextlib.nullcontext():
        win = port.align(text, seconds, spans)
        _sync(on_card)
    cpu1 = os.times()
    if prof is not None:
        timer.stop_trace(prof)
    tprof = dict(timer.TPROF.totals)
    launches = {k: v for k, v in launch.stats.launches.items() if v}
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    log(f"window: {win.units} {'pairs' if paired else 'reads'} in "
        f"{win.seconds:.3f} s ({win.passes} pass(es) over the pool); "
        f"set-up {setup_s:.3f} s; the process's CPU "
        f"{cpu1.user - cpu0.user:.3f} s user, "
        f"{cpu1.system - cpu0.system:.3f} s system; launches {launches}")
    log("window: chunk ends (s, units): " + " ".join(
        f"{t:.2f},{u}" for t, u in win.marks))
    log("window: stages (s): " + " ".join(
        f"{k} {v:.3f}" for k, v in sorted(tprof.items())) +
        f" io {spans.totals.get('io', 0.0):.3f}")

    # the program's state is freed before the reference runs
    stages = dict(port.stages.totals)
    port.close()
    del port
    if on_card:
        torch.cuda.empty_cache()
    tr = None
    if trace:
        files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        log(f"trace: {os.path.getsize(files[0]) if files else 0} bytes")
        tr = Trace.load(files[0], set(launch.stats.launches)) if files \
            else None
        shutil.rmtree(trace_dir, ignore_errors=True)
    numbers = check(cell, win, pool, genome, seed)
    view = RunView(
        kind="pe" if paired else "se", units=win.units,
        window_s=win.seconds, setup_s=setup_s, peak_bytes=peak,
        spans={**stages, **spans.totals}, tprof=tprof,
        launches=launches, trace=tr,
        seeding_kernels=tuple(launch.SEEDING + launch.FMI))
    del win, pool
    return report(cell, view, numbers, trace, platform, kind)


def report(cell: Cell, view: RunView, numbers: dict, trace: bool,
           platform: str, kind: str) -> int:
    """Read the cell's metrics, hold each number compared against its
    limit, and print the result line; with a forbidden module loaded, print
    no result and fail."""
    metrics = {}
    for name, unit in (cell.per_layer if trace else cell.end_to_end):
        v = _reader(name)(view)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in numbers.items()}
    correct = bool(cell.limits) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    device = {"platform": platform, "kind": kind, "count": cell.chips,
              "memory_peak_bytes": view.peak_bytes}
    out = {"correct": correct, "attempted": view.units,
           "failed": int(numbers["missing"] + numbers["field_faults"]
                         + numbers["finalize_faults"]),
           "metrics": metrics, "device": device}
    tr = view.trace
    if trace and tr is not None:
        device.update(busy_s=tr.busy_us() / 1e6, window_s=tr.window_us / 1e6)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    bad = names.forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    out["checks"] = checks
    for k, c in checks.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = resolve(bench, a.workload)
    return run(cell, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
