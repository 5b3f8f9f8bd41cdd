"""Per-stage wall-clock profiling — the analog of the reference's rdtsc
counter matrix + display_stats (reference: src/profiling.cpp:54-160,
src/macro.h:72-178). Keeps a display_stats-style end-of-run breakdown.

``start_trace``/``stop_trace`` run a torch.profiler trace (``mem --profile
DIR``, the counterpart of the JAX CLI's jax.profiler trace). While one runs
(``RANGES``), every stage and every kernel launch (ops/launch.py) is a
``record_function`` range of its name: the port's kernels are launched
through ctypes, so no torch op names them in the trace; and the seconds of
each garbage collection go to the stage ``gc``. Without a trace nothing of
this runs."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from collections import defaultdict

import torch

# True while start_trace's trace runs
RANGES = False

# the totals' key of the time under at least one stage: each outermost stage
# adds its seconds, so a nested stage is not counted twice
SPANNED = "spanned"


class StageTimer:
    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.depth = 0          # stages open now
        self._gc_t0 = None      # when the running collection started

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        self.depth += 1
        try:
            if RANGES:
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            self.depth -= 1
            self.totals[name] += dt
            self.counts[name] += 1
            if not self.depth:
                self.totals[SPANNED] += dt

    def on_gc(self, phase: str, info: dict) -> None:
        """A ``gc.callbacks`` hook: each collection's seconds into ``gc``,
        one count a collection. A collection runs inside whatever code
        allocated, stage or not, so ``gc`` overlaps the stages and stays out
        of ``spanned``."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.totals["gc"] += time.perf_counter() - self._gc_t0
            self.counts["gc"] += 1
            self._gc_t0 = None

    def report(self, out=sys.stderr, total: float | None = None,
               label: str = "stage breakdown") -> None:
        """Print the display_stats-style table. With `total` (e.g. the run's
        wall-clock), percentages are relative to it and stages may overlap
        (sub-stages nest); otherwise stages are assumed disjoint. The time
        under any stage (``spanned``) gets a line of its own."""
        stages = {k: t for k, t in self.totals.items() if k != SPANNED}
        if not stages:
            return
        disjoint = total is None
        if disjoint:
            total = sum(stages.values())
        print(f"[stats] {label}:", file=out)
        for name, t in sorted(stages.items(), key=lambda kv: -kv[1]):
            print(f"[stats]   {name:<14} {t:8.2f}s  {100*t/max(total,1e-9):5.1f}%"
                  f"  ({self.counts[name]} calls)", file=out)
        if disjoint:
            print(f"[stats]   {'total':<14} {total:8.2f}s", file=out)
        if SPANNED in self.totals:
            t = self.totals[SPANNED]
            print(f"[stats]   {SPANNED:<14} {t:8.2f}s  "
                  f"{100*t/max(total,1e-9):5.1f}%  (under any stage)",
                  file=out)


# Global fine-grained stage accounting — the analog of the reference's
# global ``tprof[128][128]`` matrix (src/main.cpp:42) that every layer
# accumulates into inline and display_stats reports at the end
# (src/profiling.cpp:54-160, src/fastmap.cpp:1619-1620). The pipeline and
# seeding engine record sub-stages here (seed rounds, chain, extend,
# finalize, pairing); cli's mem command reports it after the run.
# Blocking device readbacks are timed inside their stage, so a stage's
# wall-clock includes the device time it waits on (JAX dispatch is async:
# device time surfaces at the first dependent readback). Inside the host
# stages, ``<layer>.native`` times a call into the C++ host library and
# ``<layer>.fetch`` a blocking device-to-host readback.
TPROF = StageTimer()


def tstage(name: str):
    """Record a with-block into the global stage table."""
    return TPROF.stage(name)


def start_trace(trace_dir: str, cuda: bool):
    """Start a torch.profiler trace of the CPU and, with ``cuda``, the CUDA
    device, written at stop_trace into ``trace_dir`` in TensorBoard's layout
    (``trace_dir/<worker>.<ts>.pt.trace.json``); stages and launches are
    named ranges, and collections are timed into TPROF's ``gc``, until
    then. Returns the profiler."""
    global RANGES
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CPU] + ([act.CUDA] if cuda else []),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))
    prof.start()
    RANGES = True
    TPROF.totals["gc"] += 0.0   # a trace without a collection reads 0
    gc.callbacks.append(TPROF.on_gc)
    return prof


def stop_trace(prof) -> None:
    """Stop start_trace's trace and write it."""
    global RANGES
    RANGES = False
    if TPROF.on_gc in gc.callbacks:
        gc.callbacks.remove(TPROF.on_gc)
    prof.stop()
