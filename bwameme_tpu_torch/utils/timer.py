"""Per-stage wall-clock profiling — the analog of the reference's rdtsc
counter matrix + display_stats (reference: src/profiling.cpp:54-160,
src/macro.h:72-178). Keeps a display_stats-style end-of-run breakdown."""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict


class StageTimer:
    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, out=sys.stderr, total: float | None = None,
               label: str = "stage breakdown") -> None:
        """Print the display_stats-style table. With `total` (e.g. the run's
        wall-clock), percentages are relative to it and stages may overlap
        (sub-stages nest); otherwise stages are assumed disjoint."""
        if not self.totals:
            return
        disjoint = total is None
        if disjoint:
            total = sum(self.totals.values())
        print(f"[stats] {label}:", file=out)
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print(f"[stats]   {name:<14} {t:8.2f}s  {100*t/max(total,1e-9):5.1f}%"
                  f"  ({self.counts[name]} calls)", file=out)
        if disjoint:
            print(f"[stats]   {'total':<14} {total:8.2f}s", file=out)
        from bwameme_tpu_torch.utils import fallbacks

        for site, n in sorted(fallbacks.summary().items()):
            print(f"[stats]   FALLBACK {site}: {n}x (fused/device path "
                  "demoted — investigate before trusting throughput)",
                  file=out)


# Global fine-grained stage accounting — the analog of the reference's
# global ``tprof[128][128]`` matrix (src/main.cpp:42) that every layer
# accumulates into inline and display_stats reports at the end
# (src/profiling.cpp:54-160, src/fastmap.cpp:1619-1620). The pipeline and
# seeding engine record sub-stages here (seed rounds, chain, extend,
# finalize, pairing); cli's mem command reports it after the run.
# Blocking device readbacks are timed inside their stage, so a stage's
# wall-clock includes the device time it waits on (JAX dispatch is async:
# device time surfaces at the first dependent readback).
TPROF = StageTimer()


def tstage(name: str):
    """Record a with-block into the global stage table."""
    return TPROF.stage(name)
