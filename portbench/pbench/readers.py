"""What the metric readers (metrics/<name>.py) share. A reader returns None
when the run has nothing for it to read: another kind of cell, no trace, no
such stage or kernel in the window."""

from __future__ import annotations


def per_unit_us(run, seconds: float):
    """Microseconds a read (single-end) or pair (paired-end)."""
    return 1e6 * seconds / run.units if run.units else None


def tprof_us(run, kind: str, add, sub=()):
    """The port's TPROF stages ``add`` less the stages ``sub`` nested in
    them, over the window, a unit."""
    if run.kind != kind or not any(k in run.tprof for k in add):
        return None
    s = sum(run.tprof.get(k, 0.0) for k in add)
    return per_unit_us(run, s - sum(run.tprof.get(k, 0.0) for k in sub))


def span_us(run, kind: str, name: str):
    """One of the benchmark's spans over the window, a unit."""
    if run.kind != kind or name not in run.spans:
        return None
    return per_unit_us(run, run.spans[name])


def kernel_us(run, kind: str, prefixes):
    """Device time of the kernels named by ``prefixes`` in the traced
    window, a unit."""
    if run.kind != kind or run.trace is None or not run.units:
        return None
    t = run.trace.kernel_us(prefixes)
    return None if t is None else t / run.units


def idle_pct(run, kind: str):
    """The share of the traced window in which the device ran nothing."""
    if run.kind != kind or run.trace is None:
        return None
    w = run.trace.window_us
    return 100.0 * (1.0 - run.trace.busy_us() / w) if w > 0 else None


SEED_STAGES = ("seed.submit", "seed.finish", "seed.collect")
EXTEND_STAGES = ("extend.submit", "extend.finish")
PAIR_STAGES = ("pe.dedup", "pe.pestat", "pe.rescue")
