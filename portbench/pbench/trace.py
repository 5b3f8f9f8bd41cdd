"""The arithmetic of a torch.profiler Chrome trace: device events by kernel
name, their busy intervals merged, and the idle gaps named by the host stage
around them. ``demangle``, ``kernel_of``, ``merged`` and ``covered`` are
copies of the port's smoke test's (chip_smoke.py), frozen here."""

from __future__ import annotations

import json
from collections import Counter

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "portbench.window"


def demangle(sym: str) -> str:
    """A C++ name as the C++ runtime's demangler gives it; the name itself
    when it is not a mangled one or no demangler is found."""
    import ctypes

    try:
        fn = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    except OSError:
        return sym
    fn.restype = ctypes.c_void_p
    fn.argtypes = (ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int))
    status = ctypes.c_int(0)
    p = fn(sym.encode(), None, None, ctypes.byref(status))
    if not p:
        return sym
    try:
        return ctypes.string_at(p).decode()
    finally:
        free = ctypes.CDLL(None).free
        free.argtypes = (ctypes.c_void_p,)
        free(p)


def kernel_of(event_name: str) -> str:
    """A device event's name, demangled, its return type, anonymous
    namespaces and parameters taken off."""
    n = demangle(event_name) if event_name.startswith("_Z") else event_name
    n = n.replace("(anonymous namespace)::", "")
    return n.removeprefix("void ").split("(")[0]


def merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(union, lo: float, hi: float) -> float:
    """How much of [lo, hi] the disjoint intervals ``union`` cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union)


class Trace:
    """One traced window: its device events, busy union and stage ranges.
    Times in microseconds, as the trace has them."""

    def __init__(self, events: list, launch_names=()):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW_RANGE
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW_RANGE} range")
        self.lo = win[0]["ts"]
        self.hi = win[0]["ts"] + win[0]["dur"]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]
        self.busy = merged((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        self.stages = [e for e in xs if e.get("cat") == "user_annotation"
                       and e["name"] not in launch_names
                       and e["name"] != WINDOW_RANGE]
        self._names: dict = {}

    @classmethod
    def load(cls, path: str, launch_names=()) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], launch_names)

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        return covered(self.busy, self.lo, self.hi)

    def name(self, e) -> str:
        n = e["name"]
        if e["cat"] != "kernel":
            return n
        if n not in self._names:
            self._names[n] = kernel_of(n)
        return self._names[n]

    def kernel_us(self, prefixes) -> float | None:
        """Device time inside the window of the kernels whose name starts
        with one of ``prefixes``; None when no such kernel ran."""
        t, hit = 0.0, False
        for e in self.device:
            if e["cat"] == "kernel" and self.name(e).startswith(
                    tuple(prefixes)):
                t += covered([(e["ts"], e["ts"] + e["dur"])], self.lo,
                             self.hi)
                hit = True
        return t if hit else None

    def device_ops(self, k: int = 10) -> list:
        """The k device ops with the most time: [name, seconds]."""
        per = Counter()
        for e in self.device:
            per[self.name(e)] += covered([(e["ts"], e["ts"] + e["dur"])],
                                         self.lo, self.hi)
        return [[n, t / 1e6] for n, t in per.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest idle gaps of the device inside the window, each
        named by the stages that enclose its middle, outermost first:
        [name, seconds]."""
        gaps = []
        t = self.lo
        for b0, b1 in self.busy:
            if b1 <= self.lo or b0 >= self.hi:
                continue
            if b0 > t:
                gaps.append((b0 - t, t, b0))
            t = max(t, b1)
        if self.hi > t:
            gaps.append((self.hi - t, t, self.hi))
        out = []
        for dur, g0, g1 in sorted(gaps, reverse=True)[:k]:
            mid = (g0 + g1) / 2
            around = sorted((r for r in self.stages
                             if r["ts"] <= mid <= r["ts"] + r["dur"]),
                            key=lambda r: r["ts"])
            name = " > ".join(r["name"] for r in around) or "(no stage)"
            out.append([name, dur / 1e6])
        return out
