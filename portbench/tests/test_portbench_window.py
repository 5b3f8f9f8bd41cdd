"""The window's arithmetic: whole batches (single-end) and chunks
(paired-end) over the window's whole length, on a clock that the fake
aligner advances."""

import pytest

import run as R
from bwameme_tpu_torch.io import fastq


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeAligner:
    """One SAM block a read; a batch or chunk advances the clock."""

    def __init__(self, clock, per_read: float, drop: bool = False):
        self.clock, self.per_read, self.drop = clock, per_read, drop

    def _blocks(self, reads):
        self.clock.t += self.per_read * len(reads)
        out = [f"{r.name}\t0\t*\n" for r in reads]
        return out[: len(out) // 2] if self.drop else out

    def align_stream(self, batches):
        for b in batches:
            yield self._blocks(b)

    def align_pairs(self, reads):
        return self._blocks(reads)


def text(n, mates):
    recs = []
    for i in range(n):
        for _ in range(mates):
            recs.append(f"@{i:010d}\n{'A' * 10}\n+\n{'2' * 10}\n")
    return "".join(recs)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(R.time, "perf_counter", c)
    return c


def test_single_end_whole_batches(clock):
    # chunks of 100 bases = 10 reads, batches of 4: 4 + 4 + 2 a chunk
    al = FakeAligner(clock, 0.01)
    win = R.drive(al, fastq, text(50, 1), open("/dev/null", "w"),
                  R.Spans(), False, 4, 100, 0.25)
    # 0.01 s a read: batches end at 0.04, 0.08, 0.10, 0.14, ..., 0.24,
    # 0.28; the window closes with the one that ends at 0.28 s
    assert win.units == 28 and win.seconds == pytest.approx(0.28)
    assert win.passes == 1 and R.missing(win) == 0
    assert [len(n) for n, _, _ in win.kept] == [4, 4, 2, 4, 4, 2, 4, 4]


def test_paired_end_whole_chunks_and_passes(clock):
    # chunks of 100 bases = 5 pairs; 40 ms a pair; a pool of 6 pairs is
    # gone after 2 chunks (5 + 1), then read again: chunks end at 0.20,
    # 0.24, 0.44, 0.48 and 0.68 s, the first at or after 0.5 s
    al = FakeAligner(clock, 0.02)
    win = R.drive(al, fastq, text(6, 2), open("/dev/null", "w"),
                  R.Spans(), True, 4, 100, 0.5)
    assert [len(n) // 2 for n, _, _ in win.kept] == [5, 1, 5, 1, 5]
    assert win.units == 17 and win.passes == 3
    assert win.seconds == pytest.approx(0.68)


def test_warm_up_aligns_once(clock):
    al = FakeAligner(clock, 0.01)
    win = R.drive(al, fastq, text(7, 1), open("/dev/null", "w"),
                  R.Spans(), False, 4, 30, None, keep=False)
    assert win.units == 7 and win.passes == 1 and not win.kept


def test_missing_blocks_counted(clock):
    al = FakeAligner(clock, 0.01, drop=True)
    win = R.drive(al, fastq, text(8, 1), open("/dev/null", "w"),
                  R.Spans(), False, 4, 1000, None)
    assert R.missing(win) == 4
