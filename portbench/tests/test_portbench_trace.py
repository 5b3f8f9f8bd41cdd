"""The trace arithmetic on a small synthetic Chrome trace."""

import pytest

from pbench.trace import WINDOW_RANGE, Trace, merged


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(WINDOW_RANGE, "user_annotation", 100, 1000),
    ev(WINDOW_RANGE, "gpu_user_annotation", 100, 1000),
    ev("align", "user_annotation", 100, 900),
    ev("extend.finish", "user_annotation", 500, 300),
    ev("banded_sw_coord", "user_annotation", 150, 5),
    ev("_Z18seed_round1_kernelILi4EiLb0EEvPKj", "kernel", 150, 50),
    ev("banded_sw_coord", "kernel", 180, 40),        # overlaps the seeding
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 300, 100),
    ev("sw_full_coord", "kernel", 1050, 100),        # half outside
    ev("before", "kernel", 0, 50),                   # wholly outside
    {"ph": "i", "name": "instant", "ts": 200},
]


def test_busy_idle_and_kernels():
    t = Trace(EVENTS, launch_names={"banded_sw_coord"})
    assert t.window_us == 1000
    assert t.busy_us() == pytest.approx(70 + 100 + 50)
    assert t.kernel_us(("seed_round", "sa_query")) == pytest.approx(50)
    assert t.kernel_us(("banded_sw",)) == pytest.approx(40)
    assert t.kernel_us(("sw_full",)) == pytest.approx(50)
    assert t.kernel_us(("fmi_smem",)) is None
    ops = dict(t.device_ops())
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(1e-4)
    gaps = t.idle_gaps(3)
    # the longest gap, 400-1050, has its middle inside extend.finish
    assert gaps[0] == ["align > extend.finish", pytest.approx(650e-6)]
    assert gaps[1][1] == pytest.approx(80e-6)      # 220-300
    assert gaps[2] == ["align", pytest.approx(50e-6)]   # 100-150


def test_no_window_range():
    with pytest.raises(ValueError):
        Trace([ev("align", "user_annotation", 0, 10)])


def test_merged():
    assert merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
