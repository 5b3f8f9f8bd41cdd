"""Host microseconds a pair in Python's garbage collector (TPROF gc, timed
by a gc.callbacks hook while the trace runs); it overlaps the stages."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", ("gc",))
