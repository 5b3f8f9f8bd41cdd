"""Host microseconds a read in the single-end finalize (TPROF finalize)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "se", ("finalize",))
