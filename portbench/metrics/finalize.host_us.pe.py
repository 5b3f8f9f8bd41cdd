"""Host microseconds a pair in the paired-end finalize (TPROF
pe.finalize)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", ("pe.finalize",))
