"""Host microseconds a unit in chaining (TPROF chain)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", ("chain",))
