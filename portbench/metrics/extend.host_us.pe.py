"""Host microseconds a unit in extension (TPROF extend.submit and
extend.finish, less the chain stage nested in extend.submit), the wait for
the card included."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", readers.EXTEND_STAGES, ("chain",))
