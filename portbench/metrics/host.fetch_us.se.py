"""Host microseconds a read blocked on the card's results: every TPROF
span ``<layer>.fetch``, a device-to-host readback and the wait for the
kernels before it."""

from pbench import readers


def read(run):
    return readers.tprof_us(
        run, "se", tuple(k for k in run.tprof if k.endswith(".fetch")))
