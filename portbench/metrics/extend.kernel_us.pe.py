"""Device microseconds a unit of the banded extension kernels
(banded_sw_*) in the trace."""

from pbench import readers


def read(run):
    return readers.kernel_us(run, "pe", ("banded_sw",))
