"""Device microseconds a pair of the mate-rescue kernel (sw_full_*) in the
trace."""

from pbench import readers


def read(run):
    return readers.kernel_us(run, "pe", ("sw_full",))
