"""Device microseconds a read of the single-end finalize's CIGAR kernel
(sw_global_coord: the banded global alignment with traceback of every
region the SAM names) in the trace."""

from pbench import readers


def read(run):
    return readers.kernel_us(run, "se", ("sw_global",))
