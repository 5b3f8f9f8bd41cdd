"""Host microseconds a read in the C++ finalize call and its retry (TPROF
finalize.native: finalize_se_c), no flattening or decoding."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "se", ("finalize.native",))
