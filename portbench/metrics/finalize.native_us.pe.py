"""Host microseconds a pair in the C++ finalize call and its retry (TPROF
finalize.native: finalize_pe_c), no flattening or decoding."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", ("finalize.native",))
