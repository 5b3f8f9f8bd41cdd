"""Host microseconds a pair in the extension's C++ calls (TPROF
extend.native: extend_prepare_c in extend.submit, extend_finalize_c in
extend.finish)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", ("extend.native",))
