"""Host microseconds a pair in the pairing layer's C++ call (TPROF
pair.native: dedup_patch_batch_c in pe.dedup; the rescue calls none)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", ("pair.native",))
