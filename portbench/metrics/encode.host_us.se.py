"""Host microseconds a read in the reads' encoding (TPROF encode:
Aligner._encode over each batch or chunk)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "se", ("encode",))
