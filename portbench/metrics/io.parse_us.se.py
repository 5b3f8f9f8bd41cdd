"""Host microseconds a read in the FASTQ parse (TPROF io.parse: read_chunks
from its resumption to its yield, the consumer's time left out)."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "se", ("io.parse",))
