"""Host microseconds a unit in the FASTQ parse (read_chunks) and the SAM
write, the benchmark's spans around them."""

from pbench import readers


def read(run):
    return readers.span_us(run, "se", "io")
