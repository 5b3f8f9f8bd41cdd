"""Host microseconds a read of the CIGARs the single-end finalize leaves
to the host (TPROF finalize.cigar_host: gen_cigar for the jobs the kernel
flagged and for the band ladder's later rungs), nested in finalize.native.
None where the program names no such stage."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "se", ("finalize.cigar_host",))
