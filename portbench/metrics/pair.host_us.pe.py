"""Host microseconds a pair in dedup, insert-size statistics and mate
rescue (TPROF pe.dedup, pe.pestat, pe.rescue), the rescue's wait for the card
included."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", readers.PAIR_STAGES)
