"""Host microseconds a unit in the seeding stages (TPROF seed.submit,
seed.finish), the wait for the card included."""

from pbench import readers


def read(run):
    return readers.tprof_us(run, "pe", readers.SEED_STAGES)
