"""Device microseconds a unit of the seeding kernels (the port's
ops/launch.SEEDING and FMI) in the trace."""

from pbench import readers


def read(run):
    return readers.kernel_us(run, "pe", run.seeding_kernels)
