"""Seconds from the process's start to the first timed batch, less the
benchmark's own genome, index build and reads."""


def read(run):
    return run.setup_s
