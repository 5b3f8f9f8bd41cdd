"""The share of the traced window in which the card ran no kernel, copy
or set."""

from pbench import readers


def read(run):
    return readers.idle_pct(run, "se")
