"""Seconds of the index load: load_index and, with the FM-index, its load
(the port's index_load and fmi_load stages, timed by the benchmark)."""


def read(run):
    keys = [k for k in ("index_load", "fmi_load") if k in run.spans]
    return sum(run.spans[k] for k in keys) if keys else None
