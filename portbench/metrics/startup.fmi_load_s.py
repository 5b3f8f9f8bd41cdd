"""Seconds of the FM-index's load alone: the port's fmi_load stage (reading
``.fmi.npz`` and computing its occ ranks), timed by the benchmark. None
where the configuration's backend loads no FM-index."""


def read(run):
    return run.spans.get("fmi_load")
