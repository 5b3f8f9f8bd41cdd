"""Reads aligned a second: every read whose SAM was written in the window,
over the window's whole length."""


def read(run):
    if run.kind != "se" or run.window_s <= 0:
        return None
    return run.units / run.window_s
