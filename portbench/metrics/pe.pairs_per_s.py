"""Pairs aligned a second in a traced run: every pair whose SAM was written
in the window, over the window's whole length. Per layer, not end to end:
paired-end runs spread too widely from process to process for a bound."""


def read(run):
    if run.kind != "pe" or run.window_s <= 0:
        return None
    return run.units / run.window_s
