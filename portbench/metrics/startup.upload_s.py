"""Seconds of the engine's construction and upload to the card, and the
Aligner's (index_upload, timed by the benchmark)."""


def read(run):
    return run.spans.get("index_upload")
