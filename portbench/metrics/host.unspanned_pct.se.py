"""The share of the window that no span covers: neither a TPROF stage
(``spanned``, the FASTQ parse among them) nor the benchmark's ``io`` span
beyond the parse it holds (the SAM write, the reader's wrapper)."""


def read(run):
    if (run.kind != "se" or not run.window_s
            or not {"spanned", "io.parse"} <= set(run.tprof)
            or "io" not in run.spans):
        return None
    io_rest = max(0.0, run.spans["io"] - run.tprof["io.parse"])
    return 100.0 * (run.window_s - run.tprof["spanned"] - io_rest) / (
        run.window_s)
