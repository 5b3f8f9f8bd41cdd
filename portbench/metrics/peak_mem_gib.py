"""The device memory the port allocated at its peak over set-up and the
window (torch.cuda.max_memory_allocated after a reset at the start), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
