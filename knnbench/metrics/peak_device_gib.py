"""peak_device_gib: ``torch.cuda.max_memory_allocated()`` over set-up and
window (reset at process start), read once the window has closed, before
the reference runs."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
