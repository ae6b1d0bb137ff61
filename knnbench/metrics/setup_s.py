"""setup_s: process start to the first timed search: imports, the kernel
build or load, the store made on the device, the layout, the query pool and
the warm-up searches."""


def read(run):
    return run.setup_s
