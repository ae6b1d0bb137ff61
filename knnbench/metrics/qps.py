"""qps: queries whose answers reached the host in the window, over the
window's wall time (host clock)."""


def read(run):
    return run.queries / run.window_s
