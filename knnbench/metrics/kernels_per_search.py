"""kernels_per_search: CUDA kernels launched in the traced window over the
searches in it."""


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["searches"]:
        return None
    return t["kernels"] / t["searches"]
