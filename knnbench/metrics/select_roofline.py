"""select_roofline: the least time the searches of the traced window need
(``roofline.least_seconds``: the algorithm's work, whatever kernels do it)
over the summed device time of every kernel launched in the window."""
from knnbench import roofline


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["kernel_s"]:
        return None
    least = roofline.least_seconds(run.batch, run.n, run.d, run.k)
    return 100.0 * least * t["searches"] / t["kernel_s"]
