"""device_idle_share: the share of the traced window in which no operation
(kernel or copy) ran on the card, from the union of their intervals."""


def read(run):
    t = run.trace
    if not t or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
