"""The program's own spans and counters in the ``--trace 1`` run, for the
per-layer readers of host time and pruning.

``repro_torch.spans`` keeps, while a torch profiler records (in this
harness: the traced window alone), each span's count, inclusive and self
host nanoseconds and its counters; the readers take its snapshot in the
traced run's own process, after the window. Per search means over the
``SEARCH`` spans it recorded, one per ``KNNEngine.search`` call.
"""
from __future__ import annotations

SEARCH = "repro_torch.search"
PLAN = "repro_torch.plan"
EXECUTE = "repro_torch.execute"
K1 = "repro_torch.k1"
K2 = "repro_torch.k2"
ORIGINAL_IDS = "repro_torch.layout.original_ids"
K2_TILES = "k2.tiles"
K2_TILES_PRUNED = "k2.tiles_pruned"


class Recorded:
    """One snapshot of the program's recorder, read per search."""

    def __init__(self, snap: dict):
        self.spans, self.counters = snap["spans"], snap["counters"]
        self.searches = self.spans[SEARCH]["count"]

    def _ms(self, key: str, names) -> float:
        ns = sum(self.spans.get(n, {}).get(key, 0) for n in names)
        return ns / self.searches / 1e6

    def inclusive_ms(self, *names) -> float:
        return self._ms("inclusive_ns", names)

    def self_ms(self, *names) -> float:
        return self._ms("self_ns", names)


def recorded(run) -> Recorded | None:
    """The recorder's totals of the traced window; None without a trace,
    without device events (the rule of every per-layer reader), without the
    recorder (a program that has none) or with no search recorded."""
    t = run.trace
    if not t or not t["device_events"]:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    if not snap["spans"].get(SEARCH, {}).get("count"):
        return None
    return Recorded(snap)
