"""Spans and counters of the search path, kept only while a torch profiler
records.

The search path marks its layers with ``span(name)``: the engine's call
(``SEARCH``), the planner (``PLAN``), the executor (``EXECUTE``), the K1 and
K2 wrappers (``K1``, ``K2``) and the layout's id map (``ORIGINAL_IDS``).
K2's wrapper counts the tiles of each pass (``count(K2_TILES, n)``) and
hands its kernel ``device_counter(device)``, to which the kernel adds the
tiles its block-min guard skipped (``K2_TILES_PRUNED``).

With no profiler recording (``recording()`` false), ``span`` returns one
shared null context, ``count`` adds nothing and ``device_counter`` is None:
the path builds no ``record_function``, writes no counter and launches
nothing more. While one records, each span enters
``torch.profiler.record_function(name, args)``, so it sits on the
profiler's clock beside the device's kernels (``args`` is the span's
number among the spans of its name since ``reset``: a search's number,
for ``SEARCH``), and is also timed on the host with
``time.perf_counter_ns``. For each name the recorder keeps the count, the
inclusive nanoseconds and the self nanoseconds (inclusive less what the
spans opened inside it cover, per thread). It keeps these aggregates only:
the timeline is the profiler's own trace.

``snapshot()`` returns the totals as a plain dict, reading the device
counters (a synchronisation: take it after the measured window);
``reset()`` clears them.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

SEARCH = "repro_torch.search"
PLAN = "repro_torch.plan"
EXECUTE = "repro_torch.execute"
K1 = "repro_torch.k1"
K2 = "repro_torch.k2"
ORIGINAL_IDS = "repro_torch.layout.original_ids"
K2_TILES = "k2.tiles"
K2_TILES_PRUNED = "k2.tiles_pruned"

# true while a torch profiler records (torch.profiler.profile and
# torch.autograd.profiler.profile both set it)
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    """One open span: its ``record_function`` and its host timer."""

    __slots__ = ("_rec", "_name", "_rf", "_t0", "_covered")

    def __init__(self, rec: "Recorder", name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        with rec._lock:
            totals = rec._spans.setdefault(self._name, [0, 0, 0])
            seq = totals[0]
            totals[0] += 1
        self._rf = torch.profiler.record_function(self._name, str(seq))
        self._rf.__enter__()
        rec._stack().append(self)
        self._covered = 0
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        inclusive = time.perf_counter_ns() - self._t0
        rec = self._rec
        stack = rec._stack()
        stack.pop()
        if stack:
            stack[-1]._covered += inclusive
        with rec._lock:
            totals = rec._spans[self._name]
            totals[1] += inclusive
            totals[2] += inclusive - self._covered
        self._rf.__exit__(*exc)
        return False


class Recorder:
    """Per-name span totals and counters, taken while a profiler records."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: dict = {}      # name -> [count, inclusive, self] ns
            self._counts: dict = {}
            self._pruned: dict = {}     # device -> int64 K2 counter

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        if not recording():
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int) -> None:
        if recording():
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + int(n)

    def device_counter(self, device) -> torch.Tensor | None:
        """The int64 scalar on ``device`` that K2 adds its pruned tiles to
        while a profiler records; None otherwise. Made the first time by a
        copy from the host that neither launches a kernel nor waits for the
        device (a pageable source is staged before the call returns), then
        kept."""
        if not recording():
            return None
        device = torch.device(device)
        with self._lock:
            counter = self._pruned.get(device)
            if counter is None:
                counter = self._pruned[device] = torch.zeros(
                    (), dtype=torch.int64).to(device, non_blocking=True)
        return counter

    def snapshot(self) -> dict:
        """{"spans": {name: {"count", "inclusive_ns", "self_ns"}},
        "counters": {name: int}}, the device counters read into
        ``K2_TILES_PRUNED``."""
        with self._lock:
            spans = {name: {"count": c, "inclusive_ns": incl, "self_ns": own}
                     for name, (c, incl, own) in self._spans.items()}
            counters = dict(self._counts)
            pruned = list(self._pruned.values())
        if pruned:
            counters[K2_TILES_PRUNED] = sum(int(c.item()) for c in pruned)
        return {"spans": spans, "counters": counters}


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
device_counter = RECORDER.device_counter
snapshot = RECORDER.snapshot
reset = RECORDER.reset
