"""The ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA activities) over
the whole measured window, reduced to what the per-layer readers take.

The window is marked by a ``WINDOW`` span; the harness also marks each
``KNNEngine.search`` call (``SEARCH``) and each copy of an answer to the
host (``TO_HOST``). ``summarize`` takes the raw events as plain tuples, so
the reduction is tested without a card:

* ``busy_s``: the union of the device's operations (kernels, copies and
  memsets) inside the window; ``window_s``: the window's length on the
  trace's clock. The profiler also draws each host span as a range on the
  device's timeline, under the span's own name: device events named as a
  host event are those ranges and are left out.
* ``kernels``, ``kernel_s``: the kernels launched in the window (copies and
  memsets excluded) and the sum of their device times.
* ``device_ops``: device time by operation name, the ten largest.
* ``idle_gaps``: the window's time with no device operation, by the
  innermost host span or operator open at each gap's midpoint, the ten
  largest.
"""
from __future__ import annotations

from typing import NamedTuple

WINDOW = "knnbench.window"
SEARCH = "knnbench.search"
TO_HOST = "knnbench.to_host"
TOP = 10
NAME_CHARS = 100
KERNEL = "kernel"
COPY = "copy"
HOST = "host"
_COPIES = ("Memcpy", "Memset")


class Event(NamedTuple):
    name: str
    kind: str           # KERNEL or COPY on the card, or HOST
    start_ns: int
    end_ns: int
    thread: int

    @property
    def device(self) -> bool:
        return self.kind != HOST


def capture(fn, cuda: bool):
    """``fn()`` under the profiler -> (its result, [Event])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
    cuda_t = torch.autograd.DeviceType.CUDA
    raw = [(e.name(), e.device_type() == cuda_t, e.start_ns(), e.end_ns(),
             e.start_thread_id())
           for e in prof.profiler.kineto_results.events()]
    return out, classify(raw)


def classify(raw) -> list:
    """(name, on the card, start ns, end ns, thread) tuples -> [Event],
    without the device-side ranges of host spans."""
    host_names = {r[0] for r in raw if not r[1]}
    events = []
    for name, on_card, s, e, thread in raw:
        if not on_card:
            events.append(Event(name, HOST, s, e, thread))
        elif name not in host_names:
            kind = COPY if name.startswith(_COPIES) else KERNEL
            events.append(Event(name, kind, s, e, thread))
    return events


def _union(intervals):
    """Sorted, merged (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each point (ascending), the name of the innermost host event
    open at it: a sweep with a stack of open events (events of one thread
    nest)."""
    names = []
    stack = []
    j = 0
    for p in points:
        while j < len(host) and host[j].start_ns <= p:
            ev = host[j]
            while stack and stack[-1].end_ns < ev.start_ns:
                stack.pop()
            stack.append(ev)
            j += 1
        while stack and stack[-1].end_ns < p:
            stack.pop()
        names.append(stack[-1].name[:NAME_CHARS] if stack else "(no span)")
    return names


def _top(totals: dict):
    return [[name, secs] for name, secs in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(events) -> dict | None:
    """The window's reduction (module docstring); None without a window
    span."""
    marks = [e for e in events if not e.device and e.name == WINDOW]
    if not marks:
        return None
    win = marks[0]
    w0, w1 = win.start_ns, win.end_ns
    dev = [e for e in events if e.device and e.end_ns > w0 and e.start_ns < w1]
    kernels = [e for e in dev if e.kind == KERNEL]
    busy = _union([(max(e.start_ns, w0), min(e.end_ns, w1)) for e in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    for e in dev:
        key = e.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e9
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = sorted((e for e in events if not e.device and e.thread == win.thread
                   and e.end_ns > w0 and e.start_ns < w1),
                  key=lambda e: (e.start_ns, -e.end_ns))
    mids = [(s + e) // 2 for s, e in gaps]
    idle: dict = {}
    for (s, e), name in zip(gaps, _innermost(host, mids)):
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    searches = sum(1 for e in events if not e.device and e.name == SEARCH
                   and w0 <= e.start_ns < w1)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_events": len(dev), "kernels": len(kernels),
            "kernel_s": sum(e.end_ns - e.start_ns for e in kernels) / 1e9,
            "searches": searches, "device_ops": _top(by_name),
            "idle_gaps": _top(idle)}
