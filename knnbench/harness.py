"""One run of one benchmark cell, found by name in ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``, read by ``gen.py``). The configuration names, each
by a file of its own: the maker of its store (``stores/<codes.kind>.py``:
``make(cfg, seed, device, n)``), the builder of its engine
(``builders/<layout>.py``: ``build``, the timed ``search`` and the
``control``) and its plain reference (``references/<reference>.py``). Each
metric the cell reports is read by ``metrics/<name>.py`` (``read(run)``: a
number, or None when it finds nothing to read). So a configuration, a
store, a layout, a mix or a metric is added by adding files and entries,
never by editing one that is there.

A run: set-up (the store made on the device from the seed, the engine and
its layout built, the query pool made, the warm-up searches), then a closed
loop of timed searches for ``seconds`` seconds, one batch in flight, each
timed until its answer is on the host, then the comparison of
``compare.py``. With ``trace`` the window runs under the
profiler and the cell's per-layer metrics are read; without, its
end-to-end metrics.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from knnbench import compare, devtrace, gen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARMUP_SEARCHES = 2
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec: dict, cell_name: str, root: Path = ROOT):
    """(cell, configuration, traffic) of ``cell_name``, each found by name."""
    cell = _by_name(spec["workloads"], cell_name, "workload")
    entry = _by_name(spec["configs"], cell["config"], "configuration")
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, cfg, traffic


def _part(folder: str, name: str):
    return _load_module(HERE / folder / f"{name}.py",
                        f"knnbench_{folder}_{name}".replace("-", "_"))


def reference_of(cfg: dict):
    return _part("references", cfg["reference"])


def store_of(cfg: dict):
    return _part("stores", cfg["codes"]["kind"])


def builder_of(cfg: dict):
    return _part("builders", cfg["layout"])


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or for a metric
    named ``<base>.<group>`` (one quantity split between groups of cells)
    the reader of ``<base>`` where the group has none of its own."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return _load_module(path, "knnbench_metric_" + metric.replace(".", "_"))


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics this cell reports in this kind of run: the end-to-end
    ones without trace, the per-layer ones with, each unless its
    ``workloads`` leave the cell out."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of ``names``) in FORBIDDEN,
    each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _window(search, batches, seconds: float, spans: bool):
    """The closed loop: one batch in flight, the next sent once the
    previous answer is on the host, until ``seconds`` have passed."""
    span = (torch.profiler.record_function if spans
            else lambda _name: contextlib.nullcontext())
    latencies, results = [], []
    i = 0
    with span(devtrace.WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            q = batches(i)
            ts = time.perf_counter()
            with span(devtrace.SEARCH):
                dd, ii = search(q)
            with span(devtrace.TO_HOST):
                dd, ii = dd.cpu(), ii.cpu()
            te = time.perf_counter()
            latencies.append(te - ts)
            results.append((i, dd, ii))
            i += 1
            if te >= deadline:
                break
    return latencies, results, te - t0


def _latency_ms(latencies) -> dict:
    """Median, 99th percentile, largest and mean of the window's searches."""
    ms = sorted(1e3 * t for t in latencies)
    if len(ms) < 2:
        return {"p50": ms[0], "p99": ms[0], "max": ms[0], "mean": ms[0]}
    cuts = statistics.quantiles(ms, n=100, method="inclusive")
    return {"p50": statistics.median(ms), "p99": cuts[98], "max": ms[-1],
            "mean": statistics.fmean(ms)}


class _Phases:
    """Seconds of each step of set-up, each ending in a synchronise."""

    def __init__(self, t_start: float, cuda: bool):
        self.t, self.cuda, self.seconds = t_start, cuda, {}

    def mark(self, name: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", t_start: float | None = None,
             phases_before: dict | None = None, sizes: dict | None = None,
             control: bool = False):
    """One run. Returns (result line as a dict, the check lines).

    ``t_start`` is when set-up began, and ``phases_before`` the seconds of
    its steps taken before this call; ``sizes`` overrides the store's
    ``n``, the traffic's ``batch`` and ``pool_queries`` (the CPU tests'
    small runs); ``control`` times the builder's control in place of its
    search."""
    t_start = time.perf_counter() if t_start is None else t_start
    sizes = sizes or {}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell, cfg, traffic = cell_parts(spec, cell_name)
    traffic = {**traffic, **{key: sizes[key] for key in
                             ("batch", "pool_queries") if key in sizes}}
    d, k, batch = cfg["d"], cfg["k"], traffic["batch"]
    reference, builder = reference_of(cfg), builder_of(cfg)
    phases = _Phases(t_start + sum((phases_before or {}).values()), cuda)
    phases.seconds.update(phases_before or {})
    phases.mark("harness")

    store = store_of(cfg).make(cfg, seed, device, sizes.get("n", cfg["n"]))
    n = store.codes.shape[0]
    phases.mark("store")
    eng = builder.build(store.codes, cfg)
    phases.mark("layout")
    batches = gen.Batches(gen.make_pool(traffic, store, seed), batch, seed)
    phases.mark("pool")
    search = (builder.control if control else builder.search)(eng, k)
    for i in range(WARMUP_SEARCHES):
        dd, ii = search(batches(i))
        dd.cpu(), ii.cpu()
        # the first search loads (on a checkout's first run, builds) the
        # kernels and registers the program's operators
        phases.mark("first_search" if i == 0 else "warmup")
    setup_s = time.perf_counter() - t_start
    setup_cpu_s = time.process_time()
    # what set-up left behind (torch's modules among it) is never garbage:
    # keep the collector's full passes in the window from walking it
    gc.collect()
    gc.freeze()
    gc.enable()

    def window():
        return _window(search, batches, seconds, trace)

    if trace:
        (latencies, results, window_s), events = devtrace.capture(window,
                                                                  cuda)
    else:
        (latencies, results, window_s), events = window(), None
    peak = torch.cuda.max_memory_allocated() if cuda else None
    after = _Phases(time.perf_counter(), False)
    summary = None
    if events is not None:
        summary = devtrace.summarize(events)
        del events
        after.mark("trace_reduce")

    gc.unfreeze()
    # the program's state goes before the reference runs
    del search, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    counts, failed, sampled = compare.check(results, batches, store.codes,
                                            reference, d, k, seed)
    after.mark("check")
    run = SimpleNamespace(
        latencies_s=latencies, searches=len(latencies),
        queries=batch * len(latencies), window_s=window_s,
        setup_s=setup_s, peak_bytes=peak, trace=summary, batch=batch, n=n,
        d=d, k=k)
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"] if cuda else 1,
           "memory_peak_bytes": peak if cuda else 0}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": compare.verdict(counts),
              "attempted": run.searches, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["sampled_rows"] = sampled
    result["latency_ms"] = _latency_ms(latencies)
    result["setup_phases_s"] = phases.seconds
    result["setup_cpu_s"] = setup_cpu_s
    result["after_window_s"] = after.seconds
    result["checks"] = compare.as_json(counts)
    return result, compare.lines(counts)
