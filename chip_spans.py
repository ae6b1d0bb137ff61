#!/usr/bin/env python3
"""What the search path's spans cost, and where the card's idle time sits
among them, on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_spans.py [--cells CELL ...] [--seconds 5] [--seed 1] \\
        [--out build/spans]

* On-cost: the host nanoseconds of one search's worth of the program's
  spans and counters (``repro_torch.spans``: six nested spans, the tile
  count and the K2 counter), micro-timed with no profiler recording and
  under ``torch.profiler.profile`` (CPU and CUDA), the median of five
  blocks each.
* For each benchmark cell (``BENCHMARK.json``; default every cell), at its
  full size from ``--seed``: the store, engine and query pool made as
  ``knnbench/harness.py`` makes them, two warm-up searches, then the
  harness's closed-loop window of ``--seconds`` under the profiler, with
  its own spans. The trace is written to ``<out>/spans.<cell>.json.gz``;
  the card's idle gaps in the window are summed by the innermost program
  or harness span (``repro_torch.*``, ``knnbench.*``) open at each gap's
  midpoint, and within it by the innermost host event (``knnbench``'s
  breakdown names only the latter); and the recorder's totals per search.

It prints one line per finding and a JSON line last. Without a CUDA card it
exits non-zero at once.
"""
from __future__ import annotations

import argparse
import gc
import gzip
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from knnbench import devtrace, gen, harness, program_spans  # noqa: E402
from repro_torch import spans  # noqa: E402

PREFIXES = ("repro_torch.", "knnbench.")
READERS = ("engine_host_ms", "glue_host_ms", "layout_host_ms",
           "launch_host_ms", "k2_pruned_share")
TOP = 15
DEV = "cuda"


def profile():
    """The profiler of ``knnbench``'s traced run: CPU and CUDA."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEV == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def one_search_of_spans(dev) -> None:
    """The spans and counters one fused search takes, nested as there."""
    with spans.span(spans.SEARCH):
        with spans.span(spans.PLAN):
            pass
        with spans.span(spans.EXECUTE):
            with spans.span(spans.K1):
                pass
            with spans.span(spans.K2):
                spans.count(spans.K2_TILES, 1)
                spans.device_counter(dev)
            with spans.span(spans.ORIGINAL_IDS):
                pass


def span_cost_ns(reps: int, dev, blocks: int = 5) -> float:
    """Median over ``blocks`` of the host ns a search's spans take."""
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            one_search_of_spans(dev)
        times.append((time.perf_counter_ns() - t0) / reps)
    return statistics.median(times)


def on_cost() -> dict:
    dev = torch.device(DEV)
    off = span_cost_ns(20000, dev)
    with profile():
        on = span_cost_ns(2000, dev)
    spans.reset()
    print(f"on-cost: a search's spans and counters take {off:.0f} ns with "
          f"no profiler recording, {on:.0f} ns under the profiler",
          flush=True)
    return {"off_ns": off, "on_ns": on}


def gaps_by_span(events) -> dict:
    """{(program span, innermost host event): idle seconds} over the
    window's gaps, as ``devtrace.summarize`` finds them."""
    win = next(e for e in events if not e.device and e.name == devtrace.WINDOW)
    w0, w1 = win.start_ns, win.end_ns
    dev = [e for e in events if e.device and e.end_ns > w0 and e.start_ns < w1]
    busy = devtrace._union([(max(e.start_ns, w0), min(e.end_ns, w1))
                            for e in dev])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = sorted((e for e in events if not e.device and e.thread == win.thread
                   and e.end_ns > w0 and e.start_ns < w1),
                  key=lambda e: (e.start_ns, -e.end_ns))
    ours = [e for e in host if e.name.startswith(PREFIXES)]
    mids = [(s + e) // 2 for s, e in gaps]
    out: dict = {}
    for (s, e), span, op in zip(gaps, devtrace._innermost(ours, mids),
                                devtrace._innermost(host, mids)):
        key = (span, op)
        out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def traced_cell(spec, name: str, seed: int, seconds: float, out: Path):
    cell, cfg, traffic = harness.cell_parts(spec, name)
    store = harness.store_of(cfg).make(cfg, seed, DEV, cfg["n"])
    builder = harness.builder_of(cfg)
    eng = builder.build(store.codes, cfg)
    batches = gen.Batches(gen.make_pool(traffic, store, seed),
                          traffic["batch"], seed)
    search = builder.search(eng, cfg["k"])
    for i in range(harness.WARMUP_SEARCHES):
        dd, ii = search(batches(i))
        dd.cpu(), ii.cpu()
    spans.reset()
    with profile() as prof:
        latencies, _, window_s = harness._window(search, batches, seconds,
                                                 True)
    raw_path = out / f"spans.{name}.json"
    prof.export_chrome_trace(str(raw_path))
    with open(raw_path, "rb") as src, gzip.open(f"{raw_path}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    raw_path.unlink()
    cuda_t = torch.autograd.DeviceType.CUDA
    events = devtrace.classify(
        [(e.name(), e.device_type() == cuda_t, e.start_ns(), e.end_ns(),
          e.start_thread_id()) for e in prof.profiler.kineto_results.events()])
    summary = devtrace.summarize(events)
    gaps = sorted(gaps_by_span(events).items(), key=lambda kv: -kv[1])
    run = SimpleNamespace(trace=summary)
    per_search = {m: harness.reader(m).read(run) for m in READERS}
    rec = program_spans.Recorded(spans.snapshot())
    per_search["search_host_ms"] = rec.inclusive_ms(program_spans.SEARCH)
    print(f"{name}: {len(latencies)} searches in {window_s:.2f} s, recorder "
          f"{rec.searches}, trace {summary['searches']}; idle "
          f"{100 * (1 - summary['busy_s'] / summary['window_s']):.2f} %; "
          f"per search " + ", ".join(f"{k} {v:.4f}"
                                     for k, v in per_search.items()),
          flush=True)
    for (span, op), secs in gaps[:TOP]:
        print(f"  idle {secs:.4f} s in {span} / {op}", flush=True)
    del search, eng, store, batches, prof
    spans.reset()
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"searches": len(latencies), "recorded": rec.searches,
            "traced": summary["searches"], "window_s": window_s,
            "busy_s": summary["busy_s"], "per_search": per_search,
            "gaps": [[s, op, secs] for (s, op), secs in gaps[:TOP]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="build/spans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_spans: no CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    spec = harness.load_spec()
    cells = args.cells or [c["name"] for c in spec["workloads"]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    result = {"card": card, "on_cost": on_cost()}
    for name in cells:
        result[name] = traced_cell(spec, name, args.seed, args.seconds, out)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
