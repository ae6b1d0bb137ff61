#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 knnbench/run.py --workload tagspace-10m.bulk4096 --seed 7 \\
        --seconds 30 --trace 0

The cell, its configuration, traffic and metrics are found by name in
``BENCHMARK.json`` (``knnbench/harness.py``). The last line of standard
output is the result: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` and ``device`` (and, with ``--trace 1``,
``breakdown``), and last the numbers compared, each beside its limit, which
also end standard error. Without the program beside the benchmark, without
CUDA or with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it exits non-zero and prints no
result.
"""
import gc
import time

T_START = time.perf_counter()
# set-up makes few cycles and much that lives as long as the process: the
# collector's passes over torch's import are ~0.5 s of work that frees
# nothing; the harness freezes what set-up made and turns it back on for
# the window
gc.disable()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/knnbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/knnbench/triton"}
# compiled bytecode of every module the run imports, torch's too: where the
# installation ships none, each run would compile some thousand modules
# (~4 s) or write bytecode beside them, outside the checkout. A checkout's
# first run writes it here (44-64 MB, once), later runs only read it
PYCACHE = "build/knnbench/pycache"


def _fail(msg: str) -> int:
    print(f"knnbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"the program (src/repro_torch) is not in {ROOT}")
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    first_in_checkout = not (ROOT / PYCACHE).is_dir()
    sys.pycache_prefix = str(ROOT / PYCACHE)
    sys.dont_write_bytecode = False
    # the block shapes come from the program's static rule, not a file
    os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

    import torch

    from knnbench import harness
    t_torch = time.perf_counter()

    spec = harness.load_spec()
    cell, _, _ = harness.cell_parts(spec, args.workload)
    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{args.workload} needs {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} found")
    torch.set_num_threads(1)
    torch.cuda.init()
    torch.cuda.synchronize()
    before = {"import_torch": t_torch - T_START,
              "cuda_init": time.perf_counter() - t_torch}
    result, check_lines = harness.run_cell(
        spec, args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START, phases_before=before)
    # the numbers compared stay last
    result = {**{k: v for k, v in result.items() if k != "checks"},
              "setup_first_in_checkout": first_in_checkout,
              "checks": result["checks"]}
    loaded = harness.forbidden_modules()
    if loaded:
        return _fail(f"loaded in this process: {', '.join(loaded)}")
    print(json.dumps(result), flush=True)
    print("\n".join(check_lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
