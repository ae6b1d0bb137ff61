#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the run of a
cell with its builder's ``control`` in place of the timed search, which has
to come out not correct.

The configurations state an exact search and no precision, so the control
breaks that guarantee in the way that would tempt a later change: for the
``hamming_prefix`` layout, the program's own ``select="approx"`` path at a
recall target below 1, through the same planner, executor and layout as
the timed path (``builders/hamming_prefix.py``). Everything else is the
run's: the store, the traffic, the window and the comparison.

On a card, at the cell's own size, one process per call:

    python3 knnbench/control.py --workload tagspace-10m.bulk4096 \\
        --seeds 11,12,13 --seconds 5

prints each seed's numbers compared, beside their limits, and a JSON line
per seed; it exits non-zero if any seed's control comes out correct.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

    import torch

    from knnbench import harness

    if not torch.cuda.is_available():
        print("knnbench control: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        result, lines = harness.run_cell(spec, args.workload, seed,
                                         args.seconds, False, control=True)
        print(json.dumps({"control": True,
                          "workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        print("\n".join(lines), flush=True)
        passed += result["correct"]
        torch.cuda.empty_cache()
    return 1 if passed else 0


if __name__ == "__main__":
    raise SystemExit(main())
