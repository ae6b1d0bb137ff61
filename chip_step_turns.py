#!/usr/bin/env python3
"""One model's train step timed in the packages of several checkouts, in
turns, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_step_turns.py SRC [SRC ...] [--arch gemma-2b] [--steps 4]

Each SRC is a directory holding a ``repro_torch`` package (a checkout's
``src``; unpack another commit's with ``git archive COMMIT src``). Each
runs in a fresh process, one after another in the order given (list a
pair as A B B A to see drift): the arch at full width with random weights
from seed 0, ``chip_smoke.py``'s training shape (8 x 2048 tokens a step
in 4 microbatches, f32 AdamW), ``dist/steps.make_train_step``; step 0
warms up, steps 1..``--steps`` are timed on the host clock, each ending
in a sync. It prints each run's step times and median, then the card's
name and power limit. Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

STEP = r"""
import json, statistics, sys, time
import torch
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import pipeline
from repro_torch.dist import steps
from repro_torch.models import lm
from repro_torch.optim import optimizer

arch, n = sys.argv[1], int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config(arch)
tc = TrainConfig(microbatches=4)
model = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
opt = optimizer.init(dict(model.named_parameters()), tc)
dc = pipeline.data_config_for(cfg, 2048, 8, 0)
step = steps.make_train_step(cfg, tc, device="cuda")
times = []
for s in range(n + 1):
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in pipeline.make_batch(dc, s).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, _ = step(model, opt, batch, s)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"steps_ms": times[1:],
                  "median_ms": statistics.median(times[1:])}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_step_turns: FAILED: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    out = []
    for src in args.srcs:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        run = subprocess.run([sys.executable, "-c", STEP, args.arch,
                              str(args.steps)], env=env, check=True,
                             capture_output=True, text=True, timeout=900)
        rec = dict(json.loads(run.stdout.strip().splitlines()[-1]), src=src)
        out.append(rec)
        print(f"  {src}: {args.arch} train step median "
              f"{rec['median_ms']:.1f} ms, steps "
              f"{[round(t, 1) for t in rec['steps_ms']]}", flush=True)
    print("step_turns: " + json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
