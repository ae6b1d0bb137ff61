#!/usr/bin/env python3
"""What the ``torch.library`` operators cost K1-K4 on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_op_dispatch.py [--reps 20] [--blocks 4] [--seed 0]

It builds the port's kernels from the checkout and records each kernel's
launch arguments as the main paths give them (``chip_smoke.py``'s shapes:
the kNN search at 4096 queries x 2^20 seeded clustered codes, d=256, k=16,
layout order, for K1 and K2; one board-sized chunk of 65,536 rows for K3;
gemma-2b's prefill attention, B=8 H=8 KV=1 S=2048 hd=256 bf16, for K4).
Then, on the same inputs, it times each kernel's operator
(``repro_torch::k1_hist``, ``k2_emit``, ``k3_hamming``,
``k4_flash_attention``) against the launch without it, in turns (direct,
operator, operator, direct, ``--blocks`` times), each call between two
CUDA events after a sync (so the host's time before the launch counts, as
in ``chip_smoke.py``'s kernel times), and the host's time to issue one
call. It prints one line per kernel and a JSON line: the medians, the
operator's cost, and the spread of the direct call's block medians.
Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from chip_smoke import carry, fa, tham, tsel, tuning

# (module, direct launch, operator) of each kernel
KERNELS = {"K1": (tsel, "_k1_cuda", "_k1_op"),
           "K2": (tsel, "_k2_cuda", "_k2_op"),
           "K3": (tham, "_k3_cuda", "_k3_op"),
           "K4": (fa, "_k4_cuda", "_k4_op")}


@contextlib.contextmanager
def recording(into: dict):
    """Record the last arguments each kernel's launch was given."""
    saved = []
    for name, (mod, direct, _) in KERNELS.items():
        real = getattr(mod, direct)

        def rec(*args, _real=real, _name=name):
            into[_name] = args
            return _real(*args)

        saved.append((mod, direct, real))
        setattr(mod, direct, rec)
    try:
        yield
    finally:
        for mod, direct, real in saved:
            setattr(mod, direct, real)


def host_us(fn, reps: int) -> float:
    """Median host time to issue ``fn()`` (the card idle before each)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return cs.fail("torch.cuda.is_available() is false: this check "
                       "needs a CUDA card")
    card = cs.nvidia_smi("name,power.limit")
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    cs._build.build([tsel._SOURCE, tham._SOURCE, fa._SOURCE])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(args.seed)
    W = cs.D_BITS // 32
    centers = rng.integers(0, 1 << 32, size=(cs.N_CLUSTERS, W),
                           dtype=np.uint32)
    codes_np = cs.clustered_codes(rng, cs.N_ROWS, centers)
    q = carry.codes(cs.clustered_codes(rng, cs.N_QUERIES, centers), cs.DEV)
    eng = carry.engine(codes_np, cs.D_BITS, device=cs.DEV).with_layout()
    x3 = eng.codes[:cs.K3_CHUNK]
    bq, bn = tuning.distance_blocks(q.shape[0], x3.shape[0], W,
                                    backend="gpu")
    g = torch.Generator(device=cs.DEV).manual_seed(7)
    B, S = cs.PREFILL_BATCH, cs.PREFILL_LEN
    qa = torch.randn((B, 8, S, 256), generator=g, device=cs.DEV).bfloat16()
    ka, va = (torch.randn((B, 1, S, 256), generator=g,
                          device=cs.DEV).bfloat16() for _ in range(2))
    launch_args = {}
    with recording(launch_args):
        eng.search(q, cs.K)
        tham.hamming_distance_kernel(q, x3, bq=bq, bn=bn)
        fa.flash_attention_kernel(qa, ka, va)
    torch.cuda.synchronize()
    # the operator takes bq / bk besides K4's three tensors
    launch_args["K4_op"] = (qa, ka, va, min(512, S), min(512, S))

    out = {}
    for name, (mod, direct, op) in KERNELS.items():
        a = launch_args[name]
        routes = {"direct": lambda: getattr(mod, direct)(*a),
                  "operator": lambda: getattr(mod, op)(
                      *launch_args.get(f"{name}_op", a))}
        ms = {"direct": [], "operator": []}
        for _ in range(args.blocks):
            for route in ("direct", "operator", "operator", "direct"):
                ms[route].append(cs.cuda_ms(routes[route], args.reps)[0])
        host = {r: host_us(fn, args.reps) for r, fn in routes.items()}
        med = {r: statistics.median(v) for r, v in ms.items()}
        rec = {"direct_ms": med["direct"], "operator_ms": med["operator"],
               "operator_cost_ms": med["operator"] - med["direct"],
               "direct_block_spread_ms": max(ms["direct"])
               - min(ms["direct"]),
               "direct_blocks_ms": ms["direct"],
               "operator_blocks_ms": ms["operator"],
               "direct_host_us": host["direct"],
               "operator_host_us": host["operator"]}
        out[name] = rec
        print(f"  {name}: direct {rec['direct_ms']:.4f} ms, operator "
              f"{rec['operator_ms']:.4f} ms (cost "
              f"{rec['operator_cost_ms'] * 1e3:+.1f} us; the direct "
              f"blocks' spread {rec['direct_block_spread_ms'] * 1e3:.1f} "
              f"us); host to issue: direct {rec['direct_host_us']:.1f} us, "
              f"operator {rec['operator_host_us']:.1f} us", flush=True)
    print("op_dispatch: " + json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
