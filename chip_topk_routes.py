#!/usr/bin/env python3
"""K1 and K2 on each of their d = 256, 128 and 64 routes, and at d = 1024,
on the card, and where their time goes.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_topk_routes.py [--reps 5] [--seed 0]

It builds ``src/repro_torch/kernels/csrc/topk_select.cu`` from the
checkout and prints ptxas's registers and spills for each of its kernels
by name (``hist_tc_kernel<MB, W>``: MB m16 fragments, W words a code).
Beside it, it builds variants of the same source, each a text
substitution: the CUDA-core kernels (the tensor-core dispatch taken out),
and the committed kernels with one part of the work taken out at a time
(ABLATIONS; their outputs are wrong by design and only timed). For the
committed kernels and the CUDA-core variant it runs ``chip_smoke.py``'s
K1/K2 cases and its full-shape check, both bit-for-bit against the plain
versions, at the main path's shape (4096 queries x 2^20 seeded clustered
codes, d=256, k=16, layout order), and stops at the first mismatch; then
it times the two in turns there, and each ablation beside the committed
build. Then the same two at kNN-SIFT's d=128, k=4 (4096 x 2^20, layout
order): each held to the plain versions, and timed in turns, twice, the
second time in the reverse order. Last, the same at kNN-WordEmbed's
d=64, k=2 (4096 x 2^20, layout order): the committed m16n8k128 tile and
the CUDA-core kernels (``W == 0``). At each width the launches' count of
the tiles that took the CUDA-core kernels must read 0 % for the
tensor-core route and 100 % for the CUDA-core one. Then 1024-bit codes at
k=40 (``chip_smoke.binembed_path``: 4096 x 2^20, layout order), which
only the CUDA-core kernels take: K1/K2 held to the plain versions and
timed, 100 % of tiles on the CUDA cores, and the main path's search held
to the on-card brute force and timed. Without a CUDA card it
exits non-zero at once. To try another design of a kernel, add its
substitution here.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from chip_smoke import tsel


# one part of the committed kernels' work taken out: (old text, new text)
# pairs of csrc/topk_select.cu, every occurrence replaced
ABLATIONS = {
    "K1 without its histogram adds": [
        ("atomicAdd(hrow[m][h] + v, 1);", "")],
    "one AND-popc product a tile instead of two": [
        ("        mma_b1(d[m], na[m], b0, b1);\n", "")],
    "K2 without ranking (phase B)": [
        ("if (qmin > r) continue;", "continue;")],
    "K1 without products (distances = the row's bytes)": [
        ("      tile.dist(cur, d);\n",
         "      for (int m = 0; m < MB; ++m)\n"
         "        for (int i = 0; i < 4; ++i) d[m][i] = (cur.x >> 8 * i) & 255;\n")],
    "every load from the tile's first 8 rows (L1 hits)": [
        ("xt + static_cast<size_t>(r) * 8 + 2 * (lane & 3)",
         "xt + static_cast<size_t>(r & 7) * 8 + 2 * (lane & 3)")],
}


# the share of K1's and K2's tiles each route's launches count as taking
# the CUDA-core kernels, at d = 256, 128 and 64
SHARE = {cs.W8_ROUTE: 0.0, cs.POPC_ROUTE: 100.0}


def kernel_name(mangled: str) -> str:
    """hist_tc_kernel<2, 8> for its mangled name; others as they are."""
    m = re.search(r"((?:hist|emit)(?:_tc)?_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(2))
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_lines(log: str):
    """(kernel, registers/spills line) pairs from nvcc -Xptxas -v."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            yield name, line.split(":", 1)[-1].strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=cs.N_TIMED)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return cs.fail("torch.cuda.is_available() is false: this check "
                       "needs a CUDA card")
    print(f"card: {cs.nvidia_smi('name,power.limit')}", flush=True)
    t0 = time.perf_counter()
    # the source itself is built once more as a variant with nothing
    # replaced, for ptxas's report even where its library is built already
    started = cs.start_variants(tsel._SOURCE, {
        "as committed": [], cs.POPC_ROUTE: cs.POPC_VARIANT, **ABLATIONS})
    try:
        cs._build.build([tsel._SOURCE])
    finally:
        variants = cs.finish_variants(started)
    print(f"build: {tsel._SOURCE} and {len(variants)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, line in ptxas_lines(variants["as committed"].nvcc_log):
        print(f"  ptxas: {name}: {line}", flush=True)

    q, x = cs.clustered_store(np.random.default_rng(args.seed), cs.D_BITS,
                              cs.N_ROWS, cs.N_QUERIES)
    sq, sx = cs.clustered_store(np.random.default_rng(args.seed + 1),
                                cs.SIFT_BITS, cs.N_ROWS, cs.N_QUERIES)
    wq, wx = cs.clustered_store(np.random.default_rng(args.seed + 2),
                                cs.WORDEMBED_BITS, cs.N_ROWS, cs.N_QUERIES)

    routes = {cs.W8_ROUTE: tsel._lib(),
              cs.POPC_ROUTE: variants[cs.POPC_ROUTE]}
    for name, lib in routes.items():
        print(f"route {name}:", flush=True)
        with cs.topk_library(lib):
            k1, k2 = cs.run_cases(q, x, sq, sx, wq, wx)
            kt = cs.kernel_timings(q, x, "main shape")
        if k1 or k2 or kt["k1_err"] or kt["k2_err"]:
            return cs.fail(f"route {name}: kernel != plain (cases K1 {k1} "
                           f"K2 {k2}; main shape K1 {kt['k1_err']} K2 "
                           f"{kt['k2_err']})")
        if kt["cudacore_share"] != SHARE[name]:
            return cs.fail(f"route {name}: {kt['cudacore_share']} % of "
                           f"tiles counted on the CUDA cores")
    cs.route_comparison(q, x, routes, reps=args.reps)

    print(f"where the time goes ({cs.W8_ROUTE}, main shape):", flush=True)
    committed = tsel._lib()
    order = [("committed", committed),
             *((name, variants[name]) for name in ABLATIONS),
             ("committed again", committed)]
    for name, lib in order:
        t = cs.route_comparison(q, x, {name: lib}, reps=args.reps,
                                check=lib is committed, quiet=True)[name]
        print(f"  ablation {name}: K1 {t['k1_ms']:.3f} ms, K2 "
              f"{t['k2_ms']:.3f} ms", flush=True)

    # kNN-SIFT's and kNN-WordEmbed's widths: the committed tensor-core
    # kernels and the CUDA-core ones (W == 0), each held to the plain
    # versions, then timed in turns, twice, the second time reversed
    for d, k, qs, xs in ((cs.SIFT_BITS, cs.SIFT_K, sq, sx),
                         (cs.WORDEMBED_BITS, cs.WORDEMBED_K, wq, wx)):
        for name, lib in routes.items():
            with cs.topk_library(lib):
                kt = cs.kernel_timings(qs, xs, f"d={d} k={k} {name}", d=d,
                                       k=k)
            if kt["k1_err"] or kt["k2_err"]:
                return cs.fail(f"d={d} route {name}: kernel != plain (K1 "
                               f"{kt['k1_err']} K2 {kt['k2_err']})")
            if kt["cudacore_share"] != SHARE[name]:
                return cs.fail(f"d={d} route {name}: "
                               f"{kt['cudacore_share']} % of tiles counted "
                               f"on the CUDA cores")
        cs.route_comparison(qs, xs, routes, reps=args.reps, d=d, k=k)
        cs.route_comparison(qs, xs, dict(reversed(routes.items())),
                            reps=args.reps, d=d, k=k)

    # 1024-bit codes, k = 40: no tensor-core tile, so the committed build
    # runs the CUDA-core kernels at W = 32 in 16-row query blocks
    bt = cs.binembed_path(args.seed + 3)
    if bt["k1_err"] or bt["k2_err"] or bt["cudacore_share"] != 100.0:
        return cs.fail(f"d={cs.BINEMBED_BITS}: kernel != plain (K1 "
                       f"{bt['k1_err']} K2 {bt['k2_err']}) or "
                       f"{bt['cudacore_share']} % of tiles counted on the "
                       f"CUDA cores, expected 100")
    print(f"chip_topk_routes: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
