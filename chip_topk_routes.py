#!/usr/bin/env python3
"""K1 and K2 on each of their d = 256, 128 and 64 routes, and at d = 1024,
on the card, and where their time goes.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_topk_routes.py [--reps 5] [--seed 0] [--baseline FILE]

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
tensor-core route and 100 % for the CUDA-core one. Then the same at
1024-bit codes, k=40 (``chip_smoke.binembed_path``: 4096 x 2^20, layout
order; the committed W = 32 tile, eight products a fragment, and the
CUDA-core kernels), with the main path's search held to the on-card brute
force and timed; then, at that shape, the other designs of the W = 32
tile (W32_DESIGNS, held to the committed kernels bit for bit) and the
ablations that reach it, timed beside the committed build. With
``--baseline FILE`` (another ``topk_select.cu``, such as the parent
commit's, under the gitignored ``build/``) it also builds FILE and prints,
for each kernel instance both builds have, whether ``cuobjdump -sass``
gives the same code. Without a CUDA card it exits non-zero at once. To try
another design of a kernel, add its substitution here.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
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
         "        for (int i = 0; i < 4; ++i)\n"
         "          d[m][i] = (reinterpret_cast<const int&>(cur) >> 8 * i)"
         " & 255;\n")],
    "every load from the tile's first 8 rows (L1 hits)": [
        ("xt + static_cast<size_t>(r) * 8 + 2 * (lane & 3)",
         "xt + static_cast<size_t>(r & 7) * 8 + 2 * (lane & 3)")],
    "W = 32: four AND-popc products a fragment instead of eight": [
        ("        mma_b1(d[m], na, x[2 * i], x[2 * i + 1]);\n", "")],
    "W = 32: every load from the tile's first 8 rows (L1 hits)": [
        ("load_row32(xt + static_cast<size_t>(r) * 32, lane)",
         "load_row32(xt + static_cast<size_t>(r & 7) * 32, lane)")],
}
# the ablations timed at d = 1024 (the others touch only W <= 8 code);
# those named "W = 32: ..." are timed there alone
D1024_ABLATIONS = ("K1 without its histogram adds",
                   "K2 without ranking (phase B)",
                   "K1 without products (distances = the row's bytes)",
                   "W = 32: four AND-popc products a fragment instead of "
                   "eight",
                   "W = 32: every load from the tile's first 8 rows (L1 "
                   "hits)")

# other designs of the W = 32 tile, whose outputs must equal the committed
# kernels': (old text, new text) pairs as in ABLATIONS
W32_DESIGNS = {
    "K2 at W = 32 in 256-row chunks (4 pieces in flight)": [
        ("  constexpr int CH = tc_ch(MB);",
         "  constexpr int CH = W == 32 ? 256 : tc_ch(MB);")],
}


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


def sass_by_kernel(so) -> dict:
    """{kernel name: its SASS, one line per instruction} of a built
    library, from ``cuobjdump -sass`` (``sass_kernels``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return sass_kernels(subprocess.run(
        [tool, "-sass", str(so)], capture_output=True, text=True,
        check=True).stdout)


def sass_kernels(text: str) -> dict:
    """{kernel name: its SASS lines} of ``cuobjdump -sass``'s output, each
    line's runs of blanks made one: the padding between an instruction and
    its encoding is as wide as the library's longest instruction, so a
    kernel added to the source widens it in every other kernel."""
    kernels = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        kernels[kernel_name(name.strip())] = [
            " ".join(line.split()) for line in body.splitlines()
            if line.strip() and not line.strip().startswith(".")]
    return kernels


def compare_sass(committed, baseline) -> None:
    """Print, for each kernel instance in both libraries, whether their
    SASS is the same, and the instances only one of them has."""
    new, old = sass_by_kernel(committed), sass_by_kernel(baseline)
    for name in sorted(new.keys() & old.keys()):
        diff = [(a, b) for a, b in zip(new[name], old[name]) if a != b]
        same = ("same" if new[name] == old[name] else
                f"differs, first at {diff[0]}" if diff else "differs")
        print(f"  SASS {name}: {same} ({len(new[name])} lines, baseline "
              f"{len(old[name])})", flush=True)
    for name in sorted(new.keys() ^ old.keys()):
        where = "committed" if name in new else "baseline"
        print(f"  SASS {name}: only in the {where} build", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=cs.N_TIMED)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="another topk_select.cu whose SASS to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return cs.fail("torch.cuda.is_available() is false: this check "
                       "needs a CUDA card")
    print(f"card: {cs.nvidia_smi('name,power.limit')}", flush=True)
    t0 = time.perf_counter()
    # the source itself is built once more as a variant with nothing
    # replaced, for ptxas's report even where its library is built already
    started = cs.start_variants(tsel._SOURCE, {
        "as committed": [], cs.POPC_ROUTE: cs.POPC_VARIANT, **ABLATIONS,
        **W32_DESIGNS})
    baseline = None
    if args.baseline:
        baseline = cs._build.BUILD / "baseline-topk_select.so"
        base_proc = subprocess.Popen(
            [cs._build._nvcc(), *cs._build.FLAGS, "-o", str(baseline),
             args.baseline], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    try:
        cs._build.build([tsel._SOURCE])
    finally:
        variants = cs.finish_variants(started)
    print(f"build: {tsel._SOURCE} and {len(variants)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, line in ptxas_lines(variants["as committed"].nvcc_log):
        print(f"  ptxas: {name}: {line}", flush=True)
    for design in W32_DESIGNS:
        for name, line in ptxas_lines(variants[design].nvcc_log):
            if name.endswith(", 32>"):
                print(f"  ptxas ({design}): {name}: {line}", flush=True)
    if baseline is not None:
        log, _ = base_proc.communicate()
        if base_proc.returncode:
            return cs.fail(f"nvcc failed for {args.baseline}:\n{log}")
        print(f"SASS of {tsel._SOURCE} against {args.baseline}:", flush=True)
        compare_sass(cs._build.library_path(tsel._SOURCE), baseline)

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
        if kt["cudacore_share"] != cs.ROUTE_SHARE[name]:
            return cs.fail(f"route {name}: {kt['cudacore_share']} % of "
                           f"tiles counted on the CUDA cores")
    cs.route_comparison(q, x, routes, reps=args.reps)

    print(f"where the time goes ({cs.W8_ROUTE}, main shape):", flush=True)
    committed = tsel._lib()
    order = [("committed", committed),
             *((name, variants[name]) for name in ABLATIONS
               if not name.startswith("W = 32:")),
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
            if kt["cudacore_share"] != cs.ROUTE_SHARE[name]:
                return cs.fail(f"d={d} route {name}: "
                               f"{kt['cudacore_share']} % of tiles counted "
                               f"on the CUDA cores")
        cs.route_comparison(qs, xs, routes, reps=args.reps, d=d, k=k)
        cs.route_comparison(qs, xs, dict(reversed(routes.items())),
                            reps=args.reps, d=d, k=k)

    # 1024-bit codes, k = 40, in 16-row query blocks: the W = 32 tile and
    # the CUDA-core kernels (binembed_path raises at a mismatch), then the
    # tile's other designs and the ablations that reach it
    bt = cs.binembed_path(args.seed + 3, routes)
    dk = dict(d=cs.BINEMBED_BITS, k=cs.BINEMBED_K)
    print(f"where the time goes ({cs.W8_ROUTE}, d={cs.BINEMBED_BITS}):",
          flush=True)
    order = [("committed", committed, True),
             *((name, variants[name], True) for name in W32_DESIGNS),
             *((name, variants[name], False) for name in D1024_ABLATIONS),
             *((f"{name} again", variants[name], True)
               for name in reversed(W32_DESIGNS)),
             ("committed again", committed, True)]
    for name, lib, check in order:
        t = cs.route_comparison(bt["q"], bt["codes"], {name: lib},
                                reps=args.reps, check=check, quiet=True,
                                **dk)[name]
        print(f"  {'design' if check else 'ablation'} {name}: K1 "
              f"{t['k1_ms']:.3f} ms, K2 {t['k2_ms']:.3f} ms", flush=True)
    print(f"chip_topk_routes: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
