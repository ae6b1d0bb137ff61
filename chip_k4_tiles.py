#!/usr/bin/env python3
"""K4's bf16 tile on the card: the committed tile against two others.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k4_tiles.py [--reps 20]

It compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is
and with the tensor-core kernel's tile constants (BQ, BK, warps, CTAs per
SM) replaced, one nvcc per variant, all at once, into the kernels' build
directory; prints each variant's registers and spills; holds each against
K4's plain version within ``chip_smoke.py``'s bf16 gate (2 bf16 ulps +
1e-5) at the main shape (8 x 8 x 2048 x 256) and four small ragged and GQA
shapes; and times them at the main shape in turns (each variant three
times, median of ``--reps`` CUDA-event runs each), beside SDPA. Without a
CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# the committed constants of the tensor-core kernel, then each variant's
COMMITTED = ("constexpr int BQ = 64;", "constexpr int BK = 32;",
             "constexpr int MIN_CTAS = 2;")
VARIANTS = {
    "64x32, 4 warps, 2 CTAs/SM (committed)": COMMITTED,
    "128x64, 8 warps, 1 CTA/SM": ("constexpr int BQ = 128;",
                                  "constexpr int BK = 64;",
                                  "constexpr int MIN_CTAS = 1;"),
    "128x32, 8 warps, 1 CTA/SM": ("constexpr int BQ = 128;",
                                  "constexpr int BK = 32;",
                                  "constexpr int MIN_CTAS = 1;"),
}
MAIN = (8, 8, 1, 2048, 256)              # B, H, KV, S, hd: gemma-2b prefill
SMALL = [(2, 8, 1, 333, 256), (2, 4, 2, 300, 128), (2, 2, 1, 200, 32),
         (1, 4, 4, 192, 64)]
BF16_ULPS, ATOL = 2, 1e-5                # chip_smoke.py's K4 bf16 gate


def build(variants):
    """{name: loaded library}, each variant's source compiled by nvcc with
    the port's flags; prints ptxas's register and spill lines."""
    src = (_build.CSRC / fa._SOURCE).read_text()
    head, tail = src.split("namespace tc {", 1)
    _build.BUILD.mkdir(exist_ok=True)
    procs = {}
    for i, (name, consts) in enumerate(variants.items()):
        body = tail
        for old, new in zip(COMMITTED, consts):
            if old not in body:
                raise RuntimeError(f"{old!r} not in the tensor-core kernel")
            body = body.replace(old, new, 1)
        cu = _build.BUILD / f"k4_tile{i}.cu"
        cu.write_text(head + "namespace tc {" + body)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        tc = False                       # ptxas names a function, then
        for line in log.splitlines():    # its spills, then its registers
            if "Compiling entry function" in line:
                tc = "flash_fwd_tc" in line
                hd = line.split("ILi")[-1].split("E")[0] if tc else ""
            elif tc and ("registers" in line or "spill" in line):
                print(f"  {name}, HD={hd}: {line.split(':')[-1].strip()}",
                      flush=True)
        libs[name] = fa._bind(ctypes.CDLL(str(so)))
    return libs


def inputs(B, H, KV, S, hd, g):
    q = torch.randn((B, H, S, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, KV, S, hd), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    return q, k, v


def within_gate(out, ref) -> tuple[bool, float]:
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    e = torch.floor(torch.log2(torch.clamp(ref.abs(), min=1e-30)))
    return bool((diff <= BF16_ULPS * torch.exp2(e - 7) + ATOL).all()), \
        float(diff.max())


def median_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4_tiles: FAILED: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = inputs(*MAIN, g)
    ref = fa.flash_attention_plain(q, k, v)
    small = [(inputs(*s, g), s) for s in SMALL]
    small = [((a, b, c), fa.flash_attention_plain(a, b, c, 1, 1), s)
             for (a, b, c), s in small]
    ok_all = True
    for name, lib in libs.items():
        ok, err = within_gate(fa._launch(lib, q, k, v), ref)
        for (a, b, c), r, s in small:
            ok_s, err_s = within_gate(fa._launch(lib, a, b, c), r)
            ok, err = ok and ok_s, max(err, err_s)
        print(f"  {name}: max |err| {err:.3e}, within the gate: {ok}",
              flush=True)
        ok_all = ok_all and ok
    if not ok_all:
        print("chip_k4_tiles: FAILED: a variant disagrees with the plain "
              "version", file=sys.stderr)
        return 1
    names = list(libs)
    times = {n: [] for n in names}
    for n in names + names[::-1] + names:
        times[n].append(median_ms(lambda: fa._launch(libs[n], q, k, v),
                                  args.reps))
    B, H, KV, S, hd = MAIN
    flops = 2 * B * H * S * S * hd
    for n in names:
        print(f"  {n}: " + ", ".join(f"{t:.4f}" for t in times[n])
              + f" ms; {flops / min(times[n]) / 1e9:.1f} TFLOP/s at the best",
              flush=True)
    sdpa = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True, scale=hd ** -0.5),
        args.reps)
    print(f"  SDPA: {sdpa:.4f} ms; {flops / sdpa / 1e9:.1f} TFLOP/s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
