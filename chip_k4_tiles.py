#!/usr/bin/env python3
"""K4's bf16 kernel on the card: the committed tile against others.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k4_tiles.py [--reps 20] [--baseline FILE] [--ablations]

It compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is
and with the wgmma kernel's tile constants (warpgroups, keys a tile, K/V
stages, panel width, CTAs an SM) replaced, one nvcc per variant, all at
once, into the kernels' build directory. ``--baseline FILE`` compiles
another ``flash_attention.cu`` (an earlier design, through the same C
entry point) as one more variant. For each variant and head dim it prints
ptxas's registers, spills and warnings for the bf16 kernel and the count
of ``HGMMA`` instructions in its SASS (``cuobjdump -sass``); holds each
variant against K4's plain version within ``chip_smoke.py``'s bf16 gate
(2 bf16 ulps + 1e-5) at gemma-2b's prefill shape and small ragged, GQA and
tile-edge shapes at every head dim; and times them in turns (each variant
three times, median of ``--reps`` CUDA-event runs each) at three prefill
shapes, gemma-2b (hd 256), zamba2-2.7b (hd 80) and internlm2-20b (hd 128),
beside SDPA. ``--ablations`` adds timing-only variants of the committed
kernel, each with one part of its work taken out (the exponentials, the lo
product, the Q K^T products, the copies, the barrier), to show where its
time goes. Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# lines of the committed wgmma kernel's tile, and each variant's
# replacements for some of them
WG = "constexpr int WG = 2;"
BK = "static constexpr int BK = 64;"
STAGES = "static constexpr int STAGES = 2;"
PW = ("static constexpr int PW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : "
      "16;")
MIN_CTAS = "static constexpr int MIN_CTAS = HD <= 128 ? 2 : 1;"
VARIANTS = {
    "committed": {},
    "32-byte swizzle (PW 16) at every hd": {
        PW: "static constexpr int PW = 16;"},
    "BK 80 at hd 256": {
        BK: "static constexpr int BK = HD > 128 ? 80 : 64;"},
    "3 K/V stages at hd <= 128": {
        STAGES: "static constexpr int STAGES = HD > 128 ? 2 : 3;"},
    "1 CTA/SM at hd 128": {
        MIN_CTAS: "static constexpr int MIN_CTAS = HD < 128 ? 2 : 1;"},
    "1 warpgroup (BQ 64), BK 32 at hd 256, 2 CTAs/SM": {
        WG: "constexpr int WG = 1;",
        BK: "static constexpr int BK = HD > 128 ? 32 : 64;",
        MIN_CTAS: "static constexpr int MIN_CTAS = 2;"},
}
# timing only (--ablations): the committed kernel with one part of its
# work taken out; their outputs are wrong and are not checked
ABLATIONS = {
    "no exp (p = s)": {
        "ex2((x - m[(i >> 1) & 1]) * LOG2E) : 0.f;": "x : 0.f;"},
    "no lo product": {
        "        Wgmma<HD>::rs(acc, lo, dv);\n": ""},
    "no Q K^T products": {
        "Wgmma<BK>::ss(s, desc": "if (false) Wgmma<BK>::ss(s, desc"},
    "no K/V copies in the loop": {"if (jn < nk) {": "if (false) {"},
    "no barrier": {
        "    __syncthreads();                 // for every thread": "//"},
}
# B, H, KV, S, hd: the prefills K4 is timed at
SHAPES = {"gemma-2b": (8, 8, 1, 2048, 256),
          "zamba2-2.7b": (8, 32, 32, 2048, 80),
          "internlm2-20b": (8, 48, 8, 2048, 128)}
SMALL = [(2, 8, 1, 333, 256), (2, 4, 2, 300, 128), (2, 2, 1, 200, 32),
         (1, 4, 4, 192, 64), (2, 4, 2, 300, 80), (2, 4, 2, 300, 112),
         (1, 4, 1, 129, 256), (1, 2, 2, 65, 80), (1, 4, 4, 63, 112),
         (2, 48, 8, 129, 128), (2, 4, 1, 1, 256)]
BF16_ULPS, ATOL = 2, 1e-5                # chip_smoke.py's K4 bf16 gate
BF16_FLOPS_PER_S = 989e12                # H100 SXM, dense bf16 tensor cores


def variant_source(subs: dict) -> str:
    """The committed source with ``subs`` applied inside namespace tc."""
    src = (_build.CSRC / fa._SOURCE).read_text()
    head, tail = src.split("namespace tc {", 1)
    for old, new in subs.items():
        if old not in tail:
            raise RuntimeError(f"{old!r} not in the wgmma kernel")
        tail = tail.replace(old, new, 1)
    return head + "namespace tc {" + tail


def hgmma_counts(so: Path) -> dict:
    """{hd: HGMMA instructions in flash_fwd_tc_kernel<hd>'s SASS}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, hd = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_fwd_tc_kernelILi(\d+)E", line)
            hd = int(m.group(1)) if m else None
            if hd is not None:
                counts[hd] = 0
        elif hd is not None and "HGMMA" in line:
            counts[hd] += 1
    return counts


def build(sources: dict) -> dict:
    """{name: loaded library}, each source compiled by nvcc with the
    port's flags; prints ptxas's registers, spills and warnings for the
    bf16 kernel at each hd, and its HGMMA count."""
    _build.BUILD.mkdir(exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = _build.BUILD / f"k4_tile{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        usage, hd = {}, None             # ptxas names a function, then its
        for line in log.splitlines():    # spills, then its registers
            if "Compiling entry function" in line:
                m = re.search(r"flash_fwd_tc_kernelILi(\d+)E", line)
                hd = int(m.group(1)) if m else None
            elif hd is not None and ("registers" in line or "spill" in line):
                usage.setdefault(hd, []).append(line.split(":")[-1].strip())
            if re.search(r"warning|Performance|\(C7\d{3}\)", line):
                print(f"  {name}: {line.strip()}", flush=True)
        hg = hgmma_counts(so)
        for h in sorted(usage):
            print(f"  {name}, hd={h}: {'; '.join(usage[h])}; HGMMA "
                  f"{hg.get(h, 0)}", flush=True)
        libs[name] = fa._bind(ctypes.CDLL(str(so)))
    return libs


def inputs(B, H, KV, S, hd, g):
    q = torch.randn((B, H, S, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, KV, S, hd), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    return q, k, v


def within_gate(out, ref) -> tuple[bool, float, str]:
    """(every element within the gate, max |err|, where the first element
    outside it lies)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    e = torch.floor(torch.log2(torch.clamp(ref.abs(), min=1e-30)))
    bad = diff > BF16_ULPS * torch.exp2(e - 7) + ATOL
    where = ""
    if bool(bad.any()):
        idx = [int(i) for i in bad.nonzero()[0]]
        where = (f"{int(bad.sum())} elements outside, the first at (b, h, s,"
                 f" d) = {tuple(idx)}: {float(out[tuple(idx)]):.5f} against "
                 f"{float(ref[tuple(idx)]):.5f}")
    return not where, float(diff.max()), where


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


def check(libs, g) -> bool:
    cases = []
    for shape in [SHAPES["gemma-2b"], *SMALL]:
        q, k, v = inputs(*shape, g)
        cases.append((shape, (q, k, v), fa.flash_attention_plain(
            q, k, v, 1, 1)))
    ok_all = True
    for name, lib in libs.items():
        ok, err = True, 0.0
        for shape, (q, k, v), ref in cases:
            ok_s, err_s, where = within_gate(fa._launch(lib, q, k, v), ref)
            if not ok_s:
                print(f"  {name} at (B, H, KV, S, hd) = {shape}: {where}",
                      flush=True)
            ok, err = ok and ok_s, max(err, err_s)
        print(f"  {name}: max |err| {err:.3e}, within the gate: {ok}",
              flush=True)
        ok_all = ok_all and ok
    return ok_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another flash_attention.cu to compile and time "
                         "as one more variant")
    ap.add_argument("--ablations", action="store_true",
                    help="also time the committed kernel with one part of "
                         "its work taken out (timing only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4_tiles: FAILED: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {name: variant_source(subs) for name, subs in VARIANTS.items()}
    if args.baseline is not None:
        sources[f"baseline {args.baseline.name}"] = \
            args.baseline.read_text()
    timing_only = {f"ablation: {name}": variant_source(subs)
                   for name, subs in ABLATIONS.items()} \
        if args.ablations else {}
    libs = build({**sources, **timing_only})
    g = torch.Generator(device="cuda").manual_seed(7)
    if not check({n: libs[n] for n in sources}, g):
        print("chip_k4_tiles: FAILED: a variant disagrees with the plain "
              "version", file=sys.stderr)
        return 1
    names = list(libs)
    for arch, (B, H, KV, S, hd) in SHAPES.items():
        q, k, v = inputs(B, H, KV, S, hd, g)
        times = {n: [] for n in names}
        for n in names + names[::-1] + names:
            times[n].append(median_ms(lambda: fa._launch(libs[n], q, k, v),
                                      args.reps))
        flops = 2 * B * H * S * S * hd
        print(f"{arch} (B={B} H={H} KV={KV} S={S} hd={hd}, "
              f"{flops / 1e9:.1f} GFLOP, bound "
              f"{flops / BF16_FLOPS_PER_S * 1e3:.4f} ms):", flush=True)
        for n in names:
            print(f"  {n}: " + ", ".join(f"{t:.4f}" for t in times[n])
                  + f" ms; {flops / min(times[n]) / 1e9:.1f} TFLOP/s at "
                  "the best", flush=True)
        sdpa = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True, scale=hd ** -0.5),
            args.reps)
        print(f"  SDPA: {sdpa:.4f} ms; {flops / sdpa / 1e9:.1f} TFLOP/s",
              flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
