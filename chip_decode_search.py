#!/usr/bin/env python3
"""The kNN-LM decode step's retrieval at the serving batch, timed on one
copy of the port.

Run on a machine with one CUDA card:

    python3 chip_decode_search.py [--src DIR] [--batch 8] [--reps 50]
                                  [--seed 0]

It imports ``repro_torch`` from DIR (default: the ``src`` beside this
script), so two copies of the package compare on one card by running it
once for each, in turns (A, B, B, A), on one machine. It builds a
datastore of gemma-2b's retrieval shape, as ``chip_smoke.py``'s
serving path has it (512 x 2047 = 1,048,064 entries, 256-bit ITQ codes of
2048-wide hidden states, insertion order), from seeded Gaussian-mixture
hidden states in place of the model's. Then it times
``retrieval.knn_logits(..., select="fused")`` on ``--batch`` hidden states
(median of ``--reps``): the span on the card between CUDA events recorded
around the call, the host time the call takes to return, and, from events
recorded around each K1 and K2 launch inside it, the spans before K1, of
K1, from K1 to K2, of K2 and after K2. On a path that the host holds back,
an event span is the host's time to launch its work. It prints one JSON
line. Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

N_SEQS, SEQ_LEN = 512, 2047     # chip_smoke.py's serving datastore
N_CENTRES = 1024
ITQ_ITERS = 8
ARCH = "gemma-2b"


def mixture(g, centres, n, chunk=1 << 16):
    """(n, dim) bf16 hidden states: a seeded centre each plus unit noise."""
    out = torch.empty((n, centres.shape[1]), dtype=torch.bfloat16,
                      device=centres.device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        pick = torch.randint(0, centres.shape[0], (m,), generator=g,
                             device=centres.device)
        out[i:i + m] = centres[pick] + torch.randn(
            (m, centres.shape[1]), generator=g, device=centres.device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this check needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.core import retrieval
    from repro_torch.kernels import ops

    cfg = get_config(ARCH)
    rcfg = cfg.retrieval
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(args.seed)
    centres = 2.0 * torch.randn((N_CENTRES, cfg.d_model), generator=g,
                                device=dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        hid = mixture(g, centres, N_SEQS * SEQ_LEN)
        tokens = torch.randint(0, cfg.vocab_size, (hid.shape[0],),
                               generator=g, device=dev)
        store = retrieval.build_datastore(
            hid, tokens, rcfg.code_bits, itq_iters=ITQ_ITERS,
            generator=torch.Generator(device=dev).manual_seed(11))
        del hid
        h = mixture(g, centres, args.batch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # events around each K1 and K2 launch inside knn_logits
    marks = []

    def marked(name, fn):
        def call(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            marks.append((name, s, e))
            return out
        return call

    ops.hamming_hist_kernel = marked("K1", ops.hamming_hist_kernel)
    ops.hamming_emit_kernel = marked("K2", ops.hamming_emit_kernel)

    def once():
        marks.clear()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        t = time.perf_counter()
        out = retrieval.knn_logits(store, h, rcfg, cfg.vocab_size,
                                   select="fused")
        host = (time.perf_counter() - t) * 1e3
        e.record()
        torch.cuda.synchronize()
        (_, k1s, k1e), = [m for m in marks if m[0] == "K1"]
        (_, k2s, k2e), = [m for m in marks if m[0] == "K2"]
        return out, {
            "call_ms": s.elapsed_time(e), "host_ms": host,
            "before_k1_ms": s.elapsed_time(k1s),
            "k1_ms": k1s.elapsed_time(k1e),
            "k1_to_k2_ms": k1e.elapsed_time(k2s),
            "k2_ms": k2s.elapsed_time(k2e),
            "after_k2_ms": k2e.elapsed_time(e)}

    with torch.inference_mode():
        for _ in range(5):
            out, _ = once()
        runs = [once()[1] for _ in range(args.reps)]
    if out.shape != (args.batch, cfg.vocab_size) or not bool(
            torch.isfinite(out).all()):
        print("FAIL: knn_logits gave a wrong shape or non-finite values",
              file=sys.stderr)
        return 1
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "batch": args.batch,
                      "entries": int(store.codes.shape[0]),
                      "store_build_s": build_s, "reps": args.reps,
                      "median": med}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
