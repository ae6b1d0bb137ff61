#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel (K1 pass-1 histogram, K2 pass-2 emit) bit-for-bit against its
plain PyTorch version on the card, then drives the main path — exact
Hamming kNN through the fused two-pass counting select,
``KNNEngine(...).with_layout().search(q, k=16)`` — at Q=4096, N=2^20,
d=256 on seeded clustered codes, checks the answers against an on-card
brute force and that both kernels ran once per search, and times it. The
same store then runs through ``select="fused"`` on insertion order.

The plain versions also run once at the main path's full shape, and
their outputs are held bit-for-bit against the kernels' there too.

Output: progress lines; a ``kernels`` JSON line (launches on the main
path, error against the plain version, kernel / plain / bound ms, and
what sets the bound: the faster of CUDA-core popcounts and an int8
tensor-core plane product, the histogram counts, or HBM bytes); the
card's name and power limit as nvidia-smi reports them; and, last,
``{"ok": true, "device": {...}}``. Any failing phase exits non-zero and
prints no result. Without a CUDA device, or outside a checkout, it exits
non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import carry  # noqa: E402
from repro_torch.core import binary, topk  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import topk_select as tsel  # noqa: E402

N_ROWS = 1 << 20         # 1M codes: SIFT1M/GIST1M-class store
D_BITS = 256             # kNN-TagSpace: d = 256, k = 16, 4096 queries
K = 16
N_QUERIES = 4096
N_CLUSTERS = 1024
FLIP_LOG2 = 4            # each code bit flips from its cluster centre w.p. 1/16
N_CHECK = 64             # queries held against the on-card brute force
N_TIMED = 5
# peak rates of one H100 SXM for the bound: CUDA-core popcounts (compute
# capability 9.0), dense int8 tensor-core operations and HBM bytes (NVIDIA's
# data sheet, at 700 W), shared-memory accesses (one per bank per clock)
POPC_PER_CLK_SM = 16
INT8_OPS_PER_S = 1.979e15
SMEM_OPS_PER_CLK_SM = 32
HBM_BYTES_PER_S = 3.35e12
DEV = "cuda"


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clustered_codes(rng, n: int, centers):
    """n codes, each a random centre with every bit flipped w.p. 2^-FLIP_LOG2
    (AND of FLIP_LOG2 random words) -> (n, W) uint32."""
    owner = rng.integers(0, centers.shape[0], size=n)
    noise = rng.integers(0, 1 << 32, size=(n, centers.shape[1]),
                         dtype=np.uint32)
    for _ in range(FLIP_LOG2 - 1):
        noise &= rng.integers(0, 1 << 32, size=noise.shape, dtype=np.uint32)
    return centers[owner] ^ noise


def cuda_ms(fn, reps: int):
    """(median ms of ``fn()`` over ``reps`` runs, each timed with CUDA
    events after one warm-up run; the last run's output)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def max_abs_diff(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 3: K1 and K2 against their plain versions
# ---------------------------------------------------------------------------

def kernel_case(name, q, x, bins, k, *, n_valid=None, mask_p=None,
                shard=None, geometry=(None, None, None), seed=0):
    """Run K1 then K2 on one case, kernel and plain on the same card inputs;
    returns (k1_err, k2_err). ``shard=(lo, hi)`` runs pass 2 on rows
    [lo, hi) of x with the slot and id bases the distributed select gives
    that shard (nonzero slot_base/id_base)."""
    Q, W = q.shape
    N = x.shape[0]
    lanes = max(bins, min(k, N))
    qp, xp, bq, bn, sub = ops._topk_blocked(q, x, lanes, *geometry)
    nv = N if n_valid is None else n_valid
    tiles = (qp.shape[0] // bq, xp.shape[0] // bn)
    en = torch.ones(tiles, dtype=torch.int32, device=DEV)
    mask = None
    if mask_p is not None:
        g = torch.Generator(device=DEV).manual_seed(seed)
        mask = (torch.rand(tiles, generator=g, device=DEV)
                < mask_p).to(torch.int32)
        en = mask
    hist_k, bmin_k = tsel.hamming_hist_kernel(qp, xp, bins, nv, mask,
                                              bq=bq, bn=bn, sub=sub)
    hist_p, bmin_p = tsel.hamming_hist_plain(qp, xp, bins, nv, en, bq, bn)
    torch.cuda.synchronize()
    k1 = max_abs_diff([(hist_k, hist_p), (bmin_k, bmin_p)])

    cum = torch.cumsum(hist_k[:Q], dim=-1, dtype=torch.int32)
    _, r_star, n_lt, _ = ops._radius_from_cum(cum, min(k, N))
    pad = qp.shape[0] - Q
    r_p = torch.nn.functional.pad(r_star, (0, pad), value=-1)
    nlt_p = torch.nn.functional.pad(n_lt, (0, pad))
    sb = torch.zeros_like(r_p)
    ib, xs, nvs, bms, ens, ms = 0, xp, nv, bmin_k, en, mask
    if shard is not None:
        lo, hi = shard          # lo a multiple of bn: shard tiles are whole
        h0, _ = tsel.hamming_hist_kernel(qp, xp[:lo], bins, lo, None,
                                         bq=bq, bn=bn, sub=sub)
        c0 = torch.cumsum(h0[:Q], dim=-1, dtype=torch.int32)
        at = lambda c, i: torch.gather(c, 1, i[:, None].long())[:, 0]
        lt0 = torch.where(r_star > 0, at(c0, torch.clamp(r_star - 1, min=0)),
                          0)
        tie0 = at(h0[:Q], r_star)
        sb = torch.nn.functional.pad(lt0.to(torch.int32), (0, pad))
        nlt_p = torch.nn.functional.pad((n_lt + tie0).to(torch.int32),
                                        (0, pad))
        ib, xs, nvs = lo, xp[lo:hi], min(nv, hi) - lo
        j0, j1 = lo // bn, hi // bn
        bms, ens = bmin_k[:, j0:j1], en[:, j0:j1]
        ms = None if mask is None else mask[:, j0:j1]
    d_k, i_k = tsel.hamming_emit_kernel(qp, xs, r_p, nlt_p, bins, k, nvs,
                                        block_min=bms, block_mask=ms,
                                        slot_base=sb, id_base=ib,
                                        bq=bq, bn=bn, sub=sub)
    d_p, i_p = tsel.hamming_emit_plain(qp, xs, r_p, nlt_p, bins, k, nvs,
                                       bms.contiguous(), ens.contiguous(),
                                       sb, ib, bq, bn)
    torch.cuda.synchronize()
    k2 = max_abs_diff([(d_k, d_p), (i_k, i_p)])
    print(f"  case {name}: Q={Q} N={N} W={W} bins={bins} k={k} "
          f"bq={bq} bn={bn} K1 err={k1} K2 err={k2}", flush=True)
    return k1, k2


def run_cases(main_q, main_x):
    rng = np.random.default_rng(1)

    def rand_codes(n, d):
        return carry.codes(rng.integers(0, 1 << 32, size=(n, -(-d // 32)),
                                        dtype=np.uint32), DEV)

    k1 = k2 = 0
    cases = [
        ("main-shape 256 queries x all rows", main_q[:256], main_x, 257, K,
         {}),
        ("ragged N", rand_codes(40, 96), rand_codes(5000, 96), 97, 10, {}),
        ("n_valid < N", rand_codes(64, 256), rand_codes(5000, 256), 257, 16,
         {"n_valid": 3000}),
        ("block_mask with zeros", rand_codes(96, 256), rand_codes(9000, 256),
         257, 16, {"mask_p": 0.5, "geometry": (32, 504, 24)}),
        ("slot_base/id_base (shard 2 of 2)", rand_codes(64, 256),
         rand_codes(8000, 256), 257, 16,
         {"shard": (4032, 8064), "geometry": (32, 504, 24)}),
        ("heavy ties d=8 k=3", rand_codes(4, 8) & 0xFF,
         rand_codes(4096, 8) & 0xFF, 9, 3, {}),
        ("heavy ties d=8 k=512", rand_codes(4, 8) & 0xFF,
         rand_codes(4096, 8) & 0xFF, 9, 512, {}),
        ("k > N", rand_codes(3, 64), rand_codes(37, 64), 65, 50, {}),
        ("wide codes d=384 (generic width)", rand_codes(48, 384),
         rand_codes(3000, 384), 385, 16, {}),
        ("bq=64 (65.8 KB shared histogram, two queries per warp)",
         rand_codes(100, 256), rand_codes(3000, 256), 257, 16,
         {"geometry": (64, 512, 8)}),
    ]
    for name, q, x, bins, k, kw in cases:
        a, b = kernel_case(name, q, x, bins, k, **kw)
        k1, k2 = max(k1, a), max(k2, b)

    # the whole select on the card against the same select on the CPU
    q, x = rand_codes(33, 160), rand_codes(4097, 160)
    gd, gi, gs = ops.hamming_topk(q, x, 24, 161, return_stats=True)
    cd, ci, cs = ops.hamming_topk(q.cpu(), x.cpu(), 24, 161,
                                  bq=32, bn=1032, sub=24, return_stats=True)
    if not (torch.equal(gd.cpu(), cd) and torch.equal(gi.cpu(), ci)):
        raise AssertionError("hamming_topk on the card != on the CPU")
    print("  hamming_topk card == cpu (33 x 4097, d=160, k=24): ok",
          flush=True)
    return k1, k2


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def brute_force_check(eng, q, dd, ii, sample):
    """Distances of the sampled queries == the on-card brute force; every
    returned id is a distinct row at exactly its reported distance."""
    qs = q[sample]
    full = binary.hamming_xor(qs, eng.codes)                 # (S, N)
    ref_d, _ = topk.topk_ref(full, K)
    if not torch.equal(ref_d, dd[sample]):
        raise AssertionError("distances differ from the brute force")
    ids = ii[sample].long()
    if int(ids.min()) < 0 or int(ids.max()) >= eng.n:
        raise AssertionError("ids out of range")
    if not torch.equal(torch.gather(full, 1, ids), dd[sample]):
        raise AssertionError("an id's distance differs from its reported one")
    srt = torch.sort(ids, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError("duplicate ids in a row")


def drive(label, eng, q, sample, **kw):
    """One search with the launch counts zeroed just before and read just
    after; checks, then the median of N_TIMED timed searches."""
    tsel.reset_launch_counts()
    dd, ii = eng.search(q, K, **kw)
    torch.cuda.synchronize()
    launches = {"K1": tsel.hamming_hist_kernel.launches,
                "K2": tsel.hamming_emit_kernel.launches}
    if launches != {"K1": 1, "K2": 1}:
        raise AssertionError(f"{label}: launches {launches}, expected one "
                             f"each per search")
    if tuple(dd.shape) != (N_QUERIES, K) or tuple(ii.shape) != (N_QUERIES, K):
        raise AssertionError(f"{label}: result shape {tuple(dd.shape)}")
    brute_force_check(eng, q, dd, ii, sample)
    ms, _ = cuda_ms(lambda: eng.search(q, K, **kw), N_TIMED)
    print(f"  {label}: launches {launches}, brute-force check ok, "
          f"median search {ms:.3f} ms, {N_QUERIES / ms * 1e3:.0f} queries/s",
          flush=True)
    return launches, ms


def kernel_timings(q, x, stats_label, with_plain=True):
    """K1/K2 at the main path's inputs: their times, with_plain also the
    plain versions' times and their outputs held bit-for-bit against the
    kernels' (hist, block_min, dists, ids); the pass-2 skip share; and the
    work both passes must do."""
    Q, W = q.shape
    N = x.shape[0]
    bins = D_BITS + 1
    qp, xp, bq, bn, sub = ops._topk_blocked(q, x, bins, None, None, None)
    tiles = (qp.shape[0] // bq, xp.shape[0] // bn)
    ones = torch.ones(tiles, dtype=torch.int32, device=DEV)
    hist, bmin = tsel.hamming_hist_kernel(qp, xp, bins, N, bq=bq, bn=bn,
                                          sub=sub)
    cum = torch.cumsum(hist[:Q], dim=-1, dtype=torch.int32)
    _, r_star, n_lt, _ = ops._radius_from_cum(cum, K)
    r_p = torch.nn.functional.pad(r_star, (0, qp.shape[0] - Q), value=-1)
    nlt_p = torch.nn.functional.pad(n_lt, (0, qp.shape[0] - Q))
    zeros = torch.zeros_like(r_p)

    k1_ms, k1_out = cuda_ms(lambda: tsel.hamming_hist_kernel(
        qp, xp, bins, N, bq=bq, bn=bn, sub=sub), N_TIMED)
    k2_ms, k2_out = cuda_ms(lambda: tsel.hamming_emit_kernel(
        qp, xp, r_p, nlt_p, bins, K, N, block_min=bmin, bq=bq, bn=bn,
        sub=sub), N_TIMED)
    k1_plain = k2_plain = k1_err = k2_err = None
    if with_plain:
        k1_plain, p1 = cuda_ms(lambda: tsel.hamming_hist_plain(
            qp, xp, bins, N, ones, bq, bn), 1)
        k2_plain, p2 = cuda_ms(lambda: tsel.hamming_emit_plain(
            qp, xp, r_p, nlt_p, bins, K, N, bmin, ones, zeros, 0, bq, bn), 1)
        k1_err = max_abs_diff(zip(k1_out, p1))
        k2_err = max_abs_diff(zip(k2_out, p2))

    # the work: K1 every (query, row) pair; K2 the pairs of the tiles it
    # does not skip. Bytes: each input read once, each output written once.
    max_r = r_p.reshape(-1, bq).amax(dim=1)
    runs = bmin <= max_r[:, None]
    skipped = 1.0 - float(runs.float().mean())
    q_real = torch.clamp(Q - torch.arange(tiles[0], device=DEV) * bq,
                         0, bq)
    n_real = torch.clamp(N - torch.arange(tiles[1], device=DEV) * bn,
                         0, bn)
    k2_pairs = int((runs * q_real[:, None] * n_real[None, :]).sum())
    rows_read = int((runs.any(dim=0) * n_real).sum())
    k1_bytes = 4 * (Q * W + N * W + Q * bins + bmin.numel())
    k2_bytes = 4 * (Q * W + rows_read * W + 2 * bmin.numel() + 3 * Q
                    + 2 * Q * K)
    print(f"  {stats_label}: geometry bq={bq} bn={bn} sub={sub} "
          f"tiles={tiles}; K1 {k1_ms:.3f} ms (plain {k1_plain} ms), "
          f"K2 {k2_ms:.3f} ms (plain {k2_plain} ms), pass-2 "
          f"blocks_skipped {skipped:.4f}; full-shape kernel vs plain: "
          f"K1 err={k1_err} K2 err={k2_err}", flush=True)
    return {"k1_ms": k1_ms, "k2_ms": k2_ms, "k1_plain": k1_plain,
            "k2_plain": k2_plain, "k1_err": k1_err, "k2_err": k2_err,
            "skipped": skipped, "W": W, "k1_pairs": Q * N,
            "k2_pairs": k2_pairs, "k1_bytes": k1_bytes, "k2_bytes": k2_bytes}


def bound_ms(pairs: int, words: int, hist_adds: int, nbytes: int,
             sms: int, clk_hz: float):
    """Least time the card could take to score ``pairs`` (query, row)
    pairs of ``words``-word codes, add ``hist_adds`` histogram counts and
    move ``nbytes``. The distances take the faster of two routes: ``words``
    popcounts per pair on the CUDA cores, or a +-1 int8 plane product
    (2 * 32 * words operations per pair) on the tensor cores. Histogram
    counts take at least one shared-memory access each.
    Returns (ms, "operations" or "bytes", what sets the time)."""
    t_popc = pairs * words / (POPC_PER_CLK_SM * sms * clk_hz)
    t_int8 = 2 * pairs * 32 * words / INT8_OPS_PER_S
    t = min((t_popc, "popcounts on the CUDA cores"),
            (t_int8, "int8 plane product on the tensor cores"))
    t = max(t, (hist_adds / (SMEM_OPS_PER_CLK_SM * sms * clk_hz),
                "shared-memory histogram counts"),
            (nbytes / HBM_BYTES_PER_S, "HBM bytes"))
    return t[0] * 1e3, ("bytes" if t[1] == "HBM bytes" else "operations"), t[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs "
                    "a CUDA card")

    # phase 1: the card
    card = nvidia_smi("name,power.limit")
    max_clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    print(f"card: {card}; {props.multi_processor_count} SMs, max SM clock "
          f"{max_clk_mhz:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    sms, clk_hz = props.multi_processor_count, max_clk_mhz * 1e6

    # phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    logs = _build.build([tsel._SOURCE])
    print(f"build: {tsel._SOURCE} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # the main path's store: seeded clustered codes, made with numpy
    rng = np.random.default_rng(args.seed)
    W = D_BITS // 32
    centers = rng.integers(0, 1 << 32, size=(N_CLUSTERS, W), dtype=np.uint32)
    codes_np = clustered_codes(rng, N_ROWS, centers)
    q_np = clustered_codes(rng, N_QUERIES, centers)
    q = carry.codes(q_np, DEV)

    t0 = time.perf_counter()
    eng = carry.engine(codes_np, D_BITS, device=DEV).with_layout()
    torch.cuda.synchronize()
    print(f"store: N={N_ROWS} d={D_BITS} ({N_ROWS * W * 4 / 2**20:.0f} MiB "
          f"of codes), layout with {eng.layout.n_buckets} buckets built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 3: each kernel against its plain version
    print("kernels vs plain (bit-for-bit):", flush=True)
    k1_err, k2_err = run_cases(q, eng.layout.codes)
    if k1_err or k2_err:
        return fail(f"kernel != plain: K1 err {k1_err}, K2 err {k2_err}")

    # phase 4: the main path, KNNEngine.with_layout().search
    sample = torch.from_numpy(
        np.random.default_rng(args.seed + 1).choice(N_QUERIES, N_CHECK,
                                                    replace=False)).to(DEV)
    print(f"main path: Q={N_QUERIES} N={N_ROWS} d={D_BITS} k={K}", flush=True)
    plan = eng.query_plan(q, K)
    print(f"  plan: {plan.compact()} ({plan.reason})", flush=True)
    launches, main_ms = drive("with_layout().search", eng, q, sample)
    kt = kernel_timings(q, eng.layout.codes, "layout order")
    if kt["k1_err"] or kt["k2_err"]:
        return fail(f"kernel != plain at the main path's shape: K1 err "
                    f"{kt['k1_err']}, K2 err {kt['k2_err']}")
    k1_err, k2_err = max(k1_err, kt["k1_err"]), max(k2_err, kt["k2_err"])

    # phase 5: the same store on insertion order through select="fused"
    flat = eng._replace(layout=None)
    _, flat_ms = drive("select='fused', insertion order", flat, q, sample,
                       select="fused")
    ft = kernel_timings(q, flat.codes, "insertion order", with_plain=False)

    b1, by1, route1 = bound_ms(kt["k1_pairs"], kt["W"], kt["k1_pairs"],
                               kt["k1_bytes"], sms, clk_hz)
    b2, by2, route2 = bound_ms(kt["k2_pairs"], kt["W"], 0, kt["k2_bytes"],
                               sms, clk_hz)
    print(f"bounds: K1 {b1:.4f} ms set by {route1}; K2 {b2:.4f} ms set by "
          f"{route2}", flush=True)
    print("main_path: " + json.dumps({
        "search_ms": main_ms, "queries_per_s": N_QUERIES / main_ms * 1e3,
        "blocks_skipped_frac": kt["skipped"],
        "insertion_order_search_ms": flat_ms,
        "insertion_order_blocks_skipped_frac": ft["skipped"],
        "insertion_order_k1_ms": ft["k1_ms"],
        "insertion_order_k2_ms": ft["k2_ms"]}), flush=True)
    src = "src/repro_torch/kernels/csrc/topk_select.cu"
    print(json.dumps({"kernels": [
        {"name": "K1 hamming_hist_kernel", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/topk_select.py:91",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": kt["k1_ms"], "plain_ms": kt["k1_plain"], "bound_ms": b1,
         "bound_by": by1, "bound_route": route1, "library_ms": None},
        {"name": "K2 hamming_emit_kernel", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/topk_select.py:192",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": kt["k2_ms"], "plain_ms": kt["k2_plain"], "bound_ms": b2,
         "bound_by": by2, "bound_route": route2, "library_ms": None},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
