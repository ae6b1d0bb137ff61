"""Block-shape heuristics + the measured autotune cache (port of
``repro.kernels.tuning``: the fused select, the distance kernel, the
approximate tier, and the sharded merge's fanout, tree levels and traffic
hints, which are host arithmetic copied whole).

Resolution order is **measured beats default**: every lookup first consults
the :class:`AutotuneCache` (the same JSON file format as ``repro``'s, keyed
per backend, kind and power-of-two geometry bucket) and only falls back to
the static heuristic when no measurement exists. With an empty cache every
shape is a pure function of the inputs.

The ``"gpu"`` rows of the exact tier are ``repro``'s as they stand; the
approx tier's ``"gpu"`` row (``_APPROX_BLOCKS``) is the port's own. On the card the
CUDA kernels take ``bq`` and ``bn`` from here; ``sub`` (the TPU's in-tile
sub-step that bounds a VMEM one-hot) is kept for parity and ignored by
them. The GPU geometry (bq, bn, sub) = (32, 1032, 24) at Q=4096, N=2^20,
W=8, lanes=257 gives a 32 x 257 int32 shared-memory histogram per CTA
(32.9 KB, under the 48 KB static limit) and a (128, 1017) block-min summary.
"""
from __future__ import annotations

import json
import os
import time

from repro_torch import device as device_mod

_SUBLANE = 8
_LANE = 128
_ONEHOT_BYTES = {"tpu": 2 << 20, "cpu": 4 << 20, "gpu": 1 << 20}
_MAX_N_BLOCKS = {"tpu": 1024, "cpu": 16, "gpu": 1024}
_CODE_TILE_BYTES = {"tpu": 4 << 20, "cpu": 1 << 20, "gpu": 2 << 20}
# approx tier: (target block count, largest bn) of the seeded default.
# The card scores a chunk of blocks per product whatever bn is, so bn only
# sizes the candidate pool: fewer, larger blocks give a smaller pool and a
# higher recall bound at the same L.
_APPROX_BLOCKS = {"tpu": (32, 8192), "cpu": (32, 8192), "gpu": (32, 1 << 15)}


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _round_down(n: int, m: int) -> int:
    return max(m, n // m * m)


# ---------------------------------------------------------------------------
# the measured autotune cache
# ---------------------------------------------------------------------------

def _pow2_bucket(n: int) -> int:
    """Geometry bucketing for cache keys: round up to a power of two."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


class AutotuneCache:
    """Per-(backend, kind, geometry-bucket) measured block shapes.

    Entries live in one JSON file (``path``; default from the
    ``REPRO_AUTOTUNE_CACHE`` env var, empty -> in-memory only) shaped
    ``{key: {"bq":…,"bn":…,"sub":…,"us":…}}``. A corrupt or missing file
    degrades to an empty cache. Lookups sanitize entries back onto the
    kernels' tiling constraints, so a stale file can bias performance but
    never produce an invalid grid."""

    def __init__(self, path: str | None = None):
        self.path = (os.environ.get("REPRO_AUTOTUNE_CACHE", "")
                     if path is None else path)
        self._entries: dict[str, dict] = {}
        self._loaded = False

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        if not self.path or not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return                   # corrupt cache == empty cache
        if isinstance(data, dict):
            self._entries.update(
                {k: v for k, v in data.items() if isinstance(v, dict)})

    def save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._entries, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    @staticmethod
    def key(backend: str, kind: str, Q: int, N: int, W: int,
            lanes: int) -> str:
        return (f"{backend}/{kind}/q{_pow2_bucket(Q)}"
                f"n{_pow2_bucket(N)}w{max(int(W), 1)}l{_pow2_bucket(lanes)}")

    def get(self, backend: str, kind: str, Q: int, N: int, W: int,
            lanes: int) -> dict | None:
        self._load()
        return self._entries.get(self.key(backend, kind, Q, N, W, lanes))

    def put(self, backend: str, kind: str, Q: int, N: int, W: int,
            lanes: int, entry: dict, persist: bool = True) -> None:
        self._load()
        self._entries[self.key(backend, kind, Q, N, W, lanes)] = dict(entry)
        if persist:
            self.save()

    def clear(self) -> None:
        self._entries.clear()
        self._loaded = True

    def __len__(self) -> int:
        self._load()
        return len(self._entries)


_CACHE = AutotuneCache()


def autotune_cache() -> AutotuneCache:
    return _CACHE


def configure(path: str | None = None) -> AutotuneCache:
    """Rebind the process-wide cache (tests point it at a tmp file; ""
    keeps it purely in-memory). Returns the new cache."""
    global _CACHE
    _CACHE = AutotuneCache("" if path is None else path)
    return _CACHE


def _sane_topk_entry(entry: dict, N: int) -> tuple[int, int, int] | None:
    """Sanitize a measured (bq, bn, sub) back onto the kernels' tiling
    constraints; None when the entry is not a usable shape."""
    try:
        bq, bn, sub = int(entry["bq"]), int(entry["bn"]), int(entry["sub"])
    except (KeyError, TypeError, ValueError):
        return None
    if min(bq, bn, sub) <= 0:
        return None
    bq = _round_up(bq, _SUBLANE)
    sub = min(_round_up(sub, _SUBLANE), 256)
    bn = _round_up(bn, sub)
    return bq, bn, sub


def hint_source(backend: str, kind: str, Q: int, N: int, W: int,
                lanes: int) -> str:
    """"measured" when the cache holds a usable entry for this geometry
    bucket, else "default" (the static heuristics)."""
    ent = _CACHE.get(backend, kind, Q, N, W, lanes)
    if kind == "topk":
        return "measured" if (ent is not None
                              and _sane_topk_entry(ent, N)) else "default"
    return "measured" if (ent is not None and ent.get("bn")) else "default"


def topk_blocks(Q: int, N: int, W: int, lanes: int,
                backend: str | None = None) -> tuple[int, int, int]:
    """(bq, bn, sub) for the two-pass counting-select kernels.

    ``lanes`` is ``max(bins, k)``: both passes take the SAME geometry so
    the (Q/bq, N/bn) block-min summary means the same tiles in both. A
    measured cache entry for this (backend, geometry bucket) overrides the
    static heuristic."""
    backend = backend or device_mod.default_backend()
    ent = _CACHE.get(backend, "topk", Q, N, W, lanes)
    if ent is not None:
        sane = _sane_topk_entry(ent, N)
        if sane is not None:
            return sane
    return _topk_blocks_default(Q, N, W, lanes, backend)


def _topk_blocks_default(Q: int, N: int, W: int, lanes: int,
                         backend: str) -> tuple[int, int, int]:
    """The static heuristic — the cache's seeded default (``repro``'s rule,
    line for line, so both packages tile a store identically)."""
    budget = _ONEHOT_BYTES.get(backend, 1 << 20)

    bq = min(_round_up(Q, _SUBLANE), 64 if backend == "tpu" else 32)
    sub = _round_down(budget // (4 * bq * max(lanes, 1)), _SUBLANE)
    sub = min(sub, 256)
    while bq > _SUBLANE and 4 * bq * sub * max(lanes, 1) > budget:
        bq = _round_down(bq // 2, _SUBLANE)
    bn_cap = 2048 if backend == "tpu" else 512
    bn = min(_round_up(N, sub), _round_down(bn_cap, sub))
    # whole-datastore grid: once N/bn exceeds the block cap, grow bn (still
    # a multiple of sub) until the block count is bounded or the code tile
    # hits its budget
    max_blocks = _MAX_N_BLOCKS.get(backend, 64)
    if N > bn * max_blocks:
        want = _round_up(-(-N // max_blocks), sub)
        cap = _round_down(_CODE_TILE_BYTES.get(backend, 1 << 20)
                          // (4 * max(W, 1)), sub)
        bn = max(bn, min(want, cap))
    return bq, bn, sub


def measure(runner, candidates, *, backend: str, kind: str, Q: int, N: int,
            W: int, lanes: int, reps: int = 3, timer=None,
            persist: bool = True) -> dict:
    """Time ``runner(candidate)`` over ``candidates`` and cache the winner.

    ``runner`` executes one kernel call for a candidate shape and blocks on
    its result (on the card: ``torch.cuda.synchronize()``); ``timer``
    defaults to ``time.perf_counter`` and is injectable so tests measure
    with a fake clock. Each candidate gets one warm-up call (build) plus
    ``reps`` timed calls; the best median wins. Returns the cached entry.
    Nothing in this module calls ``measure`` implicitly."""
    timer = time.perf_counter if timer is None else timer
    best = None
    for cand in candidates:
        try:
            runner(cand)                       # warm-up / build
            times = []
            for _ in range(max(reps, 1)):
                t0 = timer()
                runner(cand)
                times.append(timer() - t0)
            us = sorted(times)[len(times) // 2] * 1e6
        except Exception:                      # noqa: BLE001 — an invalid
            continue                           # candidate just loses
        if best is None or us < best[0]:
            best = (us, cand)
    if best is None:
        raise ValueError("no candidate shape ran successfully")
    us, cand = best
    entry = dict(cand)
    entry["us"] = round(us, 3)
    _CACHE.put(backend, kind, Q, N, W, lanes, entry, persist=persist)
    return entry


def topk_candidates(Q: int, N: int, W: int, lanes: int,
                    backend: str | None = None) -> list[dict]:
    """Candidate (bq, bn, sub) shapes for ``measure`` around the static
    heuristic: the default itself plus halved/doubled bn and sub variants,
    sanitized and deduplicated."""
    backend = backend or device_mod.default_backend()
    bq, bn, sub = _topk_blocks_default(Q, N, W, lanes, backend)
    raw = [(bq, bn, sub), (bq, bn * 2, sub), (bq, max(bn // 2, sub), sub),
           (bq, bn, max(sub // 2, _SUBLANE)),
           (max(bq // 2, _SUBLANE), bn, sub)]
    out, seen = [], set()
    for cand in raw:
        ok = _sane_topk_entry(dict(zip(("bq", "bn", "sub"), cand)), N)
        if ok and ok not in seen:
            seen.add(ok)
            out.append(dict(zip(("bq", "bn", "sub"), ok)))
    return out


def approx_blocks(Q: int, N: int, W: int,
                  backend: str | None = None) -> int:
    """Data-block rows ``bn`` for the approximate partial-reduce select
    (``kernels/approx_select.py``): each block's (Q, bn) score tile is
    reduced to L candidates before the merge. The seeded default targets
    the backend's block count with a lane-aligned floor and its bn cap
    (``_APPROX_BLOCKS``); a measured cache entry (kind="approx") overrides
    it."""
    backend = backend or device_mod.default_backend()
    ent = _CACHE.get(backend, "approx", Q, N, W, 1)
    if ent is not None:
        try:
            bn = int(ent["bn"])
        except (KeyError, TypeError, ValueError):
            bn = 0
        if bn > 0:
            return min(_round_up(bn, _LANE), 1 << 16)
    blocks, cap = _APPROX_BLOCKS.get(backend, (32, 8192))
    bn = _round_up(max(-(-max(N, 1) // blocks), _LANE), _LANE)
    return min(bn, cap)


def layout_blocks(Q: int, N: int, W: int, lanes: int, bucket_rows: int,
                  backend: str | None = None) -> tuple[int, int, int]:
    """(bq, bn, sub) for the MASKED select over a bucket-clustered layout:
    ``topk_blocks`` with bn pulled toward the bucket size (rounded up to a
    sub multiple), since the enable mask's granularity is the data block."""
    bq, bn, sub = topk_blocks(Q, N, W, lanes, backend=backend)
    if bucket_rows and bucket_rows > 0:
        bn = max(sub, min(bn, _round_up(bucket_rows, sub)))
    return bq, bn, sub


def cost_hints(Q: int, N: int, W: int, lanes: int, *, path: str = "fused",
               chunk: int = 0, bucket_rows: int = 0,
               backend: str | None = None) -> dict:
    """Geometry + predicted per-call footprints for ``QueryPlan.explain()``,
    computed by the SAME heuristics the kernels consult.
    ``codes_bytes_streamed`` counts the code reads of both passes, once per
    query block; ``summary_bytes`` is the pass-1 block-min table."""
    backend = backend or device_mod.default_backend()
    if path in ("fused", "fused_scan"):
        n_eff = min(chunk, N) if (path == "fused_scan" and chunk) else N
        if bucket_rows:
            bq, bn, sub = layout_blocks(Q, n_eff, W, lanes, bucket_rows,
                                        backend=backend)
        else:
            bq, bn, sub = topk_blocks(Q, n_eff, W, lanes, backend=backend)
        q_pad, n_pad = _round_up(Q, bq), _round_up(n_eff, bn)
        grid = (q_pad // bq, n_pad // bn)
        hints = {
            "bq": bq, "bn": bn, "sub": sub, "grid": list(grid),
            "codes_bytes_streamed": 2 * 4 * W * n_pad * grid[0],
            "onehot_bytes": 4 * bq * sub * max(lanes, 1),
            "summary_bytes": 4 * grid[0] * grid[1],
            "hist_bytes": 4 * Q * max(lanes, 1),
            "hint_source": hint_source(backend, "topk", Q, n_eff, W, lanes),
        }
        if path == "fused_scan":
            hints["n_scan_steps"] = -(-N // max(n_eff, 1))
        return hints
    # materializing paths: the (Q, chunk) distance tile is the cost
    c = min(chunk or N, N)
    return {
        "codes_bytes_streamed": 4 * W * N,
        "distance_tile_bytes": 4 * Q * c,
        "distance_total_bytes": 4 * Q * N,
        "hint_source": "default",
    }


def merge_fanout(n_shards: int) -> int:
    """Default hist_tree group width: roughly sqrt(n_shards) rounded to a
    power of two, so the intra-host (level-0) and inter-host (tree) halves
    of the merge carry balanced group sizes. Below 4 shards a tree cannot
    beat the flat psum — return 0 (flat)."""
    if n_shards < 4:
        return 0
    f = 2
    while f * f < n_shards:
        f *= 2
    return f


def tree_levels(n_shards: int, fanout: int) -> int:
    """Number of reduction rounds ``ops._tree_psum`` runs for this shard
    count and fanout (divisible rounds + the remainder round). Mirrors the
    kernel's loop exactly so ``shard_hints`` predicts the real schedule."""
    if fanout < 2 or n_shards < 2:
        return 1 if n_shards > 1 else 0
    levels, s = 0, 1
    while s * fanout <= n_shards and n_shards % (s * fanout) == 0:
        levels += 1
        s *= fanout
    if s < n_shards:
        levels += 1
    return levels


def shard_hints(Q: int, k: int, bins: int, n_shards: int, *,
                k_local: int | None = None,
                strategy: str = "hist_merge",
                fanout: int = 0) -> dict:
    """Shard geometry + predicted CROSS-DEVICE merge traffic per query
    batch, for ``QueryPlan.explain()`` on sharded plans.

    ``hist_merge`` (the distributed counting select) moves exactly three
    tiny tensors between devices: the (Q, bins) int32 partial-histogram
    psum, the (Q, 2)-per-shard slot-base all-gather, and the (Q, k) x2
    disjoint-slot output psum — O(Q·bins), independent of n_shards·k.
    ``hist_tree`` moves the SAME tensors but reduces them hierarchically:
    level 0 is the intra-host group psum, the remaining ``tree_levels - 1``
    rounds are the inter-host tree — per-hop traffic shrinks from one
    n_shards-wide reduction to ``fanout``-wide exchanges, reported split
    into ``hist_tree_intra_bytes`` / ``hist_tree_inter_bytes``.
    ``concat_sort`` (the legacy hierarchical merge) all-gathers every
    shard's (k' dists, k' ids): O(n_shards·Q·k') candidate bytes. All are
    reported so the ratios are inspectable whatever the plan chose."""
    k_local = k if (k_local is None or k_local <= 0) else k_local
    hist_psum = 4 * Q * bins
    counts_gather = 2 * 4 * Q * n_shards
    output_psum = 2 * 4 * Q * k
    hist_total = hist_psum + counts_gather + output_psum
    concat_total = 2 * 4 * Q * k_local * n_shards
    eff_fanout = fanout if fanout >= 2 else (merge_fanout(n_shards) or 2)
    levels = max(tree_levels(n_shards, eff_fanout), 1)
    per_level = hist_psum + output_psum
    tree_intra = per_level
    tree_inter = (levels - 1) * per_level
    tree_total = tree_intra + tree_inter + counts_gather
    return {
        "n_shards": n_shards,
        "strategy": strategy,
        "merge_bytes": (concat_total if strategy == "concat_sort"
                        else tree_total if strategy == "hist_tree"
                        else hist_total),
        "hist_merge_bytes": hist_total,
        "hist_psum_bytes": hist_psum,
        "counts_gather_bytes": counts_gather,
        "output_psum_bytes": output_psum,
        "concat_sort_bytes": concat_total,
        "fanout": eff_fanout if strategy == "hist_tree" else fanout,
        "tree_levels": levels,
        "hist_tree_intra_bytes": tree_intra,
        "hist_tree_inter_bytes": tree_inter,
        "hist_tree_bytes": tree_total,
    }


def distance_blocks(Q: int, N: int, W: int,
                    backend: str | None = None) -> tuple[int, int]:
    """(bq, bn) for the materializing (Q, N) distance kernel (K3): the same
    tile on every backend."""
    bq, bn = 128, 512
    bq = min(bq, _round_up(Q, _SUBLANE))
    bn = min(bn, _round_up(N, _LANE))
    return bq, bn
