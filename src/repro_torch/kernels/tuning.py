"""Block-shape heuristics (port of ``repro.kernels.tuning``): the
distance kernel, the approximate tier, and the sharded merge's fanout,
tree levels and traffic hints, which are host arithmetic copied whole.
Every shape is a pure function of the inputs.

K1/K2's (bq, bn) is ``topk_select.geometry``'s, beside the kernels' own
limits; ``cost_hints`` reports it. The approx tier's ``"gpu"`` row
(``_APPROX_BLOCKS``) is the port's own.
"""
from __future__ import annotations

from repro_torch import device as device_mod
from repro_torch.kernels import topk_select

_SUBLANE = 8
_LANE = 128
# approx tier: (target block count, largest bn) of the default.
# The card scores a chunk of blocks per product whatever bn is, so bn only
# sizes the candidate pool: fewer, larger blocks give a smaller pool and a
# higher recall bound at the same L.
_APPROX_BLOCKS = {"cpu": (32, 8192), "gpu": (32, 1 << 15)}


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def approx_blocks(Q: int, N: int, W: int,
                  backend: str | None = None) -> int:
    """Data-block rows ``bn`` for the approximate partial-reduce select
    (``kernels/approx_select.py``): each block's (Q, bn) score tile is
    reduced to L candidates before the merge. The default targets the
    backend's block count with a lane-aligned floor and its bn cap
    (``_APPROX_BLOCKS``)."""
    backend = backend or device_mod.default_backend()
    blocks, cap = _APPROX_BLOCKS.get(backend, (32, 8192))
    bn = _round_up(max(-(-max(N, 1) // blocks), _LANE), _LANE)
    return min(bn, cap)


def cost_hints(Q: int, N: int, W: int, lanes: int, *, path: str = "fused",
               chunk: int = 0, bucket_rows: int = 0,
               backend: str | None = None) -> dict:
    """Geometry + predicted per-call footprints for ``QueryPlan.explain()``,
    computed by the SAME rule the kernels are tiled by
    (``topk_select.geometry``). ``codes_bytes_streamed`` counts the code
    reads of both passes, once per query block; ``summary_bytes`` is the
    pass-1 block-min table."""
    backend = backend or device_mod.default_backend()
    if path in ("fused", "fused_scan"):
        n_eff = min(chunk, N) if (path == "fused_scan" and chunk) else N
        bq, bn = topk_select.geometry(Q, n_eff, W, lanes, backend,
                                      bucket_rows)
        q_pad, n_pad = _round_up(Q, bq), _round_up(n_eff, bn)
        grid = (q_pad // bq, n_pad // bn)
        hints = {
            "bq": bq, "bn": bn, "grid": list(grid),
            "codes_bytes_streamed": 2 * 4 * W * n_pad * grid[0],
            "summary_bytes": 4 * grid[0] * grid[1],
            "hist_bytes": 4 * Q * max(lanes, 1),
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
