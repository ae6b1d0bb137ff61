"""Spatial indexing structures (paper §3.4; port of ``repro.core.index``):
hierarchical k-means (IVF), LSH tables, and randomized kd-trees.

Index *traversal* is factored out of the scan engine: it selects candidate
buckets, and the engine scans them. Bucket-contiguous indexes default to
the **masked fused path**: the builder physically reorders the codes by
bucket, traversal translates probed buckets into grid-block ranges, and
the two-pass kernels (K1 + K2) scan ONLY the enabled tiles — no gathered
candidate codes, no bucket-capacity truncation (the layout holds every
member; the capped ``buckets`` table serves the gather path and the mask
of multi-table candidates). The gather scan (``plan.gather_scan``) runs
for ``use_layout=False`` and for the host-traversed kd-trees. kd-tree
construction and traversal run on the host (numpy), the paper's
host/accelerator split; k-means and LSH traversals run on the device.

Masked-path semantics vs gather (core/layout.py): the candidate set is the
probed buckets rounded OUTWARD to data-block boundaries, unioned over each
query block — a superset, so recall never drops; ties at equal distance
break by layout position instead of candidate-list order.

The builders draw their random choices from a ``torch.Generator``
(``repro`` draws them from ``jax.random``, which no torch generator
reproduces); an index built by ``repro`` is carried across whole with
``repro_torch.carry.kmeans_index`` / ``lsh_index``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import binary, layout as layout_mod, plan as plan_mod
from repro_torch.core.quantize import _generator

def _index_stats(codes: torch.Tensor, d: int, layout, n_queries: int, k: int,
                 kind: str, n_buckets: int = 0) -> plan_mod.StoreStats:
    """StoreStats for an index-probed search (shared by every index kind)."""
    return plan_mod.stats_for(codes.shape[0], d, codes.shape[1], n_queries,
                              layout=layout, n_buckets=n_buckets, k=k,
                              index=kind)


def _pad_buckets(assign: np.ndarray, n_buckets: int, cap: int) -> np.ndarray:
    """assign: (N,) bucket of each id -> (n_buckets, cap) int32, -1 padded:
    each bucket's first ``cap`` ids in id order (a stable sort by bucket
    and each id's rank within its bucket)."""
    assign = np.asarray(assign, np.int64)
    order = np.argsort(assign, kind="stable")
    bucket = assign[order]
    counts = np.bincount(assign, minlength=n_buckets)
    starts = np.cumsum(counts) - counts
    rank = np.arange(assign.shape[0]) - starts[bucket]
    keep = rank < cap
    table = np.full((n_buckets, cap), -1, np.int32)
    table[bucket[keep], rank[keep]] = order[keep]
    return table


def _smallest(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Column ids of the m smallest scores per row, ascending, ties by the
    lower id (what ``jax.lax.top_k`` of the negated scores returns)."""
    return torch.argsort(scores, dim=-1, stable=True)[:, :m].to(torch.int32)


def hamming_prefix_probe(q_codes: torch.Tensor, positions: torch.Tensor,
                         n_buckets: int, nprobe: int, d: int) -> torch.Tensor:
    """(Q, W) packed queries -> (Q, nprobe) hamming-prefix bucket ids,
    nearest first.

    A bucket's id IS its key bit pattern (``layout.hamming_prefix_assign``),
    so the probe ranks buckets by the Hamming distance between the query's
    key and each bucket id's low ``bits`` bits: the popcount of their
    XOR. ``positions`` must be the bits the layout was bucketed by."""
    positions = positions.to(q_codes.device).long()
    bits = positions.shape[0]
    qb = binary.unpack_bits(q_codes, d)[:, positions].to(torch.int32)
    weights = 1 << torch.arange(bits, dtype=torch.int32, device=qb.device)
    qkey = (qb * weights).sum(dim=-1, dtype=torch.int32)
    ids = torch.arange(n_buckets, dtype=torch.int32, device=qb.device)
    low = (1 << bits) - 1
    dist = binary.popcount32((qkey[:, None] ^ ids[None, :]) & low)
    return _smallest(dist, min(nprobe, n_buckets))


def _dedup_candidates(cand: torch.Tensor) -> torch.Tensor:
    """Mask repeated ids in a (Q, C) candidate list to -1 (padding),
    keeping the FIRST occurrence (a stable sort by value and an adjacent
    compare), so the surviving tie order is unchanged."""
    order = torch.argsort(cand, dim=-1, stable=True)
    sc = torch.gather(cand, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros_like(sc[:, :1], dtype=torch.bool),
         (sc[:, 1:] == sc[:, :-1]) & (sc[:, 1:] >= 0)], dim=-1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup, -1, cand)


# ---------------------------------------------------------------------------
# hierarchical k-means (IVF)
# ---------------------------------------------------------------------------

class KMeansIndex(NamedTuple):
    centroids: torch.Tensor     # (C, dim) f32
    buckets: torch.Tensor       # (C, cap) int32, -1 padded
    codes: torch.Tensor         # (N, W) packed
    d: int
    layout: Optional[layout_mod.BucketLayout] = None  # cluster-contiguous


def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(n, dim) x (C, dim) -> (n, C) squared L2 distances."""
    return ((x * x).sum(1)[:, None] - 2 * x @ cent.T
            + (cent * cent).sum(1)[None])


def kmeans_build(data: torch.Tensor, codes: torch.Tensor, d: int,
                 n_clusters: int, iters: int = 10,
                 capacity_factor: float = 2.0,
                 generator: Optional[torch.Generator] = None,
                 reorder: bool = True) -> KMeansIndex:
    """Lloyd's k-means on ``data`` from ``n_clusters`` distinct rows drawn
    by ``generator`` (on data's device; default seeded 0), on data's
    device. ``reorder=True`` (default) also builds the cluster-contiguous
    layout so ``kmeans_search`` drives the masked fused kernels."""
    data = data.float()
    n = data.shape[0]
    g = _generator(generator, data.device)
    init = torch.randperm(n, generator=g, device=g.device)[:n_clusters]
    cent = data[init.to(data.device)]
    for _ in range(iters):
        a = torch.argmin(_sq_dists(data, cent), dim=1)
        sums = torch.zeros_like(cent).index_add_(0, a, data)
        counts = torch.bincount(a, minlength=n_clusters)[:n_clusters]
        cent = sums / torch.clamp(counts, min=1).to(sums.dtype)[:, None]
    assign = torch.argmin(_sq_dists(data, cent), dim=1)
    cap = int(np.ceil(capacity_factor * n / n_clusters))
    table = _pad_buckets(assign.cpu().numpy(), n_clusters, cap)
    lay = (layout_mod.reorder_by_assignment(codes, assign, n_clusters)
           if reorder else None)
    return KMeansIndex(centroids=cent,
                       buckets=torch.from_numpy(table).to(codes.device),
                       codes=codes, d=d, layout=lay)


def kmeans_plan(index: KMeansIndex, n_queries: int, k: int, nprobe: int = 1,
                use_layout: bool | None = None) -> plan_mod.QueryPlan:
    """The QueryPlan a ``kmeans_search`` with these arguments executes."""
    stats = _index_stats(index.codes, index.d, index.layout, n_queries, k,
                         "kmeans", n_buckets=index.centroids.shape[0])
    return plan_mod.plan_index(stats, k, kind="kmeans", nprobe=nprobe,
                               use_layout=use_layout)


def _kmeans_probe(index: KMeansIndex, queries: torch.Tensor,
                 nprobe: int = 1) -> torch.Tensor:
    """(Q, dim) queries -> (Q, nprobe) nearest centroid ids, nearest first
    (ties by the lower id)."""
    q = queries.to(index.centroids.device).float()
    return _smallest(_sq_dists(q, index.centroids), nprobe)


def kmeans_search(index: KMeansIndex, queries: torch.Tensor,
                  q_packed: torch.Tensor, k: int, nprobe: int = 1,
                  use_layout: bool | None = None,
                  return_stats: bool = False):
    """Traverse: the nprobe nearest centroids; then scan the union of their
    buckets. With a layout (the default build) the probed buckets become
    an enable mask over the reordered codes and the masked fused kernels
    scan only those tiles, buckets in FULL; ``use_layout=False`` is the
    forced gather over the capped bucket table (also the planner's
    fallback without a layout). ``return_stats`` (masked path only)
    appends the kernel pruning telemetry."""
    if use_layout is not None:
        plan_mod._warn_legacy("kmeans_search", "use_layout", use_layout)
    probe = _kmeans_probe(index, queries, nprobe)
    p = kmeans_plan(index, queries.shape[0], k, nprobe=nprobe,
                    use_layout=use_layout)
    if p.candidates.kind == "block_mask":
        return plan_mod.execute(p, q_packed, layout=index.layout, probe=probe,
                                return_stats=return_stats)
    cand = index.buckets[probe.long()].reshape(queries.shape[0], -1)
    return plan_mod.execute(p, q_packed, codes=index.codes, cand=cand,
                            return_stats=return_stats)


# ---------------------------------------------------------------------------
# LSH tables (bit-sampling over the binary codes)
# ---------------------------------------------------------------------------

class LSHIndex(NamedTuple):
    bit_ids: torch.Tensor       # (T, b) which code bits form each table's key
    buckets: torch.Tensor       # (T, 2^b, cap) int32, -1 padded
    codes: torch.Tensor         # (N, W)
    d: int
    layout: Optional[layout_mod.BucketLayout] = None  # table-0-contiguous


def _hash_codes(codes_bits: torch.Tensor, bit_ids: torch.Tensor
                ) -> torch.Tensor:
    """codes_bits: (N, d) {0,1}; bit_ids: (T, b) -> keys (T, N) int32."""
    sel = codes_bits[:, bit_ids.long()].to(torch.int32)       # (N, T, b)
    weights = 1 << torch.arange(bit_ids.shape[1], dtype=torch.int32,
                                device=sel.device)
    return (sel * weights).sum(dim=-1, dtype=torch.int32).T


def lsh_build(codes: torch.Tensor, d: int, n_tables: int = 4,
              bits_per_table: int = 12, capacity_factor: float = 4.0,
              generator: Optional[torch.Generator] = None,
              reorder: bool = True) -> LSHIndex:
    """Bit-sampling LSH: each table keys codes by ``bits_per_table``
    distinct code bits drawn by ``generator`` (on the codes' device;
    default seeded 0)."""
    if bits_per_table > d:
        raise ValueError(f"bits_per_table={bits_per_table} > d={d}")
    g = _generator(generator, codes.device)
    # bits WITHOUT replacement per table: a duplicate bit id would hash on
    # fewer than b distinct bits and silently lose key entropy
    bit_ids = torch.stack([
        torch.randperm(d, generator=g, device=g.device)[:bits_per_table]
        for _ in range(n_tables)]).to(device=codes.device, dtype=torch.int32)
    return _lsh_from_bit_ids(codes, d, bit_ids, capacity_factor, reorder)


def _lsh_from_bit_ids(codes: torch.Tensor, d: int, bit_ids: torch.Tensor,
                      capacity_factor: float = 4.0,
                      reorder: bool = True) -> LSHIndex:
    """The tables and layout of an LSH index whose key bits are given."""
    n = codes.shape[0]
    keys = _hash_codes(binary.unpack_bits(codes, d), bit_ids)   # (T, N)
    n_buckets = 1 << bit_ids.shape[1]
    cap = int(np.ceil(capacity_factor * n / n_buckets))
    keys_np = keys.cpu().numpy()
    tables = np.stack([_pad_buckets(keys_np[t], n_buckets, cap)
                       for t in range(bit_ids.shape[0])])
    # only ONE table can be layout-contiguous; cluster by table 0's key —
    # its probes become block RANGES, the other tables' members enable the
    # blocks that hold them (layout.position_block_mask)
    lay = (layout_mod.reorder_by_assignment(codes, keys[0], n_buckets)
           if reorder else None)
    return LSHIndex(bit_ids=bit_ids,
                    buckets=torch.from_numpy(tables).to(codes.device),
                    codes=codes, d=d, layout=lay)


def lsh_plan(index: LSHIndex, n_queries: int, k: int,
             use_layout: bool | None = None) -> plan_mod.QueryPlan:
    """The QueryPlan an ``lsh_search`` with these arguments executes."""
    stats = _index_stats(index.codes, index.d, index.layout, n_queries, k,
                         "lsh", n_buckets=index.buckets.shape[1])
    return plan_mod.plan_index(stats, k, kind="lsh",
                               n_tables=index.bit_ids.shape[0],
                               use_layout=use_layout)


def lsh_search(index: LSHIndex, q_packed: torch.Tensor, k: int,
               use_layout: bool | None = None, return_stats: bool = False):
    """Probe one bucket per table, then select over the union.

    Masked path (the default with a layout): table 0's bucket is a
    contiguous block range of the reordered codes; tables 1..T-1 enable
    the blocks that hold their (capped) members, so every enabled row is
    scanned exactly once. Gather path: the candidate lists are deduped so
    a multi-table repeat cannot occupy several top-k slots."""
    if use_layout is not None:
        plan_mod._warn_legacy("lsh_search", "use_layout", use_layout)
    q = q_packed.to(index.codes.device)
    keys = _hash_codes(binary.unpack_bits(q, index.d),
                       index.bit_ids).long()                   # (T, Q)
    T = index.bit_ids.shape[0]
    p = lsh_plan(index, q.shape[0], k, use_layout=use_layout)
    if p.candidates.kind == "block_mask":
        others = torch.cat(
            [index.buckets[t][keys[t]] for t in range(1, T)],
            dim=-1) if T > 1 else None                     # (Q, (T-1)*cap)
        return plan_mod.execute(p, q, layout=index.layout,
                                probe=keys[0][:, None], cand_ids=others,
                                return_stats=return_stats)
    cand = torch.cat([index.buckets[t][keys[t]] for t in range(T)], dim=-1)
    return plan_mod.execute(p, q, codes=index.codes,
                            cand=_dedup_candidates(cand),
                            return_stats=return_stats)


# ---------------------------------------------------------------------------
# randomized kd-trees (host build + host traversal, device scan)
# ---------------------------------------------------------------------------

class KDTreeIndex:
    """Forest of randomized kd-trees over the float vectors. Median splits
    on a dim sampled from the top-variance dims (FLANN-style). Host numpy,
    the same code as ``repro``'s: with the same ``seed`` both build the
    same trees."""

    def __init__(self, data: np.ndarray, codes, d: int, n_trees: int = 4,
                 leaf_size: int = 512, top_dims: int = 8, seed: int = 0):
        self.codes = codes
        self.d = d
        self.data = np.asarray(data, np.float32)
        self.rng = np.random.default_rng(seed)
        variances = self.data.var(axis=0)
        self.top_dims = np.argsort(-variances)[:top_dims]
        self.leaf_size = leaf_size
        self.trees = [self._build(np.arange(len(self.data)))
                      for _ in range(n_trees)]

    def _build(self, ids: np.ndarray):
        if len(ids) <= self.leaf_size:
            return ("leaf", ids.astype(np.int32))
        dim = int(self.rng.choice(self.top_dims))
        vals = self.data[ids, dim]
        median = float(np.median(vals))
        left = ids[vals <= median]
        right = ids[vals > median]
        if len(left) == 0 or len(right) == 0:          # degenerate split
            return ("leaf", ids.astype(np.int32))
        return ("node", dim, median, self._build(left), self._build(right))

    def _traverse(self, node, q: np.ndarray) -> np.ndarray:
        while node[0] == "node":
            _, dim, median, l, r = node
            node = l if q[dim] <= median else r
        return node[1]

    def _candidates(self, queries: np.ndarray) -> np.ndarray:
        """(Q, n_trees * leaf_size) int32 candidate ids per query: the
        sorted union of its leaves, -1 padded."""
        queries = np.asarray(queries, np.float32)
        cap = self.leaf_size * len(self.trees)
        cand = np.full((len(queries), cap), -1, np.int32)
        for qi, q in enumerate(queries):
            ids = np.unique(np.concatenate(
                [self._traverse(t, q) for t in self.trees]))[:cap]
            cand[qi, :len(ids)] = ids
        return cand

    def search(self, queries: np.ndarray, q_packed, k: int):
        """Host traversal per tree -> device scan of the candidate union."""
        cand = self._candidates(queries)
        stats = _index_stats(self.codes, self.d, None, len(cand), k,
                             "kdtree")
        p = plan_mod.plan_index(stats, k, kind="kdtree",
                                n_tables=len(self.trees))
        return plan_mod.execute(p, q_packed, codes=self.codes,
                                cand=torch.from_numpy(cand))
