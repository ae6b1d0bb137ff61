"""The kNN engine (port of the single-device half of ``repro.core.engine``):
every search is a thin plan-builder over the QueryPlan IR (core/plan.py) —
the planner resolves the stages, the executor runs them.

``select="fused"`` configures the WHOLE datastore at once, as the paper's
automata processor does before a race: one K1 + one K2 launch own all of N,
with block-min pruning skipping pass-2 tiles that provably hold no winner.
``select="fused_scan"`` keeps the chunked variant; the materializing selects
(composite, counting, bisect) scan one chunk of codes per step with an O(k)
running merge.

The engine runs on the device its tensors live on; build one from
``repro``'s numpy state with ``repro_torch.carry``, or pin one to a mutable
store's installed epoch with ``KNNEngine.from_epoch``.

``search_sharded`` runs on every rank of a ``torch.distributed`` device
mesh (SPMD), each over the slice of rows ``shard_datastore`` gave it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod, spans
from repro_torch.core import layout as layout_mod, plan as plan_mod

DistanceMethod = plan_mod.DistanceMethod
_auto_chunk = plan_mod._auto_chunk


def search_chunked(codes_packed: torch.Tensor, q_packed: torch.Tensor, k: int,
                   d: int, chunk: int = plan_mod.DEFAULT_CHUNK,
                   method: str = DistanceMethod.XOR, id_offset=0,
                   select: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search the datastore. codes: (N, W) int32, q: (Q, W), on one device.

    ``select``: 'auto' (planner-resolved; with no layout it lands on the
    composite-key path), or a forced path: 'counting', 'bisect', 'fused'
    (single-shot two-pass select with block-min pruning), 'fused_scan'
    (the chunk-scanned variant of 'fused'). All paths produce bit-identical
    results at any chunk size.
    Returns (dists (Q,k) ascending, global ids (Q,k))."""
    if select != "auto":
        plan_mod._warn_legacy("search_chunked", "select", select)
    p = plan_mod.plan_local(plan_mod.stats_of(codes_packed, q_packed, d),
                            k, select=select, method=method, chunk=chunk)
    return plan_mod.execute(p, q_packed, codes=codes_packed,
                            id_offset=id_offset)


class KNNEngine(NamedTuple):
    """Immutable engine state: packed codes on a device, plus an optional
    bucket-clustered layout (core/layout.py). Any select that RESOLVES to
    the fused path streams the REORDERED codes and maps winners back to
    original ids; the materializing selects scan the original order."""

    codes: torch.Tensor       # (N, W) int32 packed
    d: int                    # code bits
    layout: Optional[layout_mod.BucketLayout] = None

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @classmethod
    def from_epoch(cls, epoch, d: int) -> "KNNEngine":
        """Engine pinned to one installed epoch of a mutable store
        (core/mutable.py). The epoch's dense codes ARE the layout's codes
        (identity perm), so this engine keeps serving a complete,
        consistent snapshot however the store mutates afterwards."""
        return cls(codes=epoch.layout.codes, d=d, layout=epoch.layout)

    def with_layout(self, n_buckets: int | None = None,
                    assign: torch.Tensor | None = None) -> "KNNEngine":
        """Engine with a bucket-clustered layout: by explicit bucket
        ``assign`` (e.g. IVF cluster ids) or the pure-Hamming prefix
        fallback. Built on the engine's device."""
        lay = layout_mod.build_layout(self.codes, self.d,
                                      n_buckets=n_buckets, assign=assign)
        return self._replace(layout=lay)

    def query_plan(self, q_packed: torch.Tensor, k: int,
                   chunk: int = plan_mod.DEFAULT_CHUNK,
                   method: str = DistanceMethod.XOR, select: str = "auto",
                   force=None) -> plan_mod.QueryPlan:
        """The QueryPlan ``search`` will execute for these arguments
        (span ``spans.PLAN``)."""
        with spans.span(spans.PLAN):
            stats = plan_mod.stats_of(self.codes, q_packed, self.d,
                                      layout=self.layout)
            return plan_mod.plan_local(stats, k, select=select,
                                       method=method, chunk=chunk,
                                       force=force)

    def search(self, q_packed: torch.Tensor, k: int,
               chunk: int = plan_mod.DEFAULT_CHUNK,
               method: str = DistanceMethod.XOR, select: str = "auto"):
        """Top-k of ``q_packed`` (Q, W) packed codes, moved to the engine's
        device -> (dists (Q, k) ascending, original ids (Q, k)) int32.
        Marked by the span ``spans.SEARCH`` (numbered by call) while a
        profiler records."""
        with spans.span(spans.SEARCH):
            if select != "auto":
                plan_mod._warn_legacy("KNNEngine.search", "select", select)
            q = q_packed.to(device=self.device, dtype=torch.int32)
            p = self.query_plan(q, k, chunk=chunk, method=method,
                                select=select)
            return plan_mod.execute(p, q, codes=self.codes,
                                    layout=self.layout)


# ---------------------------------------------------------------------------
# distributed search (hierarchical top-k == statistical activation reduction)
# ---------------------------------------------------------------------------

def search_sharded(codes_packed, q_packed, k: int, d: int, mesh,
                   axes: Sequence[str], k_local: Optional[int] = None,
                   chunk: int = plan_mod.DEFAULT_CHUNK,
                   method: str = DistanceMethod.XOR, select: str = "auto",
                   reorder_local: bool = False, merge: Optional[str] = None,
                   fanout: int = 0, shard_n_valid=None,
                   shard_participate=None, device=None):
    """Datastore sharded over ``axes`` of a ``torch.distributed`` device
    mesh (cardinality sharding); queries replicated. Every rank of the mesh
    calls it with its own slice ``codes_packed`` (n_loc, W) — as
    ``shard_datastore`` hands it out — and the same ``q_packed``; every
    rank gets the whole (dists (Q, k), ids (Q, k)) answer, ids global. Both
    inputs move to ``device`` — CUDA unless ``device="cpu"``. A thin
    plan-builder: the planner decides the merge strategy, the executor runs
    it.

    The exact default (k_local == k) is the **distributed counting
    select** (``merge="hist_merge"``): per-shard pass-1 histograms are
    additive partial histograms of one global race, so one reduction of
    the tiny (Q, bins) counts yields ONE global per-query radius r*; each
    shard then runs pass 2 over its own slice with slot bases from an
    exclusive scan of per-shard below-r*/tie counts and writes its winners
    into disjoint slots of the global (Q, k) output, assembled by a final
    reduction — one K1 and one K2 launch per rank. ``merge="concat_sort"``
    forces the legacy hierarchical merge (each shard reports its local
    top-k', one gathered sort); k_local < k always takes it — the
    statistical reduction of core/hierarchy.py (inexact, bounded).

    ``reorder_local=True`` (fused or approx only): each shard re-sorts its
    own slice by a static Hamming key (``layout.local_sort``) before the
    scan and maps winners back to global ids. ``shard_n_valid``: optional
    (n_shards,) valid-row counts for UNEVEN shards padded to a common
    slice size (results bit-identical to a single-device search over the
    concatenation of the valid rows). ``merge="hist_tree"`` (auto past 8
    shards) runs the SAME counting select with the reductions
    tree-scheduled at ``fanout``. ``shard_participate``: optional
    (n_shards,) 0/1 liveness mask (hist-family merges only) — dead
    shards' rows are excluded exactly and ids renumber over the survivors.
    """
    dev = device_mod.resolve(device)
    if select != "auto":
        plan_mod._warn_legacy("search_sharded", "select", select)
    from repro_torch.kernels import ops

    axes = tuple(axes)
    codes = as_codes(codes_packed, dev)
    q = as_codes(q_packed, dev)
    n_dev = ops.n_shards_of(mesh, axes)
    stats = plan_mod.stats_for(codes.shape[0] * n_dev, d, codes.shape[1],
                               q.shape[0], n_shards=n_dev)
    p = plan_mod.plan_sharded(stats, k, axes=axes, k_local=k_local,
                              select=select, method=method, chunk=chunk,
                              reorder_local=reorder_local, merge=merge,
                              fanout=fanout,
                              uneven=shard_n_valid is not None)
    return plan_mod.execute(p, q, codes=codes, mesh=mesh,
                            shard_n_valid=shard_n_valid,
                            shard_participate=shard_participate)


def as_codes(a, dev) -> torch.Tensor:
    """Packed codes (a tensor, or a uint32/int32 array: same bits) as an
    int32 tensor on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype not in (np.uint32, np.int32):
            raise TypeError(f"packed codes must be uint32 or int32, got "
                            f"{a.dtype}")
        a = torch.from_numpy(a.view(np.int32).copy())
    return a.to(device=dev, dtype=torch.int32)


def shard_datastore(codes_packed, mesh, axes: Sequence[str], device=None
                    ) -> torch.Tensor:
    """This rank's contiguous slice of a packed (N, W) datastore, on
    ``device`` — CUDA unless ``device="cpu"``: rows [f·N/S, (f+1)·N/S) for
    flat shard index f over ``axes`` (row-major, as the mesh) of S shards,
    the order the sharded select numbers ids in. N must divide evenly (pad
    uneven stores to a common slice and pass ``shard_n_valid``)."""
    from repro_torch.kernels import ops

    dev = device_mod.resolve(device)
    axes = tuple(axes)
    n_dev = ops.n_shards_of(mesh, axes)
    n = codes_packed.shape[0]
    if n % n_dev:
        raise ValueError(f"{n} rows do not split evenly over {n_dev} shards")
    n_loc = n // n_dev
    lo = ops.flat_index(mesh, axes) * n_loc
    return as_codes(codes_packed[lo:lo + n_loc], dev)
