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
store's installed epoch with ``KNNEngine.from_epoch``. ``search_sharded``
is not ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

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
        """The QueryPlan ``search`` will execute for these arguments."""
        stats = plan_mod.stats_of(self.codes, q_packed, self.d,
                                  layout=self.layout)
        return plan_mod.plan_local(stats, k, select=select, method=method,
                                   chunk=chunk, force=force)

    def search(self, q_packed: torch.Tensor, k: int,
               chunk: int = plan_mod.DEFAULT_CHUNK,
               method: str = DistanceMethod.XOR, select: str = "auto"):
        """Top-k of ``q_packed`` (Q, W) packed codes, moved to the engine's
        device -> (dists (Q, k) ascending, original ids (Q, k)) int32."""
        if select != "auto":
            plan_mod._warn_legacy("KNNEngine.search", "select", select)
        q = q_packed.to(device=self.device, dtype=torch.int32)
        p = self.query_plan(q, k, chunk=chunk, method=method, select=select)
        return plan_mod.execute(p, q, codes=self.codes, layout=self.layout)
