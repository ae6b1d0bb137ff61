"""Host-orchestrated shard-fault-tolerant distributed search (port of
``repro.dist.search``).

The SPMD path (``ops.hamming_topk_sharded`` over a device mesh) assumes
every participant answers every collective — the right model for one healthy
mesh, the wrong one for a fleet of independent near-data units (the
paper's AP ranks, Pohoiki Springs' ~100k cores) where units stall, die
and come back mid-stream. This module runs the SAME two-pass counting
select with the host as the merge fabric, so any unit can drop out
between any two steps:

1. **hist** — every covered row range runs pass 1 on its serving unit
   (``dist/steps.unit_search_steps``; fault site ``shard_hist``,
   per-call deadline -> ``HealthRegistry.observe``). A failed unit fails
   over to the next replica holder of the same range (``ReplicaMap``,
   primary-first ring order); a range with no live holder drops out of
   coverage.
2. **merge** — the partial histograms reduce hierarchically on the host
   in ``fanout``-wide rounds (site ``merge_psum``, retried under the
   request's remaining deadline via ``faults.retry_call``): the
   hist_tree schedule, host edition. Integer sums -> any grouping is
   bit-identical to the flat sum.
3. **radius** — ONE global per-query r* via ``ops._radius_from_cum``,
   the same definition every other select uses.
4. **emit** — each covered range reports its local top-min(k, n_range)
   (site ``shard_emit``, same failover). Any global winner inside a
   range is inside that range's local top-k, so this is lossless.
5. **assemble** — candidates filter to dist <= r*, sort lexicographically
   by (dist, original global id) and cut at k_eff; surplus slots pad
   with (bins, total_rows) sentinels.

The answer is **degraded but exact**: bit-identical distances — and ids
equal through the canonical covered-row id map — to a from-scratch
``ops.hamming_topk`` over exactly the surviving rows, and every response
carries a ``CoverageReport`` saying precisely what was searched. If
coverage shrinks between hist and emit (a range lost its last holder
mid-query) the query RESTARTS over the new surviving set — the merged
radius of a larger store is not valid for a smaller one — bounded by the
unit count, so a request is never lost and never silently under-reported.

Replication (factor R) is ``dist/sharding.ReplicaMap``'s chained
placement; ``maintain()`` does bounded background re-replication (restore
factor R among the living, refill revived-empty units, promote
``recovering -> healthy`` when a unit's nominal ranges are back).

Each unit's ranges are tensors on the search's device (CUDA unless
``device="cpu"``): on one card the units share it, as units share a host
in ``repro``. Each unit's hist is one K1 launch and its top-k one K1 and
one K2; the merge, the radius and the assembly run on the host in numpy.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.engine import as_codes
from repro_torch.dist import steps as steps_mod
from repro_torch.dist.health import CoverageReport, HealthRegistry
from repro_torch.dist.sharding import ReplicaMap
from repro_torch.runtime import faults as faults_mod

_ID_BITS = 32          # (dist << 32 | gid) sort keys; gid < 2**31 always


class _CoverageChanged(Exception):
    """A range lost its last holder mid-query: restart over the new set."""


def _even_counts(n_rows: int, n_units: int) -> List[int]:
    base, rem = divmod(n_rows, n_units)
    return [base + (1 if i < rem else 0) for i in range(n_units)]


class FaultTolerantSearch:
    """Shard-fault-tolerant k-NN over one packed code store.

    ``codes_packed``: (N, W) packed codes; rows split into ``n_units``
    contiguous primary ranges (uneven allowed via ``counts``), replicated
    at ``factor`` by ``ReplicaMap``'s ring placement. ``injector``: the
    seeded ``FaultInjector`` whose ``shard_hist``/``shard_emit``/
    ``merge_psum`` sites (scoped ``site@unit``) this layer honors.
    ``fanout``: host merge-tree width (0 -> ``tuning.merge_fanout``).
    ``device``: where every unit's ranges live — CUDA unless
    ``device="cpu"``.
    """

    def __init__(self, codes_packed, d: int, *, n_units: int = 4,
                 counts: Optional[Sequence[int]] = None,
                 factor: int = 1,
                 registry: Optional[HealthRegistry] = None,
                 injector: Optional[faults_mod.FaultInjector] = None,
                 fanout: int = 0,
                 deadline_s: float = 0.25,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        self.device = device_mod.resolve(device)
        codes = as_codes(codes_packed, self.device)
        if counts is None:
            counts = _even_counts(codes.shape[0], n_units)
        if sum(counts) != codes.shape[0]:
            raise ValueError(f"counts {counts} do not cover "
                             f"{codes.shape[0]} rows")
        units = [f"unit{i}" for i in range(len(counts))]
        self.d = int(d)
        self.bins = self.d + 1
        self.map = ReplicaMap(tuple(counts), tuple(units), factor=factor)
        self.registry = registry or HealthRegistry(units,
                                                   deadline_s=deadline_s)
        self.injector = injector
        self.clock = clock
        if fanout < 2:
            from repro_torch.kernels import tuning
            fanout = tuning.merge_fanout(len(units)) or 2
        self.fanout = int(fanout)
        # nominal placement -> actual possession: every holder gets a
        # device copy of each range it holds (the replica IS the failover)
        self._data: Dict[str, Dict[int, torch.Tensor]] = {
            u: {} for u in units}
        self._held: Dict[str, set] = {u: set() for u in units}
        for i in range(self.map.n_units):
            lo, hi = self.map.range_bounds(i)
            block = codes[lo:hi].clone()
            for u in self.map.holders(i):
                self._data[u][i] = block
                self._held[u].add(i)
        self.counters = {"failovers": 0, "restarts": 0, "rebuilt_ranges": 0,
                         "searches": 0, "degraded_searches": 0}

    # -- fault plumbing ----------------------------------------------------

    def _check(self, site: str, unit: str) -> None:
        if self.injector is not None:
            self.injector.check(site, unit)

    def _call_unit(self, site: str, range_idx: int, fn_for,
                   serving: set) -> Optional[Tuple[str, object]]:
        """Run ``fn_for(unit)`` on the range's serving holder, failing over
        through the replica chain as the registry declares units dead.
        Every attempt is deadline-timed into the registry — persistent
        failures walk a unit healthy -> suspect -> dead, which is exactly
        what reroutes the range to its next holder. Returns (unit, result)
        or None when no live holder remains (coverage change)."""
        tried_dead = set()
        while True:
            unit = self.map.owner(range_idx, serving - tried_dead,
                                  held=self._held)
            if unit is None:
                return None
            while True:
                t0 = self.clock()
                try:
                    self._check(site, unit)
                    out = fn_for(unit)
                    self.registry.observe(unit, True, self.clock() - t0)
                    return unit, out
                except faults_mod.TRANSIENT:
                    state = self.registry.observe(unit, False,
                                                  self.clock() - t0)
                    if state not in ("healthy", "suspect"):
                        # the registry gave up on this unit: fail the
                        # range over to its next live holder
                        tried_dead.add(unit)
                        self.counters["failovers"] += 1
                        break
                    # still serving (below dead_after): retry in place

    # -- the five steps ----------------------------------------------------

    def _merge_hists(self, hists: List[np.ndarray],
                     deadline_left: Optional[float]) -> np.ndarray:
        """Host edition of the hist_tree reduction: ``fanout``-wide rounds
        of integer sums, each round's group guarded by the ``merge_psum``
        site and retried inside the remaining request deadline."""
        level = 0
        while len(hists) > 1:
            nxt = []
            for g0 in range(0, len(hists), self.fanout):
                group = hists[g0:g0 + self.fanout]

                def merge_group(level=level, g0=g0, group=group):
                    self._check("merge_psum", f"l{level}g{g0}")
                    return sum(group[1:], group[0].copy())

                nxt.append(faults_mod.retry_call(
                    merge_group, retries=4, backoff_s=1e-4,
                    deadline_s=deadline_left, sleep=lambda s: None))
            hists = nxt
            level += 1
        return hists[0]

    def search(self, q_packed, k: int,
               deadline_s: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray, CoverageReport]:
        """(dists (Q, k), ids (Q, k) in the ORIGINAL global row space,
        CoverageReport). Exact over the covered rows; ids of excluded rows
        never appear; surplus slots carry (bins, total_rows) sentinels."""
        from repro_torch.kernels import ops

        q = as_codes(q_packed, self.device)
        Q = q.shape[0]
        t_start = self.clock()
        self.counters["searches"] += 1

        def left() -> Optional[float]:
            if deadline_s is None:
                return None
            return max(deadline_s - (self.clock() - t_start), 0.0)

        for _restart in range(self.map.n_units + 1):
            try:
                return self._search_once(ops, q, Q, int(k), left)
            except _CoverageChanged:
                self.counters["restarts"] += 1
                continue
        raise RuntimeError("coverage changed more times than there are "
                           "units — registry is thrashing")

    def _search_once(self, ops, q, Q: int, k: int, left):
        serving = set(self.registry.serving())
        assignment = self.map.assignment(serving, held=self._held)
        covered = sorted(assignment)
        covered_total = sum(self.map.counts[i] for i in covered)
        report = CoverageReport(
            covered_rows=covered_total, total_rows=self.map.total_rows,
            dead_shards=tuple(sorted(self.registry.not_serving())))
        if not report.complete:
            self.counters["degraded_searches"] += 1
        if covered_total == 0 or k == 0:
            return (np.full((Q, k), self.bins, np.int32),
                    np.full((Q, k), self.map.total_rows, np.int32), report)
        k_k = min(k, covered_total)

        # 1. per-range pass-1 histograms on the serving holders
        hists = []
        for i in covered:
            hist_fn, _ = steps_mod.unit_search_steps(self.bins, k_k)
            got = self._call_unit(
                "shard_hist", i,
                lambda u, i=i, f=hist_fn: f(q, self._data[u][i]).cpu().numpy(),
                serving)
            if got is None:
                raise _CoverageChanged(f"range {i} lost during hist")
            hists.append(got[1].astype(np.int64))

        # 2.+3. hierarchical host merge -> the ONE global radius
        hist_glob = self._merge_hists(hists, left())
        cum = np.cumsum(hist_glob, axis=-1)
        k_eff, r_star, n_lt, n_emit = (
            v.numpy() for v in ops._radius_from_cum(torch.from_numpy(cum),
                                                    k_k))

        # 4. per-range emit: local top-min(k, n_range) in original gids
        cand_d, cand_g = [], []
        for i in covered:
            k_loc = min(k, self.map.counts[i])
            _, topk_fn = steps_mod.unit_search_steps(self.bins, k_loc)
            got = self._call_unit(
                "shard_emit", i,
                lambda u, i=i, f=topk_fn: tuple(
                    a.cpu().numpy() for a in f(q, self._data[u][i])),
                serving)
            if got is None:
                raise _CoverageChanged(f"range {i} lost during emit")
            ld, li = got[1]
            cand_d.append(ld)
            cand_g.append(li + self.map.range_bounds(i)[0])

        # 5. host assembly: filter to r*, (dist, gid)-lexicographic cut
        d_all = np.concatenate(cand_d, axis=1).astype(np.int64)
        g_all = np.concatenate(cand_g, axis=1).astype(np.int64)
        keep = d_all <= r_star[:, None]
        key = np.where(keep, (d_all << _ID_BITS) | g_all,
                       np.iinfo(np.int64).max)
        key.sort(axis=1)
        key = key[:, :k_k]
        out_d = (key >> _ID_BITS).astype(np.int32)
        out_g = (key & ((np.int64(1) << _ID_BITS) - 1)).astype(np.int32)
        live = np.arange(k_k, dtype=np.int32)[None, :] < n_emit[:, None]
        out_d = np.where(live, out_d, self.bins).astype(np.int32)
        out_g = np.where(live, out_g, self.map.total_rows).astype(np.int32)
        if k_k < k:
            pad_d = np.full((Q, k - k_k), self.bins, np.int32)
            pad_g = np.full((Q, k - k_k), self.map.total_rows, np.int32)
            out_d = np.concatenate([out_d, pad_d], axis=1)
            out_g = np.concatenate([out_g, pad_g], axis=1)
        report = CoverageReport(
            covered_rows=sum(self.map.counts[i] for i in covered),
            total_rows=self.map.total_rows,
            dead_shards=tuple(sorted(self.registry.not_serving())))
        return out_d, out_g, report

    # -- lifecycle ---------------------------------------------------------

    def kill(self, unit: str) -> None:
        """Hard-kill mid-stream: the unit stops serving NOW. Its device
        copies stay addressable (a warm corpse) so a later warm revive or
        an anti-entropy rebuild can copy from it only after revive."""
        self.registry.kill(unit)

    def revive(self, unit: str, with_data: bool = True) -> None:
        """The unit process is back: dead -> recovering. ``with_data=False``
        models a cold replacement (disk gone) — possession resets and
        ``maintain()`` must refill every range before it serves again."""
        if not with_data:
            self._data[unit] = {}
            self._held[unit] = set()
        self.registry.revive(unit)

    def coverage(self) -> CoverageReport:
        """What a search issued right now would cover."""
        serving = set(self.registry.serving())
        return CoverageReport(
            covered_rows=self.map.covered_rows(serving, held=self._held),
            total_rows=self.map.total_rows,
            dead_shards=tuple(sorted(self.registry.not_serving())))

    def covered_ranges(self) -> Tuple[int, ...]:
        """Range indices a search issued right now would cover (sorted) —
        the coverage SIGNATURE the server keys its degraded store view by."""
        serving = set(self.registry.serving())
        return tuple(sorted(self.map.assignment(serving, held=self._held)))

    def covered_row_ids(self) -> np.ndarray:
        """Original global row ids currently covered, ascending — exactly
        the rows a degraded answer searches (and the reference oracle's
        ``covered_row_ids`` argument)."""
        ranges = self.covered_ranges()
        if not ranges:
            return np.empty(0, np.int64)
        return np.concatenate([np.arange(*self.map.range_bounds(i))
                               for i in ranges]).astype(np.int64)

    def maintain(self, budget: Optional[int] = None) -> dict:
        """One bounded background-maintenance pass: re-replicate
        under-replicated ranges among the living (recovering units refill
        their nominal ranges first), then promote any recovering unit
        whose nominal set is whole. ``budget`` caps range copies per call
        so maintenance never starves serving."""
        alive = set(self.registry.serving()) | {
            u for u in self.map.units
            if self.registry.state(u) == "recovering"}
        work = self.map.rebuild_targets(alive, held=self._held)
        copied = 0
        for i, src, tgt in work:
            if budget is not None and copied >= budget:
                break
            self._data[tgt][i] = self._data[src][i]
            self._held[tgt].add(i)
            copied += 1
        self.counters["rebuilt_ranges"] += copied
        recovered = []
        for u in self.map.units:
            if (self.registry.state(u) == "recovering"
                    and set(self.map.held_by(u)) <= self._held[u]):
                self.registry.mark_recovered(u)
                recovered.append(u)
        return {"copied": copied, "pending": len(work) - copied,
                "recovered": recovered,
                "coverage_frac": self.coverage().coverage_frac}

    def stats(self) -> dict:
        cov = self.coverage()
        return {
            "registry": self.registry.snapshot(),
            "replication": {
                "factor": self.map.factor,
                "n_units": self.map.n_units,
                "fanout": self.fanout,
                "held": {u: sorted(h) for u, h in self._held.items()},
                "under_replicated": len(self.map.rebuild_targets(
                    set(self.registry.serving()), held=self._held)),
            },
            "coverage": cov.as_dict(),
            "counters": dict(self.counters),
        }


def reference_over_covered(codes_packed, q_packed, k: int, d: int,
                           covered_row_ids: np.ndarray, device=None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The from-scratch oracle a degraded answer must match bit-for-bit:
    ``ops.hamming_topk`` over ONLY the covered rows, on ``device`` (CUDA
    unless ``device="cpu"``), with winners mapped back to original global
    ids and sentinels at the original total."""
    from repro_torch.kernels import ops

    dev = device_mod.resolve(device)
    codes = as_codes(codes_packed, dev)
    q = as_codes(q_packed, dev)
    m = np.asarray(covered_row_ids, np.int64)
    total = codes.shape[0]
    Q = q.shape[0]
    if m.size == 0:
        return (np.full((Q, k), d + 1, np.int32),
                np.full((Q, k), total, np.int32))
    rd, ri = ops.hamming_topk(q, codes[torch.from_numpy(m).to(dev)], k,
                              d + 1)
    rd, ri = rd.cpu().numpy(), ri.cpu().numpy()
    ids = np.where(ri < m.size, m[np.minimum(ri, max(m.size - 1, 0))], total)
    return rd.astype(np.int32), ids.astype(np.int32)


__all__ = ["FaultTolerantSearch", "reference_over_covered"]
