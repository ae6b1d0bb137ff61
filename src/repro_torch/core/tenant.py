"""Multi-tenant datastore (port of ``repro.core.tenant``): many mutable
stores packed into ONE physical arena, searched by ONE fused kernel pair
(one K1 and one K2 launch), isolated everywhere else.

The AP answers "millions of users" by pointing many small automata at one
shared data stream; TPU-KNN's economics are the same — the win is one
kernel launch serving the whole batch, not one launch per user. Our
analogue packs every tenant's installed epoch into one bn-tile-aligned
codes array and turns tenancy into a *block mask*: the query blocks of
tenant ``t`` enable exactly the grid tiles of ``t``'s region, so a
mixed-tenant batch runs through the UNCHANGED two-pass kernels
(kernels/topk_select.py) and each query's top-k is taken over its own
tenant's rows only — bit-identical to searching that tenant's
``MutableStore`` alone (pinned in tests/test_torch_tenant.py).

Exactness under packing (the pad-row accounting)
------------------------------------------------
A region is its tenant's epoch rows followed by ``cap - n`` pad rows of
all-ones codes, so regions stay bn-aligned without touching the kernels'
``n_valid`` contract (n_valid is a global row *suffix*; interior pads are
not). Pads are instead corrected exactly on the host between the two
passes. Both kernels clamp every distance to ``bins - 1``, so a pad row's
distance to query ``q`` is the known scalar

    b_pad(q) = min(32*W - popcount(q), bins - 1)

and the per-query histogram is corrected by subtracting the region's pad
count at that one bin before the radius derivation
(``ops._radius_from_cum``). In pass 2 pads DO emit, but they sit at the
region tail — after every real row in scan order — so real below-radius
rows occupy slots ``[0, n_lt)`` and real ties start at the tie base
``n_lt + p_lt`` exactly; a slot budget of ``k + max_pad`` plus a gather
that skips the pad-occupied slot ranges reconstructs the per-tenant slot
sequence, and the same stable sort as ``ops._finalize_slots`` finishes
the contract.

Pass 2 splits over runs of tiles, as the main path's does
(``ops.hamming_topk``): K1 also returns each run's histogram, and each
(query, run)'s pad count is subtracted from its run histogram at
``b_pad`` before ``ops._run_bases`` scans them into slot bases. A
region's pads are fewer than ``bn``, so they lie in the region's last
tile, hence in the last run that holds any of the query's enabled tiles:
every run's bases are those of the single-run emit, which
``search(emit="single")`` runs (``slot_base`` 0, tie base
``n_lt + p_lt``) as the check of the split form.

Blast radius
------------
Each tenant is a full :class:`~repro.core.mutable.MutableStore` under its
own WAL namespace (``wal.namespace_root``): its own intent log, its own
snapshots, its own fault sites (``site@tenant``). ``recover()`` triages
every namespace with ``wal.verify`` first — interior corruption (acked
records stranded past a bad frame) quarantines THAT tenant and no other;
a torn tail recovers normally; transient recovery faults retry bounded.
A quarantined tenant is excluded from packing, admission, and search;
every healthy tenant keeps serving.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import wal as wal_mod
from repro_torch.core import binary, mutable as mutable_mod
from repro_torch.runtime import faults as faults_mod

HEALTHY = "healthy"
QUARANTINED = "quarantined"


class TenantQuarantined(RuntimeError):
    """The addressed tenant is quarantined (its data is intact on disk but
    its namespace failed verification or recovery)."""

    def __init__(self, tid: str, error: Optional[str] = None):
        super().__init__(f"tenant {tid!r} is quarantined: {error}")
        self.tid = tid


class TenantQuota(NamedTuple):
    """Per-tenant admission limits; ``None`` = unlimited. ``max_rows``
    bounds live rows, ``max_pending`` bounds acked-but-unsearchable
    backlog, ``max_mutations_per_tick`` is the fair-share rate the server
    enforces per scheduling tick."""

    max_rows: Optional[int] = None
    max_pending: Optional[int] = None
    max_mutations_per_tick: Optional[int] = None


@dataclasses.dataclass
class Tenant:
    tid: str
    store: Optional[mutable_mod.MutableStore]
    quota: TenantQuota
    status: str = HEALTHY
    error: Optional[str] = None


class PackedEpoch(NamedTuple):
    """One immutable packed view over every healthy tenant's installed
    epoch. ``regions[tid] = (start, n_real, cap)`` with ``start``/``cap``
    bn-multiples; rows ``[start + n_real, start + cap)`` are all-ones
    pads with ``ext_ids == -1``."""

    seq: int
    codes: torch.Tensor                     # (N, W) int32, bn-aligned
    ext_ids: np.ndarray                     # (N,) int64; -1 on pad rows
    regions: Dict[str, Tuple[int, int, int]]
    tenant_epochs: Dict[str, int]           # tid -> packed store epoch seq
    bn: int

    @property
    def n(self) -> int:
        return int(self.ext_ids.shape[0])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class TenantArena:
    """Pack N tenants into one arena; search them in one kernel pair.

    ``bn`` is FIXED at construction: region boundaries are bn-tile
    boundaries, and a tuning-derived bn (which drifts with Q and N) would
    silently misalign them — the mask would leak rows across tenants.
    ``store_kw`` forwards to every tenant's ``MutableStore``
    (slack_frac/min_slack/max_pending/...). The packed arena and every
    tenant's epochs live on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, d: int, *, root: Optional[str] = None, bn: int = 128,
                 fault_injector=None,
                 default_quota: TenantQuota = TenantQuota(), device=None,
                 **store_kw):
        self.device = device_mod.resolve(device)
        self.d = d
        self.W = (d + 31) // 32
        self.root = root
        self.bn = bn
        self.faults = fault_injector
        self.default_quota = default_quota
        self.store_kw = dict(store_kw)
        self.tenants: Dict[str, Tenant] = {}
        self._packed: Optional[PackedEpoch] = None
        self._packed_counter = 0

    # -- tenant lifecycle ---------------------------------------------------

    def create_tenant(self, tid: str, codes=None, ids=None, values=None,
                      quota: Optional[TenantQuota] = None) -> Tenant:
        """Bootstrap a tenant (empty when ``codes`` is None) under its own
        WAL namespace with tenant-scoped fault sites."""
        if tid in self.tenants:
            raise ValueError(f"tenant {tid!r} exists")
        codes = (np.zeros((0, self.W), np.uint32) if codes is None
                 else np.atleast_2d(mutable_mod._host_codes(codes)))
        if codes.shape[1] != self.W:
            raise ValueError(f"codes {codes.shape} are not {self.W} words")
        root = (wal_mod.namespace_root(self.root, tid)
                if self.root is not None else None)
        store = mutable_mod.MutableStore.create(
            codes, self.d, ids=ids, values=values, root=root,
            fault_injector=self.faults, fault_scope=tid, device=self.device,
            **self.store_kw)
        t = Tenant(tid=tid, store=store,
                   quota=quota if quota is not None else self.default_quota)
        self.tenants[t.tid] = t
        return t

    def tenant(self, tid: str) -> Tenant:
        return self.tenants[tid]

    def healthy_tids(self) -> List[str]:
        return sorted(t.tid for t in self.tenants.values()
                      if t.status == HEALTHY)

    def _healthy(self, tid: str) -> Tenant:
        t = self.tenants[tid]
        if t.status != HEALTHY:
            raise TenantQuarantined(tid, t.error)
        return t

    def quarantine(self, tid: str, error: str) -> None:
        """Degrade one tenant: drop it from packing/admission/search. Its
        on-disk namespace is left untouched for offline repair."""
        t = self.tenants.get(tid)
        if t is None:
            t = Tenant(tid=tid, store=None, quota=self.default_quota)
            self.tenants[tid] = t
        if t.store is not None:
            t.store.close()
            t.store = None
        t.status = QUARANTINED
        t.error = error

    # -- admission ----------------------------------------------------------

    def admission_check(self, tid: str, n: int = 1) -> Optional[str]:
        """Why an ``n``-row append to ``tid`` must be shed, or None.
        Reasons, most to least absolute: ``quarantined`` (no store),
        ``quota_exceeded`` (would cross the tenant's row ceiling — a
        caller-visible limit, retrying is pointless until deletes land),
        ``backlog_full`` (compaction or pending backlog is saturated —
        transient, retry later). Rate limits are the server's, not ours:
        they need tick state."""
        t = self.tenants[tid]
        if t.status != HEALTHY:
            return "quarantined"
        q = t.quota
        if q.max_rows is not None and t.store.n_live + n > q.max_rows:
            return "quota_exceeded"
        if t.store.backlog_full:
            return "backlog_full"
        if (q.max_pending is not None
                and t.store.pending_mutations + n > q.max_pending):
            return "backlog_full"
        return None

    def append(self, tid: str, codes, ids=None, values=None) -> np.ndarray:
        return self._healthy(tid).store.append(codes, ids=ids, values=values)

    def delete(self, tid: str, ids) -> int:
        return self._healthy(tid).store.delete(ids)

    # -- packing ------------------------------------------------------------

    def pack(self, force: bool = False) -> PackedEpoch:
        """(Re)build the packed view over every healthy tenant's INSTALLED
        epoch. Cached: a repack happens only when some tenant installed a
        new epoch or the healthy set changed — otherwise the previous
        packed arrays (already on device) are reused as-is."""
        current = {}
        for tid in self.healthy_tids():
            ep = self.tenants[tid].store._pinned()
            current[tid] = ep.seq
        if (not force and self._packed is not None
                and self._packed.tenant_epochs == current):
            return self._packed
        parts_c: List[np.ndarray] = []
        parts_e: List[np.ndarray] = []
        regions: Dict[str, Tuple[int, int, int]] = {}
        off = 0
        for tid in sorted(current):
            ep = self.tenants[tid].store.epoch
            n_t = ep.n
            cap = _round_up(n_t, self.bn)
            if n_t:
                parts_c.append(ep.layout.codes.cpu().numpy().view(np.uint32))
                parts_e.append(np.asarray(ep.store_ids, np.int64))
            pad = cap - n_t
            if pad:
                # all-ones pads: distance to ANY query is the closed-form
                # b_pad(q) the search epilogue corrects for
                parts_c.append(np.full((pad, self.W), 0xFFFFFFFF,
                                       np.uint32))
                parts_e.append(np.full(pad, -1, np.int64))
            regions[tid] = (off, n_t, cap)
            off += cap
        codes = (np.concatenate(parts_c) if parts_c
                 else np.zeros((0, self.W), np.uint32))
        ext = (np.concatenate(parts_e) if parts_e
               else np.zeros((0,), np.int64))
        self._packed_counter += 1
        self._packed = PackedEpoch(seq=self._packed_counter,
                                   codes=torch.from_numpy(
                                       codes.view(np.int32)).to(self.device),
                                   ext_ids=ext, regions=regions,
                                   tenant_epochs=current, bn=self.bn)
        return self._packed

    # -- search -------------------------------------------------------------

    def search(self, queries: Mapping[str, np.ndarray], k: int,
               emit: str = "split"
               ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Mixed-tenant batch through ONE K1 + ONE K2 launch.

        ``queries``: tid -> (Qt, W) packed queries. Returns tid ->
        (dists (Qt, k) int32 ascending, ext_ids (Qt, k) int64, -1 in
        sentinel slots) — bit-identical to each tenant's own
        ``MutableStore.search`` on the same epoch. ``emit``: "split" (K2
        over runs of tiles, bases from K1's pad-corrected run histograms)
        or "single" (K2 as one run); both give the same answer."""
        from repro_torch.kernels import ops, topk_select

        if emit not in ("split", "single"):
            raise ValueError(f"emit={emit!r} (split|single)")
        for tid in queries:
            self._healthy(tid)                  # raises for quarantined
        ep = self.pack()
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        host = {t: np.atleast_2d(mutable_mod._host_codes(queries[t]))
                for t in queries}
        tids = [t for t in sorted(queries) if host[t].shape[0] > 0]
        for tid in sorted(queries):
            if tid not in tids:
                out[tid] = (np.zeros((0, k), np.int32),
                            np.zeros((0, k), np.int64))
        if not tids:
            return out
        N, bins = ep.n, self.d + 1
        k_k = min(k, N)
        if k_k == 0:                            # every region is empty
            for tid in tids:
                qt = host[tid].shape[0]
                out[tid] = (np.full((qt, k), bins, np.int32),
                            np.full((qt, k), -1, np.int64))
            return out
        W = self.W
        dev = self.device
        lanes = max(bins, k_k)
        q_raw = sum(host[t].shape[0] for t in tids)
        # sub (the TPU kernels' in-tile step) is unused by the port's
        # kernels: the arena's fixed bn is its own sub, so any bn tiles
        bq, bn, sub, _, n_pad = ops.topk_geometry(
            q_raw, N, W, lanes, None, self.bn, self.bn,
            backend=device_mod.backend_of(dev))
        if bn != self.bn or n_pad != N:
            raise RuntimeError(f"packed arena of {N} rows does not tile at "
                               f"bn={self.bn} (got bn={bn}, {n_pad} rows)")

        # group queries per tenant, each group padded to a bq multiple so
        # no query block straddles tenants (mask rows are per-block)
        rows_c: List[np.ndarray] = []
        spans: Dict[str, Tuple[int, int]] = {}  # tid -> (row0, Qt)
        mask_rows: List[np.ndarray] = []
        n_nblocks = N // bn
        qp_total = 0
        for tid in tids:
            qt_codes = host[tid]
            qt = qt_codes.shape[0]
            g = _round_up(qt, bq)
            spans[tid] = (qp_total, qt)
            rows_c.append(qt_codes)
            if g > qt:
                rows_c.append(np.zeros((g - qt, W), np.uint32))
            start, _, cap = ep.regions[tid]
            row = np.zeros(n_nblocks, np.int32)
            row[start // bn:(start + cap) // bn] = 1
            mask_rows.extend([row] * (g // bq))
            qp_total += g
        qp = torch.from_numpy(np.concatenate(rows_c).view(np.int32)).to(dev)
        mask = torch.from_numpy(np.stack(mask_rows)).to(dev)
        xp = ep.codes

        # per-row pad accounting: P = the row's tenant's pad count, b_pad =
        # clamped distance from the row's query to an all-ones pad row,
        # pad_run = the run of the tile that holds the tenant's pads
        runs = topk_select.default_runs(qp_total // bq, n_nblocks)
        span = topk_select._run_span(n_nblocks, runs)
        real = np.zeros(qp_total, bool)
        P_np = np.zeros(qp_total, np.int64)
        run_np = np.zeros(qp_total, np.int64)
        for tid in tids:
            row0, qt = spans[tid]
            start, n_t, cap = ep.regions[tid]
            real[row0:row0 + qt] = True
            g = _round_up(qt, bq)
            P_np[row0:row0 + g] = cap - n_t
            run_np[row0:row0 + g] = ((start + cap) // bn - 1) // span
        P = torch.from_numpy(P_np).to(dev)
        real_t = torch.from_numpy(real).to(dev)
        pop = binary.popcount32(qp).sum(dim=1)
        b_pad = torch.clamp(32 * W - pop, max=bins - 1).long()
        rows = torch.arange(qp_total, device=dev)

        hist, block_min, *run_hist = topk_select.hamming_hist_kernel(
            qp, xp, bins, N, block_mask=mask, bq=bq, bn=bn, sub=sub,
            runs=runs if emit == "split" else None)
        hist[rows, b_pad] -= P.to(torch.int32)
        cum = torch.cumsum(hist, dim=-1, dtype=torch.int32)
        _, r_star, n_lt, n_emit = ops._radius_from_cum(cum, k_k)
        p_lt = P * (b_pad < r_star).long()
        # pad query rows emit nothing (and never raise the block-max-r*
        # bound); the tie base skips the pad-occupied below-radius slots
        r_p = torch.where(real_t, r_star, -1).to(torch.int32)
        tie_start = torch.where(real_t, n_lt + p_lt, 0).to(torch.int32)
        P_max = int(max(ep.regions[t][2] - ep.regions[t][1] for t in tids))
        k_e = k_k + P_max
        run_bases = None
        if emit == "split":
            rh = run_hist[0]
            rh[rows, torch.from_numpy(run_np).to(dev), b_pad] -= P.to(
                torch.int32)
            run_bases = ops._run_bases(rh, r_p, tie_start)
        out_d, out_i = topk_select.hamming_emit_kernel(
            qp, xp, r_p, tie_start, bins, k_e, N, block_min=block_min,
            block_mask=mask, bq=bq, bn=bn, sub=sub, run_bases=run_bases)

        # reconstruct the per-tenant slot sequence: real below-radius rows
        # sit at [0, n_lt) (pads trail them in scan order), real ties at
        # [tie_start, tie_start + ...); then the standard sentinel+sort
        j = torch.arange(k_k, dtype=torch.int32, device=dev)[None, :]
        src = torch.where(j < n_lt[:, None], j,
                          tie_start[:, None] + (j - n_lt[:, None]))
        src = torch.clamp(src, 0, k_e - 1).long()
        dd, ii = ops._finalize_slots(
            torch.gather(out_d, 1, src), torch.gather(out_i, 1, src),
            n_emit, k, k_k, bins, N)
        dd_np, ii_np = dd.cpu().numpy(), ii.cpu().numpy()
        valid = (ii_np < N) & (dd_np <= self.d)
        ext = np.where(valid,
                       ep.ext_ids[np.clip(ii_np, 0, max(N - 1, 0))], -1)
        for tid in tids:
            row0, qt = spans[tid]
            out[tid] = (dd_np[row0:row0 + qt].astype(np.int32),
                        ext[row0:row0 + qt].astype(np.int64))
        return out

    # -- maintenance / durability -------------------------------------------

    def maintain(self, compact_budget: int = 1, flush: bool = True) -> dict:
        """One cooperative maintenance step: compact the neediest tenants
        (at most ``compact_budget`` — quota-aware fair-share: the deepest
        backlog goes first), then flush + repack. Per-tenant transient
        faults are contained: a tenant whose compact/flush crashes keeps
        its previous epoch and every other tenant proceeds."""
        report = {"compacted": [], "failed": {}}
        pending = sorted(
            (t for t in self.tenants.values()
             if t.status == HEALTHY and t.store.needs_compact),
            key=lambda t: -t.store.pending_mutations)
        for t in pending[:max(compact_budget, 0)]:
            try:
                t.store.maybe_compact()
                report["compacted"].append(t.tid)
            except faults_mod.TRANSIENT as e:
                report["failed"][t.tid] = repr(e)
        if flush:
            for tid in self.healthy_tids():
                t = self.tenants[tid]
                try:
                    t.store.flush()
                except faults_mod.TRANSIENT as e:
                    report["failed"][tid] = repr(e)
            self.pack()
        return report

    def snapshot(self) -> Dict[str, int]:
        """Snapshot every healthy tenant (each under its own namespace);
        transient per-tenant failures are contained and reported."""
        steps: Dict[str, int] = {}
        for tid in self.healthy_tids():
            try:
                steps[tid] = self.tenants[tid].store.snapshot()
            except faults_mod.TRANSIENT:
                steps[tid] = -1
        return steps

    @classmethod
    def recover(cls, d: int, root: str, *, fault_injector=None,
                default_quota: TenantQuota = TenantQuota(),
                quotas: Optional[Mapping[str, TenantQuota]] = None,
                bn: int = 128, recover_retries: int = 32, device=None,
                **store_kw) -> "TenantArena":
        """Bring every namespace under ``root`` up independently.

        Triage ladder per tenant: (1) ``wal.verify`` — interior corruption
        (acked records stranded past a bad frame) quarantines the tenant
        outright, a torn tail is a normal crash artifact; (2)
        ``MutableStore.recover`` with bounded retries on transient faults;
        (3) any non-transient error (or retry exhaustion) quarantines.
        Healthy tenants come up no matter how many neighbours are sick —
        the arena itself never fails to recover. Quotas are config, not
        durable state: pass them back in via ``quotas``."""
        arena = cls(d, root=root, bn=bn, fault_injector=fault_injector,
                    default_quota=default_quota, device=device, **store_kw)
        quotas = dict(quotas or {})
        for tid in wal_mod.list_namespaces(root):
            ns = wal_mod.namespace_root(root, tid)
            quota = quotas.get(tid, default_quota)
            v = wal_mod.verify(os.path.join(ns, "wal.log"))
            if v["status"] == "corrupt":
                arena.quarantine(
                    tid, f"wal interior corruption at byte "
                         f"{v['bad_offset']} (after seq {v['last_seq']})")
                arena.tenants[tid].quota = quota
                continue
            store = None
            err = None
            for _ in range(max(recover_retries, 1)):
                try:
                    store = mutable_mod.MutableStore.recover(
                        ns, fault_injector=fault_injector,
                        fault_scope=tid, device=arena.device, **store_kw)
                    break
                except faults_mod.TRANSIENT as e:
                    err = e
                except Exception as e:          # non-transient: quarantine
                    err = e
                    break
            if store is None:
                arena.quarantine(tid, repr(err))
                arena.tenants[tid].quota = quota
            else:
                arena.tenants[tid] = Tenant(tid=tid, store=store,
                                            quota=quota)
        if arena.healthy_tids():
            arena.pack()
        return arena

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        per = {}
        for tid in sorted(self.tenants):
            t = self.tenants[tid]
            row = {"status": t.status, "error": t.error,
                   "quota_rows": t.quota.max_rows}
            if t.store is not None:
                row.update(t.store.stats())
            per[tid] = row
        packed = self._packed
        return {"tenants": per,
                "n_tenants": len(self.tenants),
                "n_quarantined": sum(
                    1 for t in self.tenants.values()
                    if t.status == QUARANTINED),
                "packed_seq": packed.seq if packed else 0,
                "packed_rows": packed.n if packed else 0,
                "packed_pad_rows": (sum(
                    cap - n for (_, n, cap) in packed.regions.values())
                    if packed else 0)}

    def close(self) -> None:
        for t in self.tenants.values():
            if t.store is not None:
                t.store.close()
