"""Batched serving runtime: continuous batching over a fixed slot pool with
kNN-LM retrieval (the paper's engine) in the decode loop (port of
``repro.runtime.server``, one card, no mesh).

Requests enter a bounded waiting queue (submissions beyond ``max_queue``
are SHED immediately); free slots admit them by replaying the prompt
through the decode step with a one-hot ``active`` mask (per-row positions
make the shared KV cache sound; a reused slot's recurrent-state rows, the
Mamba2 and RWKV6 states, start from zero, where ``repro`` keeps the last
request's); each ``tick`` then decodes one token for
every live slot. Requests that outlive ``deadline_ticks`` are evicted from
the queue or their slot with a ``timed_out`` status.

Degradation ladder (``DegradationPolicy``): under pressure (queue depth /
per-tick latency EWMA) the server downshifts the retrieval QueryPlan one
rung at a time —

    rung 0: full exact plan
    rung 1..m: masked hamming-prefix probe at decreasing nprobe
               (requires a power-of-two bucket layout on the store)
    approx rungs: the partial-reduce tier at recall_target 0.95, 0.9, 0.8
    last rung: retrieval-off decode  (LM softmax only)

— re-logging the active plan on every transition and recovering one rung
per ``cooldown_ticks`` of calm. Transient search failures retry with
bounded backoff, then try restoring the datastore from its last-good
snapshot (``snapshot_dir``), then — with a shard-fault-tolerance layer
attached (``shard_search``, dist/search.py) — the SHARD-LOSS rung: serve a
degraded-but-exact view of only the covered rows (honest coverage in
``stats()["shards"]``), before finally failing over to retrieval-off
decode. ``_after_tick`` drives the shard layer's background
re-replication and swaps the full store back the moment coverage returns
to 1.0.

A mutable store (core/mutable.py) attaches directly: the server serves one
installed epoch per view, runs cooperative compaction + flush + periodic
``audit()`` in ``_after_tick``, and admits online ``submit_append``/
``submit_delete`` with shed-on-backpressure. A multi-tenant arena
(core/tenant.py) attaches via ``tenants``: the same submit calls take a
``tenant=`` and walk the per-tenant shed ladder (``quarantined``,
``rate_limited``, ``quota_exceeded``, ``backlog_full``), and per-tenant
counters land under ``stats()["tenants"]``.

``mesh`` and ``shard_axes`` choose the plan the server logs at startup, as
in ``repro``: with both, the sharded plan over the whole store (merge
strategy and predicted traffic included), else the store's local plan.
The decode step searches the server's own store on its device either
way, as ``repro``'s serve step does.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import retrieval as retrieval_mod
from repro_torch.core import tenant as tenant_mod
from repro_torch.dist import steps as steps_mod
from repro_torch.models import lm
from repro_torch.runtime import faults as faults_mod

log = logging.getLogger(__name__)

QUEUED, ACTIVE, DONE, SHED, TIMED_OUT = (
    "queued", "active", "done", "shed", "timed_out")

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int
    out_tokens: Optional[list] = None
    # ticks after submission before the request is evicted (queue OR slot)
    # with status "timed_out"; None = no deadline
    deadline_ticks: Optional[int] = None
    status: str = QUEUED
    finish_reason: str = ""     # complete | capacity | deadline | queue_full
    submit_tick: int = -1
    admit_tick: int = -1
    finish_tick: int = -1

    @property
    def queue_ticks(self) -> Optional[int]:
        if self.submit_tick < 0:
            return None
        end = self.admit_tick if self.admit_tick >= 0 else self.finish_tick
        return None if end < 0 else end - self.submit_tick


@dataclasses.dataclass(frozen=True)
class Rung:
    name: str
    retrieval: bool
    nprobe: int = 0             # 0 with retrieval -> the full exact plan
    select: str = ""            # "" -> the config's plan; "approx" -> the
                                # partial-reduce tier
    recall_target: float = 1.0  # approx rung only: degraded recall floor


@dataclasses.dataclass
class DegradationPolicy:
    """Pressure controller for the plan ladder.

    Downshifts one rung the moment queue depth reaches ``queue_high`` or
    the per-tick latency EWMA exceeds ``tick_high_s``; upshifts one rung
    after ``cooldown_ticks`` consecutive calm ticks (queue at or below
    ``queue_low`` and EWMA back under the high-water mark). One rung per
    tick in either direction.
    """

    queue_high: int = 8
    queue_low: int = 1
    tick_high_s: float = float("inf")
    alpha: float = 0.25         # EWMA smoothing
    cooldown_ticks: int = 8
    ewma_s: Optional[float] = None
    _calm: int = 0

    def update(self, rung: int, n_rungs: int, queue_depth: int,
               tick_s: float) -> int:
        self.ewma_s = tick_s if self.ewma_s is None else (
            self.alpha * tick_s + (1.0 - self.alpha) * self.ewma_s)
        pressured = (queue_depth >= self.queue_high
                     or self.ewma_s > self.tick_high_s)
        if pressured:
            self._calm = 0
            return min(rung + 1, n_rungs - 1)
        calm = (queue_depth <= self.queue_low
                and self.ewma_s <= self.tick_high_s)
        if not calm:
            self._calm = 0
            return rung
        if rung > 0:
            self._calm += 1
            if self._calm >= self.cooldown_ticks:
                self._calm = 0
                return rung - 1
        return rung


class Server:
    def __init__(self, cfg: ModelConfig, model: lm.LM, *, max_batch: int,
                 max_len: int, store=None, device=None, mesh=None,
                 shard_axes=(),
                 max_queue: Optional[int] = None,
                 default_deadline_ticks: Optional[int] = None,
                 degradation: Optional[DegradationPolicy] = None,
                 fault_injector: Optional[faults_mod.FaultInjector] = None,
                 search_retries: int = 2, retry_backoff_s: float = 1e-3,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 audit_every: Optional[int] = None,
                 mutate_flush_every: int = 4,
                 tenants: Optional[tenant_mod.TenantArena] = None,
                 shard_search=None):
        self.device = device_mod.resolve(device)
        if tuple(shard_axes) and mesh is None:
            raise ValueError("shard_axes names axes of a mesh: pass mesh=")
        if not device_mod.same(model.device, self.device):
            raise ValueError(f"the model is on {model.device}, the server "
                             f"runs on {self.device}")
        self.cfg, self.model = cfg, model
        self.max_batch, self.max_len = max_batch, max_len
        # a MutableStore (core/mutable.py) serves through its installed
        # epoch: ``self.store`` is always a plain DataStore VIEW of one
        # epoch (refreshed in _after_tick when a newer epoch installs), so
        # the decode path never observes a half-mutated arena
        self.mstore = None
        self._store_epoch = -1
        if store is not None and hasattr(store, "datastore_view"):
            self.mstore = store
            store = store.datastore_view()
            self._store_epoch = self.mstore.epoch_seq
        if store is not None and not device_mod.same(store.codes.device,
                                                     self.device):
            raise ValueError(f"the store is on {store.codes.device}, the "
                             f"server runs on {self.device}")
        self.store = store
        self.audit_every = audit_every
        self.mutate_flush_every = mutate_flush_every
        self.tenants = tenants
        self.tenant_counters: Dict[str, collections.Counter] = (
            collections.defaultdict(collections.Counter))
        self._tenant_tick_mut: Dict[str, int] = {}
        self.with_retrieval = cfg.retrieval.enabled and store is not None
        # shard-fault-tolerance layer (dist/search.FaultTolerantSearch over
        # the SAME corpus): when attached, the server tracks its coverage —
        # a dead shard swaps in a degraded store VIEW of only the covered
        # rows (the shard-loss rung of the failover ladder), maintenance
        # re-replicates in the background, and recovery swaps the full
        # store back. The view search is exact over the surviving rows;
        # coverage is surfaced in stats()["shards"], never silently lost.
        self.shard_search = shard_search
        self._full_store = store
        self._shard_cov_sig = None
        self._shard_view_cache: Dict[tuple, object] = {}
        if shard_search is not None:
            if store is None:
                raise ValueError("shard_search needs a datastore to shadow")
            n_store = int(store.codes.shape[0])
            if shard_search.map.total_rows != n_store:
                raise ValueError(
                    f"shard_search covers {shard_search.map.total_rows} "
                    f"rows but the store has {n_store}")
            self._shard_cov_sig = shard_search.covered_ranges()
        self.max_queue = max_queue
        self.default_deadline_ticks = default_deadline_ticks
        self.policy = degradation
        self.faults = fault_injector
        self.search_retries = search_retries
        self.retry_backoff_s = retry_backoff_s
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        # resolve and log the retrieval QueryPlan once per store at startup
        # (retrieval.log_store_plan). ``shard_axes``: the mesh axes the
        # datastore is planned over — with them the logged plan is the
        # SHARDED plan over the whole store, including the merge strategy
        # (hist_merge vs concat_sort) and its predicted cross-rank traffic;
        # without them it is the store's LOCAL plan.
        self.retrieval_plan = None
        if self.with_retrieval:
            self.retrieval_plan = retrieval_mod.log_store_plan(
                store, cfg.retrieval, q=max_batch, logger=log,
                mesh=mesh if shard_axes else None, axes=tuple(shard_axes),
                n_rows=int(store.codes.shape[0]))
        self.rungs = self._build_ladder()
        self.rung = 0
        self._fns: Dict[Rung, object] = {}
        self._rung_fn(self.rungs[0])
        self.state = lm.init_decode_state(cfg, max_batch, max_len,
                                          device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.last_token = np.zeros((max_batch, 1), np.int32)
        self.waiting: Deque[Request] = collections.deque()
        self.done: List[Request] = []
        self.shed: List[Request] = []
        self.timed_out: List[Request] = []
        self.ticks = 0
        self.transitions: List[tuple] = []   # (tick, from, to, why)
        self.counters = collections.Counter()
        self.tick_s: List[float] = []
        self.token_lat_s: List[float] = []
        self.queue_wait_ticks: List[int] = []
        if (self.with_retrieval and snapshot_dir is not None
                and self.mstore is None):
            # last-good snapshot baseline: written before serving starts,
            # so a corrupted store always has something to fall back to
            # (a MutableStore snapshots into its own root at create time)
            ckpt.save(snapshot_dir, 0, self.store, blocking=True)
            self.counters["snapshot_saves"] += 1

    # -- degradation ladder -----------------------------------------------

    def _build_ladder(self) -> List[Rung]:
        if not self.with_retrieval:
            return [Rung("decode", False, 0)]
        rungs = [Rung("exact", True, 0)]
        self._probe_positions = None
        if self.policy is not None and self.store.layout is not None:
            self._probe_positions = retrieval_mod.probe_key_positions(
                self.store, self.cfg.retrieval)
            if self._probe_positions is not None:
                B = self.store.layout.n_buckets
                nprobes = sorted({max(1, B // 4), max(1, B // 16)},
                                 reverse=True)
                rungs += [Rung(f"probe{n}", True, n)
                          for n in nprobes if n < B]
        if self.policy is not None:
            # the last rungs that still retrieve: the approx tier at three
            # decreasing recall targets, walked one rung per pressured tick
            rungs += [Rung(f"approx_rt{int(rt * 100)}", True, 0,
                           select="approx", recall_target=rt)
                      for rt in (0.95, 0.9, 0.8)]
        rungs.append(Rung("retrieval_off", False, 0))
        return rungs

    def _rung_fn(self, r: Rung):
        if r not in self._fns:
            self._fns[r] = steps_mod.make_serve_step(
                self.cfg, self.max_len, with_retrieval=r.retrieval,
                nprobe=r.nprobe,
                probe_positions=(self._probe_positions if r.nprobe else None),
                select=r.select or None,
                recall_target=(r.recall_target if r.select == "approx"
                               else None))
        return self._fns[r]

    def _rung_plan_str(self, r: Rung) -> str:
        if not r.retrieval:
            return "retrieval_off"
        if r.select == "approx":
            return retrieval_mod.plan_for_store(
                self.store, self.cfg.retrieval, self.max_batch,
                select="approx", recall_target=r.recall_target).compact()
        if r.nprobe:
            return retrieval_mod.degraded_plan_for_store(
                self.store, self.cfg.retrieval, self.max_batch,
                r.nprobe).compact()
        return (self.retrieval_plan.compact()
                if self.retrieval_plan is not None else "exact")

    def _set_rung(self, idx: int, why: str):
        if idx == self.rung:
            return
        old, new = self.rungs[self.rung], self.rungs[idx]
        self.rung = idx
        self.transitions.append((self.ticks, old.name, new.name, why))
        self.counters["transitions"] += 1
        log.info("degradation: %s -> %s (%s); active plan %s",
                 old.name, new.name, why, self._rung_plan_str(new))

    # -- the decode step (guarded) ----------------------------------------

    def _step(self, token: np.ndarray, active: np.ndarray, r: Rung):
        if r.nprobe and self.store is not self._full_store:
            # masked-probe steps are built against the FULL store's bucket
            # layout; a shard-degraded view has no layout — serve the view
            # through the exact plan instead of a mis-aimed probe
            r = self.rungs[0]
        fn = self._rung_fn(r)
        args = (self.model, torch.from_numpy(token).to(self.device),
                self.state, torch.from_numpy(active).to(self.device))
        if r.retrieval:
            args = args + (self.store,)
        logits, self.state = fn(*args)
        return logits[:, 0, :].float().cpu().numpy()

    def _guarded_step(self, token: np.ndarray, active: np.ndarray):
        """One decode step at the current rung with the failure ladder:
        bounded retry-with-backoff -> last-good snapshot restore ->
        retrieval-off failover. The injector's check sits BEFORE the step,
        so a failed attempt never half-advanced the decode state."""
        r = self.rungs[self.rung]
        inj = self.faults

        def attempt():
            if inj is not None and r.retrieval:
                inj.check("store_search")
            return self._step(token, active, r)

        def count_retry(_e, _attempt):
            self.counters["search_retries"] += 1

        try:
            return faults_mod.retry_call(
                attempt, retries=self.search_retries,
                backoff_s=self.retry_backoff_s, on_retry=count_retry)
        except faults_mod.TRANSIENT:
            self.counters["search_failures"] += 1
        if self.snapshot_dir is not None and self._restore_store_snapshot():
            try:
                if inj is not None:
                    inj.check("store_search")
                return self._step(token, active, r)
            except faults_mod.TRANSIENT:
                self.counters["search_failures"] += 1
        # shard-loss rung: if the shard layer says part of the fleet is
        # gone, serve the degraded-but-exact surviving-rows view before
        # giving up on retrieval entirely
        if self.shard_search is not None and self._refresh_shard_view():
            try:
                if inj is not None:
                    inj.check("store_search")
                out = self._step(token, active, r)
                self.counters["shard_failover_ticks"] += 1
                return out
            except faults_mod.TRANSIENT:
                self.counters["search_failures"] += 1
        # the search is unavailable this tick: decode without retrieval
        # rather than stalling every slot
        self.counters["failover_ticks"] += 1
        self._set_rung(len(self.rungs) - 1, "search failover")
        return self._step(token, active, self.rungs[self.rung])

    # -- snapshots ----------------------------------------------------------

    def _restore_store_snapshot(self) -> bool:
        if self.mstore is not None:
            # an installed epoch is immutable — there is no mid-process
            # corruption to roll back; durability lives in the store's own
            # WAL + snapshots (MutableStore.recover)
            return False
        inj = self.faults

        def load():
            if inj is not None:
                inj.check("ckpt_restore")
            return ckpt.restore_latest(self.snapshot_dir, self.store)

        try:
            step, tree = faults_mod.retry_call(
                load, retries=self.search_retries,
                backoff_s=self.retry_backoff_s)
        except faults_mod.TRANSIENT:
            self.counters["snapshot_restore_failures"] += 1
            return False
        if tree is None:
            return False
        self.store = tree
        if self.shard_search is not None:
            # the snapshot is the FULL store; re-sync the shard view to
            # current coverage on the next refresh
            self._full_store = tree
            self._shard_view_cache.clear()
            self._shard_cov_sig = None
        self.counters["snapshot_restores"] += 1
        log.info("datastore restored from snapshot step %s", step)
        return True

    def _refresh_shard_view(self) -> bool:
        """Sync ``self.store`` to the shard layer's current coverage:
        full store when every range is covered, else a degraded VIEW of
        only the covered rows (original row order, no layout — exact plan).
        Views are cached per coverage signature so a flapping shard never
        rebuilds the same view twice. Returns True iff the store swapped."""
        sig = self.shard_search.covered_ranges()
        if sig == self._shard_cov_sig:
            return False
        self._shard_cov_sig = sig
        cov = self.shard_search.coverage()
        if cov.complete:
            self.store = self._full_store
            self.counters["shard_recoveries"] += 1
            log.info("shard coverage restored: serving the full store "
                     "(%d rows)", cov.total_rows)
            return True
        view = self._shard_view_cache.get(sig)
        if view is None:
            full = self._full_store
            m = torch.from_numpy(self.shard_search.covered_row_ids()).to(
                full.codes.device)
            view = full._replace(codes=full.codes[m], values=full.values[m],
                                 layout=None, key_positions=None)
            self._shard_view_cache[sig] = view
        self.store = view
        self.counters["shard_losses"] += 1
        log.info("shard loss: serving degraded store view %s "
                 "(coverage %.3f, dead=%s)", sig, cov.coverage_frac,
                 list(cov.dead_shards))
        return True

    def _save_store_snapshot(self):
        if self.mstore is not None:
            if self.mstore.root is None:
                return
            try:
                self.mstore.snapshot()
                self.counters["snapshot_saves"] += 1
            except faults_mod.TRANSIENT:
                self.counters["snapshot_save_failures"] += 1
            return
        hook = self.faults.hook("ckpt_save") if self.faults else None
        try:
            ckpt.save(self.snapshot_dir, self.ticks, self.store,
                      blocking=True, fault_hook=hook)
            self.counters["snapshot_saves"] += 1
            # sweeps crashed .tmp dirs along with old committed steps
            ckpt.garbage_collect(self.snapshot_dir, keep=2)
        except faults_mod.TRANSIENT:
            self.counters["snapshot_save_failures"] += 1

    # -- mutation admission (mutable stores, tenants) -----------------------

    def _tenant_shed_reason(self, tid: str, n: int,
                            is_append: bool) -> Optional[str]:
        """The per-tenant admission ladder, most to least absolute:
        quarantined -> rate_limited -> quota_exceeded -> backlog_full.
        Deletes skip the capacity reasons — they relieve pressure."""
        t = self.tenants.tenants[tid]
        if t.status != tenant_mod.HEALTHY:
            return "quarantined"
        lim = t.quota.max_mutations_per_tick
        if lim is not None and self._tenant_tick_mut.get(tid, 0) + n > lim:
            return "rate_limited"
        return self.tenants.admission_check(tid, n) if is_append else None

    def _tenant_mutate(self, tid: str, n: int, is_append: bool, fn) -> bool:
        tc = self.tenant_counters[tid]
        reason = self._tenant_shed_reason(tid, n, is_append)
        if reason is not None:
            tc["mutations_shed"] += n
            tc["shed_" + reason] += n
            self.counters["mutations_shed"] += n
            return False
        try:
            fn()
        except faults_mod.TRANSIENT:
            tc["mutation_failures"] += 1
            self.counters["mutation_failures"] += 1
            return False
        self._tenant_tick_mut[tid] = self._tenant_tick_mut.get(tid, 0) + n
        tc["mutations_applied"] += n
        self.counters["mutations_applied"] += n
        return True

    def tenant_search(self, queries, k: int):
        """Mixed-tenant batched search through the packed arena (one K1 +
        one K2 launch for the whole batch), with the same bounded retry
        the decode-path search gets."""
        if self.tenants is None:
            raise ValueError("no tenant arena attached")

        def attempt():
            if self.faults is not None:
                self.faults.check("store_search")
            return self.tenants.search(queries, k)

        try:
            res = faults_mod.retry_call(attempt, retries=self.search_retries,
                                        backoff_s=self.retry_backoff_s)
        except faults_mod.TRANSIENT:
            self.counters["search_failures"] += 1
            raise
        for tid in queries:
            self.tenant_counters[tid]["searches"] += 1
        return res

    def _need_mstore(self):
        if self.mstore is None:
            raise ValueError("no mutable store attached")
        return self.mstore

    def submit_append(self, codes, values=None, tenant=None) -> bool:
        """Admit an online append to the mutable store. SHED (False) when
        compaction has fallen behind (``mutations_shed`` in stats()).
        False also means NOT acknowledged: a WAL fault before the fsync
        sheds rather than acks. With ``tenant``, admission walks the
        per-tenant ladder against that tenant's quota instead."""
        n = int(np.atleast_2d(np.asarray(codes)).shape[0])
        if tenant is not None:
            return self._tenant_mutate(
                tenant, n, True,
                lambda: self.tenants.append(tenant, codes, values=values))
        m = self._need_mstore()
        if m.backlog_full:
            self.counters["mutations_shed"] += n
            return False
        try:
            m.append(codes, values=values)
        except faults_mod.TRANSIENT:
            self.counters["mutation_failures"] += 1
            return False
        self.counters["mutations_applied"] += n
        return True

    def submit_delete(self, ids, tenant=None) -> bool:
        n = int(np.atleast_1d(np.asarray(ids)).shape[0])
        if tenant is not None:
            return self._tenant_mutate(
                tenant, n, False,
                lambda: self.tenants.delete(tenant, ids))
        m = self._need_mstore()
        if m.backlog_full:
            self.counters["mutations_shed"] += n
            return False
        try:
            m.delete(ids)
        except faults_mod.TRANSIENT:
            self.counters["mutation_failures"] += 1
            return False
        self.counters["mutations_applied"] += n
        return True

    def _store_maintenance(self):
        """Per-tick mutable-store lifecycle: cooperative compaction, epoch
        install for pending mutations, view refresh, periodic audit. Every
        step is fault-guarded — an injected crash retries next tick."""
        m = self.mstore
        try:
            if m.maybe_compact():
                self.counters["compactions"] += 1
        except faults_mod.TRANSIENT:
            self.counters["compact_failures"] += 1
        if (m.pending_mutations
                and self.ticks % self.mutate_flush_every == 0):
            try:
                m.flush()
            except faults_mod.TRANSIENT:
                self.counters["flush_failures"] += 1
        if m.epoch_seq != self._store_epoch:
            self._store_epoch = m.epoch_seq
            self.store = m.datastore_view()
        if self.audit_every and self.ticks % self.audit_every == 0:
            self.counters["audits"] += 1
            report = m.audit(strict=False)
            if not report["ok"]:
                self.counters["audit_failures"] += 1
                log.error("store audit FAILED: %s", report["problems"])

    def _tenant_maintenance(self):
        """Per-tick multi-tenant lifecycle: refresh every tenant's rate
        budget, run quota-aware cooperative maintenance (deepest backlog
        compacts first, bounded per tick), periodic snapshots per
        namespace. Per-tenant failures are contained by the arena."""
        self._tenant_tick_mut = {}
        rep = self.tenants.maintain(
            compact_budget=1,
            flush=(self.ticks % self.mutate_flush_every == 0))
        self.counters["compactions"] += len(rep["compacted"])
        for tid in rep["failed"]:
            self.tenant_counters[tid]["maintenance_failures"] += 1
        if (self.snapshot_every and self.tenants.root is not None
                and self.ticks % self.snapshot_every == 0):
            for tid, step in self.tenants.snapshot().items():
                if step < 0:
                    self.tenant_counters[tid]["snapshot_save_failures"] += 1
                    self.counters["snapshot_save_failures"] += 1
                else:
                    self.counters["snapshot_saves"] += 1

    # -- admission / eviction ---------------------------------------------

    def submit(self, req: Request) -> bool:
        """Returns False when the request was shed at the door."""
        req.submit_tick = self.ticks
        self.counters["submitted"] += 1
        if req.deadline_ticks is None:
            req.deadline_ticks = self.default_deadline_ticks
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            req.status, req.finish_reason = SHED, "queue_full"
            req.finish_tick = self.ticks
            self.shed.append(req)
            self.counters["shed"] += 1
            return False
        req.status = QUEUED
        self.waiting.append(req)
        return True

    def _admit(self, slot: int, req: Request):
        """Replay the prompt through the decode path for one slot."""
        req.out_tokens = []
        req.status, req.admit_tick = ACTIVE, self.ticks
        if req.queue_ticks is not None:
            self.queue_wait_ticks.append(req.queue_ticks)
        self.slots[slot] = req
        # a reused slot restarts at position 0; stale KV rows beyond
        # ``pos`` are masked by position, so no KV wipe is needed. The
        # recurrent states (Mamba2, RWKV6) carry no position: the slot's
        # rows are zeroed, so a request's tokens do not depend on the one
        # that held the slot before (repro keeps them; ROADMAP queue 3)
        pos = self.state["pos"].clone()
        pos[slot] = 0
        self.state = {"pos": pos, "cache": lm.zero_recurrent_row(
            self.cfg, self.state["cache"], slot)}
        active = np.zeros(self.max_batch, bool)
        active[slot] = True
        tok = np.zeros((self.max_batch, 1), np.int32)
        # an empty prompt replays a single BOS/zero token: the decode step
        # still needs one forward to produce first-token logits
        prompt = req.prompt if len(req.prompt) else np.zeros((1,), np.int32)
        logits = None
        for t in prompt:
            tok[slot, 0] = int(t)
            logits = self._guarded_step(tok, active)
        self.last_token[slot, 0] = int(np.argmax(logits[slot]))

    def _expired(self, req: Request) -> bool:
        return (req.deadline_ticks is not None
                and self.ticks - req.submit_tick >= req.deadline_ticks)

    def _retire(self, slot: int, status: str, reason: str):
        req = self.slots[slot]
        self.slots[slot] = None
        req.status, req.finish_reason = status, reason
        req.finish_tick = self.ticks
        (self.done if status == DONE else self.timed_out).append(req)
        self.counters[status] += 1

    def _evict_expired(self):
        if self.waiting:
            still: Deque[Request] = collections.deque()
            for req in self.waiting:
                if self._expired(req):
                    req.status, req.finish_reason = TIMED_OUT, "deadline"
                    req.finish_tick = self.ticks
                    self.timed_out.append(req)
                    self.counters[TIMED_OUT] += 1
                else:
                    still.append(req)
            self.waiting = still
        for i, req in enumerate(self.slots):
            if req is not None and self._expired(req):
                self._retire(i, TIMED_OUT, "deadline")

    # -- the serving loop --------------------------------------------------

    def tick(self) -> bool:
        """One serving tick. Always advances the clock (deadlines are
        measured in ticks); returns True iff any decode work happened."""
        t0 = time.perf_counter()
        self._evict_expired()
        for i in range(self.max_batch):
            if self.slots[i] is None and self.waiting:
                self._admit(i, self.waiting.popleft())
        occupied = np.array([s is not None for s in self.slots])
        if not occupied.any():
            self.ticks += 1
            self._after_tick(time.perf_counter() - t0, worked=False)
            return False
        # guard capacity: rows at max_len - 1 retire without decoding
        pos = self.state["pos"].cpu().numpy()
        active = occupied & (pos < self.max_len - 1)
        capped = occupied & ~active
        logits = self._guarded_step(self.last_token, active) \
            if active.any() else None
        for i in np.where(capped)[0]:
            self._retire(int(i), DONE, "capacity")
        emitted = 0
        if logits is not None:
            for i, req in enumerate(self.slots):
                if req is None or not active[i]:
                    continue
                nxt = int(np.argmax(logits[i]))
                req.out_tokens.append(nxt)
                emitted += 1
                self.last_token[i, 0] = nxt
                if len(req.out_tokens) >= req.max_new_tokens:
                    self._retire(i, DONE, "complete")
        self.ticks += 1
        dt = time.perf_counter() - t0
        if emitted:
            self.token_lat_s.extend([dt / emitted] * emitted)
        self._after_tick(dt, worked=True)
        return True

    def _after_tick(self, dt: float, worked: bool):
        self.counters["ticks"] += 1
        if worked:
            self.counters["work_ticks"] += 1
            self.tick_s.append(dt)
            if self.rung > 0:
                self.counters["degraded_ticks"] += 1
        if self.mstore is not None:
            self._store_maintenance()
        if self.tenants is not None:
            self._tenant_maintenance()
        if self.shard_search is not None:
            # bounded background re-replication + recovery promotion, then
            # keep the serving view in lockstep with coverage (a revived
            # fleet swaps the full store back in without waiting for a
            # search failure to notice)
            m = self.shard_search.maintain(budget=1)
            self.counters["shard_rebuilt_ranges"] += m["copied"]
            self._refresh_shard_view()
            if self.store is not self._full_store:
                self.counters["shard_degraded_ticks"] += 1
        if self.policy is not None and len(self.rungs) > 1:
            new = self.policy.update(self.rung, len(self.rungs),
                                     len(self.waiting), dt)
            if new != self.rung:
                why = (f"queue={len(self.waiting)} "
                       f"ewma={self.policy.ewma_s * 1e3:.1f}ms")
                self._set_rung(new, why)
        if (self.snapshot_dir is not None and self.snapshot_every
                and self.with_retrieval
                and self.ticks % self.snapshot_every == 0):
            self._save_store_snapshot()

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def run(self, max_ticks: int = 1000) -> int:
        while self.has_work and self.ticks < max_ticks:
            if not self.tick():
                break
        return self.ticks

    # -- SLO accounting ----------------------------------------------------

    def stats(self) -> dict:
        """Outcome counters + latency percentiles; ``lost`` MUST be 0 —
        every submitted request is done, shed, timed out, or still in
        flight. The keys are ``repro``'s."""
        c = self.counters
        in_flight = sum(s is not None for s in self.slots) + len(self.waiting)

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0

        work = max(c["work_ticks"], 1)
        return {
            "submitted": c["submitted"],
            "done": c["done"],
            "shed": c["shed"],
            "timed_out": c["timed_out"],
            "in_flight": in_flight,
            "lost": (c["submitted"] - c["done"] - c["shed"] - c["timed_out"]
                     - in_flight),
            "ticks": self.ticks,
            "work_ticks": c["work_ticks"],
            "degraded_ticks": c["degraded_ticks"],
            "degraded_frac": c["degraded_ticks"] / work,
            "shed_frac": c["shed"] / max(c["submitted"], 1),
            "timeout_frac": c["timed_out"] / max(c["submitted"], 1),
            "transitions": c["transitions"],
            "search_retries": c["search_retries"],
            "search_failures": c["search_failures"],
            "failover_ticks": c["failover_ticks"],
            "snapshot_saves": c["snapshot_saves"],
            "snapshot_save_failures": c["snapshot_save_failures"],
            "snapshot_restores": c["snapshot_restores"],
            "snapshot_restore_failures": c["snapshot_restore_failures"],
            "p50_token_s": pct(self.token_lat_s, 50),
            "p99_token_s": pct(self.token_lat_s, 99),
            "p50_queue_ticks": pct(self.queue_wait_ticks, 50),
            "p99_queue_ticks": pct(self.queue_wait_ticks, 99),
            "mean_tick_s": float(np.mean(self.tick_s)) if self.tick_s else 0.0,
            "rung": self.rungs[self.rung].name,
            "mutations_applied": c["mutations_applied"],
            "mutations_shed": c["mutations_shed"],
            "mutation_failures": c["mutation_failures"],
            "pending_mutations": (self.mstore.pending_mutations
                                  if self.mstore is not None else 0),
            "store_epoch": (self.mstore.epoch_seq
                            if self.mstore is not None else -1),
            "compactions": c["compactions"],
            "compact_failures": c["compact_failures"],
            "flush_failures": c["flush_failures"],
            "audits": c["audits"],
            "audit_failures": c["audit_failures"],
            **self._shard_stats(),
            **self._tenant_stats(),
        }

    def _shard_stats(self) -> dict:
        if self.shard_search is None:
            return {}
        cov = self.shard_search.coverage()
        return {"shards": self.shard_search.stats(),
                "coverage_frac": cov.coverage_frac,
                "shard_losses": self.counters["shard_losses"],
                "shard_recoveries": self.counters["shard_recoveries"],
                "shard_degraded_ticks": self.counters["shard_degraded_ticks"],
                "shard_failover_ticks": self.counters["shard_failover_ticks"],
                "shard_rebuilt_ranges": self.counters["shard_rebuilt_ranges"]}

    def _tenant_stats(self) -> dict:
        if self.tenants is None:
            return {}
        t = self.tenants.stats()
        per = t["tenants"]
        for tid, row in per.items():
            row.update(self.tenant_counters.get(tid, {}))
        return {"tenants": per,
                "n_tenants": t["n_tenants"],
                "n_quarantined": t["n_quarantined"],
                "packed_seq": t["packed_seq"],
                "packed_rows": t["packed_rows"]}
