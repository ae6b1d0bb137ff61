"""Batched serving runtime: continuous batching over a fixed slot pool with
kNN-LM retrieval (the paper's engine) in the decode loop (port of
``repro.runtime.server``, one card, no mesh).

Requests enter a bounded waiting queue (submissions beyond ``max_queue``
are SHED immediately); free slots admit them by replaying the prompt
through the decode step with a one-hot ``active`` mask (per-row positions
make the shared cache sound); each ``tick`` then decodes one token for
every live slot. Requests that outlive ``deadline_ticks`` are evicted from
the queue or their slot with a ``timed_out`` status.

Transient search failures retry with bounded backoff, then fail over to
retrieval-off decode (the last rung of the ladder). Not ported yet, and
raising ``NotImplementedError``: the degradation policy's ladder
(``degradation=``), which always adds approx rungs (ROADMAP queue 1 item
9), datastore snapshots (``snapshot_dir``/``snapshot_every``), mutable
stores and tenant arenas (queue 1 item 10), and the shard-fault-tolerance
layer (``shard_search``, ``shard_axes``; queue 1 item 8).
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
from repro_torch.configs.base import ModelConfig
from repro_torch.core import retrieval as retrieval_mod
from repro_torch.dist import steps as steps_mod
from repro_torch.models import lm
from repro_torch.runtime import faults as faults_mod

log = logging.getLogger(__name__)

QUEUED, ACTIVE, DONE, SHED, TIMED_OUT = (
    "queued", "active", "done", "shed", "timed_out")

_UNPORTED_OPTIONS = {
    "degradation": "the degradation ladder always adds the approx rungs, "
                   "which are not ported yet: ROADMAP queue 1 item 9",
    "snapshot_dir": "datastore snapshots are not ported yet: ROADMAP queue "
                    "1 item 10",
    "snapshot_every": "datastore snapshots are not ported yet: ROADMAP "
                      "queue 1 item 10",
    "audit_every": "mutable stores are not ported yet: ROADMAP queue 1 "
                   "item 10",
    "tenants": "tenant arenas are not ported yet: ROADMAP queue 1 item 10",
    "shard_search": "shard fault tolerance is not ported yet: ROADMAP "
                    "queue 1 item 8",
    "shard_axes": "sharded retrieval is not ported yet: ROADMAP queue 1 "
                  "item 8",
}


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
                                # compute-bound partial-reduce tier
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
                 max_len: int, store: Optional[retrieval_mod.DataStore] = None,
                 device=None, shard_axes=(), max_queue: Optional[int] = None,
                 default_deadline_ticks: Optional[int] = None,
                 degradation: Optional[DegradationPolicy] = None,
                 fault_injector: Optional[faults_mod.FaultInjector] = None,
                 search_retries: int = 2, retry_backoff_s: float = 1e-3,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 audit_every: Optional[int] = None, tenants=None,
                 shard_search=None):
        self.device = device_mod.resolve(device)
        unported = {"degradation": degradation, "snapshot_dir": snapshot_dir,
                    "snapshot_every": snapshot_every,
                    "audit_every": audit_every, "tenants": tenants,
                    "shard_search": shard_search,
                    "shard_axes": tuple(shard_axes) or None}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(f"Server({name}=...): "
                                          f"{_UNPORTED_OPTIONS[name]}")
        if store is not None and hasattr(store, "datastore_view"):
            raise NotImplementedError(_UNPORTED_OPTIONS["audit_every"])
        if not device_mod.same(model.device, self.device):
            raise ValueError(f"the model is on {model.device}, the server "
                             f"runs on {self.device}")
        if store is not None and not device_mod.same(store.codes.device,
                                                     self.device):
            raise ValueError(f"the store is on {store.codes.device}, the "
                             f"server runs on {self.device}")
        self.cfg, self.model = cfg, model
        self.max_batch, self.max_len = max_batch, max_len
        self.store = store
        self.with_retrieval = cfg.retrieval.enabled and store is not None
        self.max_queue = max_queue
        self.default_deadline_ticks = default_deadline_ticks
        self.policy = degradation
        self.faults = fault_injector
        self.search_retries = search_retries
        self.retry_backoff_s = retry_backoff_s
        # resolve and log the retrieval QueryPlan once per store at startup
        self.retrieval_plan = None
        if self.with_retrieval:
            self.retrieval_plan = retrieval_mod.log_store_plan(
                store, cfg.retrieval, q=max_batch, logger=log)
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

    # -- degradation ladder -----------------------------------------------

    def _build_ladder(self) -> List[Rung]:
        if not self.with_retrieval:
            return [Rung("decode", False, 0)]
        return [Rung("exact", True, 0), Rung("retrieval_off", False, 0)]

    def _rung_fn(self, r: Rung):
        if r not in self._fns:
            self._fns[r] = steps_mod.make_serve_step(
                self.cfg, self.max_len, with_retrieval=r.retrieval)
        return self._fns[r]

    def _rung_plan_str(self, r: Rung) -> str:
        if not r.retrieval:
            return "retrieval_off"
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
        fn = self._rung_fn(r)
        args = (self.model, torch.from_numpy(token).to(self.device),
                self.state, torch.from_numpy(active).to(self.device))
        if r.retrieval:
            args = args + (self.store,)
        logits, self.state = fn(*args)
        return logits[:, 0, :].float().cpu().numpy()

    def _guarded_step(self, token: np.ndarray, active: np.ndarray):
        """One decode step at the current rung with the failure ladder:
        bounded retry-with-backoff -> retrieval-off failover. The
        injector's check sits BEFORE the step, so a failed attempt never
        half-advanced the decode state."""
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
        # the search is unavailable this tick: decode without retrieval
        # rather than stalling every slot
        self.counters["failover_ticks"] += 1
        self._set_rung(len(self.rungs) - 1, "search failover")
        return self._step(token, active, self.rungs[self.rung])

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
        # a reused slot restarts at position 0; stale cache rows beyond
        # ``pos`` are masked by position, so no cache wipe is needed
        pos = self.state["pos"].clone()
        pos[slot] = 0
        self.state = dict(self.state, pos=pos)
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
        if self.policy is not None and len(self.rungs) > 1:
            new = self.policy.update(self.rung, len(self.rungs),
                                     len(self.waiting), dt)
            if new != self.rung:
                why = (f"queue={len(self.waiting)} "
                       f"ewma={self.policy.ewma_s * 1e3:.1f}ms")
                self._set_rung(new, why)

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
        flight. The keys are ``repro``'s for a static store (its snapshot
        and mutable-store counters stay 0 here)."""
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
            "pending_mutations": 0,
            "store_epoch": -1,
            "compactions": c["compactions"],
            "compact_failures": c["compact_failures"],
            "flush_failures": c["flush_failures"],
            "audits": c["audits"],
            "audit_failures": c["audit_failures"],
        }
