"""Shard-health registry + coverage accounting for distributed search
(port of ``repro.dist.health``, copied whole: it is pure Python).

The paper's AP ranks — and the Pohoiki Springs-style fleets the ROADMAP
scales toward — are physically independent search units; at production
scale individual units stall, die and come back. This module is the
bookkeeping half of the fault-tolerance layer: a tiny, dependency-free
state machine per shard (healthy -> suspect -> dead -> recovering) driven
by per-call deadlines, and the ``CoverageReport`` every degraded answer
carries so callers know EXACTLY what was searched (the answer itself stays
bit-identical to a from-scratch search over the surviving rows — the
participation-mask contract of ``ops.hamming_topk_sharded`` and the host
orchestrator in dist/search.py).

State machine (per shard):

- ``healthy``: serving. A failure (exception, injected fault, or latency
  over ``deadline_s``) moves to ``suspect`` after ``suspect_after``
  consecutive failures.
- ``suspect``: still serving (its rows still count toward coverage), but
  one more success restores ``healthy`` while reaching ``dead_after``
  consecutive failures declares it ``dead``.
- ``dead``: excluded from every search (participation mask zero; its
  primary row ranges fail over to replicas or drop out of coverage).
  ``revive()`` — the unit came back empty — moves to ``recovering``.
- ``recovering``: not serving yet; background re-replication refills it
  and ``mark_recovered()`` (or ``recover_probes`` consecutive successful
  probes) restores ``healthy``.

``kill()`` force-marks ``dead`` immediately (the bench's mid-stream
kill switch and the server's shard-loss rung both use it).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Tuple

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
RECOVERING = "recovering"

STATES = (HEALTHY, SUSPECT, DEAD, RECOVERING)


@dataclasses.dataclass
class ShardHealth:
    """One shard's view: current state + the counters that drive it."""

    state: str = HEALTHY
    consec_failures: int = 0
    consec_successes: int = 0
    failures: int = 0
    successes: int = 0
    deadline_misses: int = 0
    last_latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class CoverageReport:
    """What one answer actually searched.

    ``coverage_frac`` applies to every query in the batch (the whole batch
    races over the same surviving rows), so a response's per-query
    coverage IS this fraction; ``dead_shards`` names the units whose rows
    were excluded. ``covered_rows == total_rows`` (frac 1.0) is the
    healthy fast path. The contract: the degraded answer is bit-identical
    to a from-scratch search over exactly ``covered_rows`` rows — coverage
    is never silently under- (or over-) reported."""

    covered_rows: int
    total_rows: int
    dead_shards: Tuple[str, ...] = ()

    @property
    def coverage_frac(self) -> float:
        if self.total_rows <= 0:
            return 1.0 if not self.dead_shards else 0.0
        return self.covered_rows / self.total_rows

    @property
    def complete(self) -> bool:
        return self.covered_rows == self.total_rows

    def as_dict(self) -> dict:
        return {"covered_rows": int(self.covered_rows),
                "total_rows": int(self.total_rows),
                "coverage_frac": float(self.coverage_frac),
                "dead_shards": list(self.dead_shards)}


class HealthRegistry:
    """Deadline-driven shard state machine; thread-safe (the server's tick
    loop observes from worker threads while ``stats()`` snapshots)."""

    def __init__(self, units: Iterable[str], *, deadline_s: float = 0.05,
                 suspect_after: int = 1, dead_after: int = 3,
                 recover_probes: int = 2):
        if suspect_after < 1 or dead_after < suspect_after:
            raise ValueError(f"need 1 <= suspect_after <= dead_after, got "
                             f"{suspect_after}/{dead_after}")
        self.deadline_s = float(deadline_s)
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.recover_probes = int(recover_probes)
        self._lock = threading.Lock()
        self._shards: Dict[str, ShardHealth] = {
            str(u): ShardHealth() for u in units}
        self.transitions: List[Tuple[str, str, str]] = []

    # -- bookkeeping -------------------------------------------------------

    def _get(self, unit: str) -> ShardHealth:
        try:
            return self._shards[unit]
        except KeyError:
            raise KeyError(f"unknown shard {unit!r}; known: "
                           f"{sorted(self._shards)}") from None

    def _move(self, unit: str, h: ShardHealth, to: str) -> None:
        if h.state != to:
            self.transitions.append((unit, h.state, to))
            h.state = to

    # -- observations ------------------------------------------------------

    def observe(self, unit: str, ok: bool, latency_s: float = 0.0) -> str:
        """Record one call against ``unit``; returns the new state.
        ``ok=True`` with ``latency_s`` over the deadline counts as a
        FAILURE — a stalled shard is as gone as a crashed one."""
        with self._lock:
            h = self._get(unit)
            h.last_latency_s = float(latency_s)
            missed = ok and latency_s > self.deadline_s
            if missed:
                h.deadline_misses += 1
            if ok and not missed:
                h.successes += 1
                h.consec_successes += 1
                h.consec_failures = 0
                if h.state == SUSPECT:
                    self._move(unit, h, HEALTHY)
                elif (h.state == RECOVERING
                      and h.consec_successes >= self.recover_probes):
                    self._move(unit, h, HEALTHY)
            else:
                h.failures += 1
                h.consec_failures += 1
                h.consec_successes = 0
                if h.state == RECOVERING:
                    self._move(unit, h, DEAD)
                elif h.state in (HEALTHY, SUSPECT):
                    if h.consec_failures >= self.dead_after:
                        self._move(unit, h, DEAD)
                    elif h.consec_failures >= self.suspect_after:
                        self._move(unit, h, SUSPECT)
            return h.state

    def kill(self, unit: str) -> None:
        """Force-mark dead NOW (mid-stream kill / operator action)."""
        with self._lock:
            h = self._get(unit)
            self._move(unit, h, DEAD)
            h.consec_successes = 0

    def revive(self, unit: str) -> None:
        """The unit process is back — EMPTY. It must re-replicate before
        its rows count again: dead -> recovering."""
        with self._lock:
            h = self._get(unit)
            if h.state == DEAD:
                self._move(unit, h, RECOVERING)
                h.consec_failures = 0
                h.consec_successes = 0

    def mark_recovered(self, unit: str) -> None:
        """Re-replication refilled the unit: recovering -> healthy."""
        with self._lock:
            h = self._get(unit)
            if h.state == RECOVERING:
                self._move(unit, h, HEALTHY)
                h.consec_failures = 0

    # -- queries -----------------------------------------------------------

    def state(self, unit: str) -> str:
        with self._lock:
            return self._get(unit).state

    def serving(self) -> List[str]:
        """Units whose rows count toward coverage (healthy + suspect —
        a suspect shard still answers; only dead/recovering are out)."""
        with self._lock:
            return [u for u, h in self._shards.items()
                    if h.state in (HEALTHY, SUSPECT)]

    def dead(self) -> List[str]:
        with self._lock:
            return [u for u, h in self._shards.items() if h.state == DEAD]

    def not_serving(self) -> List[str]:
        with self._lock:
            return [u for u, h in self._shards.items()
                    if h.state in (DEAD, RECOVERING)]

    def snapshot(self) -> dict:
        """``stats()["shards"]`` surface: per-unit state + counters."""
        with self._lock:
            return {
                "deadline_s": self.deadline_s,
                "states": {u: h.state for u, h in self._shards.items()},
                "counters": {u: {"failures": h.failures,
                                 "successes": h.successes,
                                 "deadline_misses": h.deadline_misses,
                                 "consec_failures": h.consec_failures}
                             for u, h in self._shards.items()},
                "n_serving": sum(h.state in (HEALTHY, SUSPECT)
                                 for h in self._shards.values()),
                "n_dead": sum(h.state == DEAD
                              for h in self._shards.values()),
                "n_recovering": sum(h.state == RECOVERING
                                    for h in self._shards.values()),
                "transitions": list(self.transitions[-32:]),
            }


__all__ = ["CoverageReport", "DEAD", "HEALTHY", "HealthRegistry",
           "RECOVERING", "STATES", "SUSPECT", "ShardHealth"]
