"""Seeded fault injection and bounded retry for the serving/checkpoint path
(``repro.runtime.faults``, copied whole: it is pure Python).

The injector is probability-per-call and fully seeded: a soak run with the
same seed injects the same fault sequence, so "survives 500 ticks at
p=0.05" is a reproducible pin, not a flake. Sites are plain strings — the
server uses ``store_search`` around the retrieval step and
``ckpt_save``/``ckpt_restore`` through the checkpoint manager's
``fault_hook`` seam; the mutable datastore (core/mutable.py) adds
``wal_append`` (before the intent-log write — a fired fault means the
mutation was never acked), ``compact_build`` (before the rebuilt arena is
swapped in), and ``epoch_install`` (before a fresh epoch is swapped in).
The shard-fault-tolerance layer (dist/search.py) adds ``shard_hist``
(before a unit's pass-1 histogram), ``shard_emit`` (before a unit's
pass-2 winner emission) and ``merge_psum`` (before each hierarchical
host-merge round) — all scoped per unit via ``site@unit`` so a soak can
kill exactly one shard's calls while the fleet runs the base rate.

Multi-tenant scoping (core/tenant.py): a site may be scoped to one tenant
as ``"<site>@<tenant>"`` (:func:`site_key`). ``check(site, tenant=...)``
looks the scoped key up first and falls back to the base site's
probability, so a soak can poison exactly one tenant's WAL writes while
every other tenant runs the shared base rate — and the per-site counters
are kept under the scoped key, so blast-radius assertions can attribute
every fired fault to the tenant it hit.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional, Tuple


class InjectedFault(RuntimeError):
    """A fault raised by the injector (always transient by construction)."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site!r}")
        self.site = site


# Exception classes the retry loops treat as transient. Anything else is a
# real bug and must propagate — retrying around it would hide it.
TRANSIENT = (InjectedFault, TimeoutError, ConnectionError)


def site_key(site: str, tenant: Optional[str] = None) -> str:
    """Canonical key for a (site, tenant) pair: ``site`` bare, or
    ``site@tenant`` when scoped to one tenant of a multi-tenant arena."""
    return site if tenant is None else f"{site}@{tenant}"


class FaultInjector:
    """Seeded probability-per-call fault injector.

    ``p`` maps site -> probability a call at that site raises
    ``InjectedFault``; ``stall`` maps site -> (probability, seconds) a call
    sleeps before proceeding (a slow store, not a dead one). Counters per
    site (``calls``/``fired``/``stalled``) let tests assert faults actually
    exercised the path under test.
    """

    def __init__(self, seed: int = 0,
                 p: Optional[Mapping[str, float]] = None,
                 stall: Optional[Mapping[str, Tuple[float, float]]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        import numpy as np
        self._rng = np.random.default_rng(seed)
        self.p: Dict[str, float] = dict(p or {})
        self.stall: Dict[str, Tuple[float, float]] = dict(stall or {})
        self._sleep = sleep
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self.stalled: Dict[str, int] = {}

    def check(self, site: str, tenant: Optional[str] = None) -> None:
        """Maybe stall, maybe raise — call at the top of a faultable op.

        With ``tenant``, the scoped ``site@tenant`` probability wins when
        configured, else the base site's rate applies; counters always land
        under the scoped key so fired faults stay attributable."""
        key = site_key(site, tenant)
        self.calls[key] = self.calls.get(key, 0) + 1
        sp = self.stall.get(key, self.stall.get(site) if tenant else None)
        if sp is not None and self._rng.random() < sp[0]:
            self.stalled[key] = self.stalled.get(key, 0) + 1
            self._sleep(sp[1])
        prob = self.p.get(key, self.p.get(site, 0.0) if tenant else 0.0)
        if self._rng.random() < prob:
            self.fired[key] = self.fired.get(key, 0) + 1
            raise InjectedFault(key)

    def hook(self, site: str,
             tenant: Optional[str] = None) -> Callable[[], None]:
        """Zero-arg adapter for ``fault_hook`` seams (checkpoint manager)."""
        return lambda: self.check(site, tenant)


def retry_call(fn: Callable, *, retries: int = 2, backoff_s: float = 1e-3,
               max_backoff_s: float = 0.05, transient=TRANSIENT,
               on_retry: Optional[Callable] = None,
               sleep: Callable[[float], None] = time.sleep,
               jitter: str = "full", rng=None,
               deadline_s: Optional[float] = None,
               clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` with up to ``retries`` retries on transient errors;
    the last error re-raises.

    Backoff is FULL-JITTERED by default: attempt ``i`` sleeps
    ``U(0, min(max_backoff_s, backoff_s * 2**i))`` — the exponential
    envelope caps at ``max_backoff_s`` (the max-delay cap) and the uniform
    draw decorrelates the many slots that all hit the same recovering
    store at once; plain synchronized doubling would have every retry
    stampede it on the same schedule. ``jitter="none"`` keeps the legacy
    deterministic doubling (still capped). ``rng`` seeds the draws (an int
    or a numpy Generator) so fault soaks stay reproducible.

    ``deadline_s`` is the caller's REMAINING request budget, measured on
    ``clock`` from entry: every backoff sleep is clamped to the budget
    left after the failing attempt, and once the budget is exhausted the
    next transient error re-raises immediately instead of sleeping — the
    retry envelope can never push a request past its deadline. (Attempts
    themselves are not interrupted; the budget bounds the sleep schedule,
    which is what backoff adds on top of the caller's own work.)"""
    assert jitter in ("full", "none"), jitter
    if jitter == "full":
        import numpy as np
        if not hasattr(rng, "uniform"):
            rng = np.random.default_rng(rng)
    t0 = clock() if deadline_s is not None else 0.0
    delay = min(backoff_s, max_backoff_s)
    for attempt in range(retries + 1):
        try:
            return fn()
        except transient as e:
            if attempt == retries:
                raise
            want = rng.uniform(0.0, delay) if jitter == "full" else delay
            if deadline_s is not None:
                remaining = deadline_s - (clock() - t0)
                if remaining <= 0.0:
                    raise
                want = min(want, remaining)
            if on_retry is not None:
                on_retry(e, attempt)
            sleep(want)
            delay = min(delay * 2.0, max_backoff_s)
