"""Statistical activation reduction (paper §6.3) — accuracy model (port of
``repro.core.hierarchy``, copied whole: it is host math over numpy and
``math``, with the same ``np.random.default_rng(seed)`` draws).

The AP groups m Hamming/sorting-macro pairs and reports only the local top-k'
per group, cutting report bandwidth by m/k'. The result is exact iff no group
holds more than k' of the true global top-k. We reproduce the paper's Fig. 11
model analytically and by Monte Carlo.

On our side of the analogy the "group" is one device's datastore shard and
the "report bandwidth" is the all-gather payload of the distributed top-k
merge: bytes drop from O(n) to O(devices * k').
"""
from __future__ import annotations

import math

import numpy as np


def binomial_tail(k: int, r_groups: int, kprime: int) -> float:
    """P(one group holds > k' of the k global winners), winners i.i.d.
    uniform over R groups (Binomial(k, 1/R) tail)."""
    p = 1.0 / r_groups
    tail = 0.0
    for j in range(kprime + 1, k + 1):
        tail += math.comb(k, j) * p**j * (1 - p) ** (k - j)
    return tail


def failure_bound(k: int, r_groups: int, kprime: int) -> float:
    """Union bound on P(global top-k not fully recovered)."""
    return min(1.0, r_groups * binomial_tail(k, r_groups, kprime))


def failure_exact_mc(k: int, r_groups: int, kprime: int, trials: int = 10000,
                     seed: int = 0) -> float:
    """Monte Carlo estimate of the exact failure probability.

    Batched bincount (each trial's groups offset into its own id range)
    instead of a Python loop of per-trial bincounts — same draws, same
    estimate, ~trials-fold fewer interpreter round-trips. Batches are
    capped so the counts matrix stays O(batch * r_groups), not
    O(trials * r_groups)."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, r_groups, size=(trials, k))
    batch = max(1, min(trials, (1 << 22) // max(r_groups, 1)))
    fails = 0
    for t0 in range(0, trials, batch):
        g = groups[t0:t0 + batch]
        b = g.shape[0]
        offsets = np.arange(b, dtype=np.int64)[:, None] * r_groups
        counts = np.bincount((g + offsets).ravel(),
                             minlength=b * r_groups).reshape(b, r_groups)
        fails += int(np.sum(counts.max(axis=1) > kprime))
    return fails / trials


def bandwidth_reduction(m: int, kprime: int) -> float:
    """Paper's m/k' report-bandwidth reduction factor."""
    return m / kprime


def recommended_kprime(k: int, r_groups: int, max_failure: float = 0.01) -> int:
    """Smallest k' with failure bound below the target."""
    for kprime in range(1, k + 1):
        if failure_bound(k, r_groups, kprime) <= max_failure:
            return kprime
    return k
