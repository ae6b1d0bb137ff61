"""The comparison that decides ``correct``.

Every answer the window produced is checked for form on the host: its
shape, distances ascending and within [0, d], ids within [0, n) and
distinct in a row. A sample of ``CHECK_ROWS`` answered queries, drawn from
the seed over all answers of the window, is then held exactly against the
configuration's plain reference over the benchmark's own codes: the k
distances must equal the reference's k smallest, and each returned id's
own distance, worked out by the reference, must equal the one reported.
Ties at the k-th distance may be broken by any rule, so ids are judged by
their distances, not by name.

Each number compared is a count of wrong rows, and its limit is 0: the
configuration states an exact search.
"""
from __future__ import annotations

import numpy as np
import torch

CHECK_ROWS = 512
LIMITS = {"rows_malformed": 0, "sample_dist_rows_wrong": 0,
          "sample_id_rows_wrong": 0}


def malformed_rows(dd: np.ndarray, ii: np.ndarray, d: int, n: int,
                   k: int) -> np.ndarray:
    """(B,) bool: rows of one answer that break the contract's form."""
    bad = np.zeros(dd.shape[0], dtype=bool)
    bad |= (dd < 0).any(axis=1) | (dd > d).any(axis=1)
    bad |= (ii < 0).any(axis=1) | (ii >= n).any(axis=1)
    if k > 1:
        bad |= (np.diff(dd, axis=1) < 0).any(axis=1)
        srt = np.sort(ii, axis=1)
        bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    return bad


def check(results, batches, codes: torch.Tensor, reference, d: int, k: int,
          seed: int, check_rows: int = CHECK_ROWS):
    """``results``: [(i, dists (B', k'), ids (B', k'))] host tensors of the
    window, in order; ``batches(i)`` the host queries batch i was.
    Returns (counts {name: int}, failed batches, rows sampled)."""
    n = codes.shape[0]
    malformed = 0
    failed = 0
    sizes = []
    for i, dd, ii in results:
        b = batches(i).shape[0]
        if tuple(dd.shape) != (b, k) or tuple(ii.shape) != (b, k):
            malformed += b
            failed += 1
            sizes.append(0)
            continue
        bad = int(malformed_rows(dd.numpy(), ii.numpy(), d, n, k).sum())
        malformed += bad
        failed += bad > 0
        sizes.append(b)
    total = sum(sizes)
    take = min(check_rows, total)
    rng = np.random.default_rng([seed, 2])
    flat = np.sort(rng.choice(total, size=take, replace=False))
    starts = np.cumsum([0] + sizes)
    which = np.searchsorted(starts, flat, side="right") - 1
    q_rows, d_rows, i_rows = [], [], []
    for j, r in zip(which.tolist(), (flat - starts[which]).tolist()):
        i, dd, ii = results[j]
        q_rows.append(batches(i)[r])
        d_rows.append(dd[r])
        i_rows.append(ii[r])
    counts = dict.fromkeys(LIMITS, 0)
    counts["rows_malformed"] = malformed
    if take:
        q = torch.stack(q_rows)
        got_d = torch.stack(d_rows).to(torch.int32)
        got_i = torch.stack(i_rows).to(torch.int64)
        want_d = reference.knn_distances(q, codes, k).cpu()
        counts["sample_dist_rows_wrong"] = int(
            (got_d != want_d).any(dim=1).sum())
        in_range = ((got_i >= 0) & (got_i < n)).all(dim=1)
        ids = torch.where(in_range[:, None], got_i, 0)
        true_d = reference.distances_of(q, codes, ids).cpu()
        srt = torch.sort(ids, dim=1).values
        distinct = ~(srt[:, 1:] == srt[:, :-1]).any(dim=1)
        ok = in_range & distinct & (true_d == got_d).all(dim=1)
        counts["sample_id_rows_wrong"] = int((~ok).sum())
    return counts, failed, take


def verdict(counts: dict) -> bool:
    return all(counts[name] <= limit for name, limit in LIMITS.items())


def lines(counts: dict) -> list:
    """Each number compared beside its limit, one per line."""
    return [f"check {name} {counts[name]} limit {LIMITS[name]}"
            for name in LIMITS]


def as_json(counts: dict) -> dict:
    return {name: {"value": counts[name], "limit": LIMITS[name]}
            for name in LIMITS}
