"""Bounded-domain top-k selection (port of ``repro.core.topk``).

The counting select of the paper's temporal sort:

  1. histogram the distances over their d+1 possible values   (the "race")
  2. a cumulative count locates the k-th smallest radius r*   (the "finish line")
  3. one masked pass emits ids with dist <= r*                (the "reports")

Contract shared with ``repro``: ascending distances, ties broken by index
order, rows beyond min(k, N) padded with (d_max+1, N). Every sort here is a
stable sort followed by a gather, the counterpart of ``jax.lax.sort_key_val``.
"""
from __future__ import annotations

import torch


def sort_key_val(keys: torch.Tensor, vals: torch.Tensor):
    """Stable sort of ``keys`` along the last axis, carrying ``vals``."""
    keys, order = torch.sort(keys, dim=-1, stable=True)
    return keys, torch.gather(vals, -1, order)


def topk_ref(dist: torch.Tensor, k: int):
    """Sorted-oracle reference. dist: (Q, N) -> (dists (Q,k), ids (Q,k))."""
    order = torch.argsort(dist, dim=-1, stable=True)[:, :k]
    return torch.gather(dist, -1, order), order.to(torch.int32)


def counting_topk(dist: torch.Tensor, k: int, d_max: int):
    """Counting-select top-k over integer distances in [0, d_max].

    dist: (Q, N) int32 -> (dists (Q,k) ascending, ids (Q,k) int32).
    Rows with N < k are padded with (d_max+1, N)."""
    Q, N = dist.shape
    dev = dist.device
    k_eff = min(k, N)
    bins = d_max + 1

    # 1. histogram (the temporal race, binned by arrival time = distance)
    hist = torch.zeros((Q, bins), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, dist.long(), torch.ones_like(dist, dtype=torch.int32))
    cum = torch.cumsum(hist, dim=-1, dtype=torch.int32)
    # 2. k-th smallest radius r*: first bin where cum >= k (cum is
    #    nondecreasing, so that is the count of bins still below k)
    r_star = (cum < k_eff).sum(dim=-1, dtype=torch.int32)          # (Q,)

    # 3. emit: all ids with dist < r* (they number < k by construction), then
    #    fill the remaining slots with r*-ties in index order
    mask_lt = dist < r_star[:, None]
    mask_tie = dist == r_star[:, None]
    n_lt = mask_lt.sum(dim=-1, keepdim=True, dtype=torch.int32)
    rank_lt = torch.cumsum(mask_lt, dim=-1, dtype=torch.int32) - 1
    rank_tie = torch.cumsum(mask_tie, dim=-1, dtype=torch.int32) - 1 + n_lt
    slot = torch.where(mask_lt, rank_lt,
                       torch.where(mask_tie & (rank_tie < k), rank_tie, k))
    # slot k is the drop column: scatter there, then cut it off
    out_d = torch.full((Q, k + 1), d_max + 1, dtype=dist.dtype, device=dev)
    out_i = torch.full((Q, k + 1), N, dtype=torch.int32, device=dev)
    ids = torch.arange(N, dtype=torch.int32, device=dev).expand(Q, N)
    out_d.scatter_(1, slot.long(), dist)
    out_i.scatter_(1, slot.long(), ids)
    # final O(k log k) ordering of the k winners
    return sort_key_val(out_d[:, :k], out_i[:, :k])


def counting_topk_bisect(dist: torch.Tensor, k: int, d_max: int):
    """Scatter-free counting select: binary-search the radius r* over the
    bounded domain [0, d_max] with vectorized counts, then emit winners by
    searchsorted on the rank cumsum.

    Same semantics as ``counting_topk`` (ascending, ties by index order)."""
    Q, N = dist.shape
    dev = dist.device
    k_eff = min(k, N)

    # 1. binary search for r* = k-th smallest distance (the "finish line")
    lo = torch.zeros((Q,), dtype=torch.int32, device=dev)
    hi = torch.full((Q,), d_max, dtype=torch.int32, device=dev)
    for _ in range(max(1, (d_max + 1).bit_length())):
        mid = (lo + hi) // 2
        cnt = (dist <= mid[:, None]).sum(dim=1, dtype=torch.int32)
        hi = torch.where(cnt >= k_eff, mid, hi)
        lo = torch.where(cnt >= k_eff, lo, mid + 1)
    r_star = hi

    # 2. emit: strict-inside ids first, then r*-ties in index order
    mask_lt = dist < r_star[:, None]
    mask_tie = dist == r_star[:, None]
    cum_lt = torch.cumsum(mask_lt, dim=1, dtype=torch.int64)
    cum_tie = torch.cumsum(mask_tie, dim=1, dtype=torch.int64)
    n_lt = cum_lt[:, -1]

    slots = torch.arange(k, dtype=torch.int64, device=dev)
    want_lt = slots[None, :] < n_lt[:, None]                   # (Q, k)
    target_lt = torch.minimum(slots[None, :] + 1,
                              torch.clamp(n_lt, min=1)[:, None])
    target_tie = slots[None, :] + 1 - n_lt[:, None]

    pos_lt = torch.searchsorted(cum_lt, target_lt, side="left")
    pos_tie = torch.searchsorted(cum_tie, torch.clamp(target_tie, min=1),
                                 side="left")
    pos = torch.where(want_lt, pos_lt, pos_tie)
    valid = slots[None, :] < torch.clamp(n_lt + cum_tie[:, -1],
                                         max=k_eff)[:, None]
    pos_c = torch.clamp(pos, max=N - 1)
    out_d = torch.where(valid, torch.gather(dist, 1, pos_c), d_max + 1)
    out_i = torch.where(valid, pos_c, N).to(torch.int32)
    # final O(k log k) ordering (stable: equal distances stay in index order)
    return sort_key_val(out_d, out_i)


def composite_topk(dist: torch.Tensor, k: int, d_max: int):
    """Exact top-k via one float ``topk`` over the composite key
    dist*N + idx (lexicographic; ties by index order — identical semantics
    to the counting selects). Requires (d_max+1)*N < 2^24 so the key is
    exactly representable in f32; falls back to the bisection counting
    select above that."""
    Q, N = dist.shape
    if (d_max + 1) * N >= (1 << 24):
        return counting_topk_bisect(dist, k, d_max)
    k_eff = min(k, N)
    idx = torch.arange(N, dtype=torch.int32, device=dist.device)
    key = dist.to(torch.float32) * N + idx
    neg_key, _ = torch.topk(-key, k_eff, dim=-1, largest=True, sorted=True)
    key_k = (-neg_key).to(torch.int32)
    out_d = torch.div(key_k, N, rounding_mode="floor")
    out_i = key_k % N
    if k_eff < k:
        pad_d = torch.full((Q, k - k_eff), d_max + 1, dtype=out_d.dtype,
                           device=dist.device)
        pad_i = torch.full((Q, k - k_eff), N, dtype=torch.int32,
                           device=dist.device)
        out_d = torch.cat([out_d, pad_d], dim=1)
        out_i = torch.cat([out_i, pad_i], dim=1)
    return out_d, out_i


def merge_topk(d1, i1, d2, i2, k: int):
    """Merge two sorted top-k candidate sets (the chunked-scan merge —
    O(k), not O(n))."""
    d, i = sort_key_val(torch.cat([d1, d2], dim=-1), torch.cat([i1, i2], dim=-1))
    return d[..., :k], i[..., :k]


def bucketed_topk(values: torch.Tensor, k: int, n_bins: int = 256):
    """Approximate top-k of *float* values via the same counting-select,
    after quantizing each row onto n_bins buckets.

    Returns (values (Q,k) descending, ids). Exact when k-th and (k+1)-th
    values land in different buckets."""
    lo = values.amin(dim=-1, keepdim=True)
    hi = values.amax(dim=-1, keepdim=True)
    # invert so that "largest value" -> "smallest bucket"
    q = ((hi - values) / torch.clamp(hi - lo, min=1e-9)
         * (n_bins - 1)).to(torch.int32)
    _, ids = counting_topk(q, k, n_bins - 1)
    vals = torch.gather(values, -1, ids.long())
    order = torch.argsort(-vals, dim=-1, stable=True)
    return torch.gather(vals, -1, order), torch.gather(ids, -1, order)
