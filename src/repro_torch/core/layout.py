"""Layout-aware datastore (port of ``repro.core.layout`` through
``original_ids``): bucket-clustered physical reordering of the packed codes.

Physically reordering the codes so that similar codes share grid tiles lets
a full fused scan prune even on uniform data: each tile then holds one
bucket's worth of mutually-near codes, so most tiles' min distance to a
query block clears the block-min bound. A :class:`BucketLayout` carries the
reordered codes plus the permutation and its inverse, so every search path
still returns ORIGINAL ids; ties at equal distance break by layout
position, not original id.

The probe masks (``probe_block_mask`` and friends), ``masked_topk`` and the
mutable ``Arena`` are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import binary


class BucketLayout(NamedTuple):
    """Bucket-contiguous physical layout of a packed datastore.

    ``codes[pos] == original_codes[perm[pos]]``; bucket ``b`` occupies the
    contiguous row range ``[starts[b], starts[b+1])`` of ``codes``.
    """

    codes: torch.Tensor     # (N, W) int32, reordered bucket-contiguous
    perm: torch.Tensor      # (N,) int32: perm[pos] = original id
    inv: torch.Tensor       # (N,) int32: inv[original id] = pos
    starts: torch.Tensor    # (B+1,) int32 bucket offsets into codes

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.starts.shape[0] - 1

    @property
    def mean_bucket_rows(self) -> int:
        return max(1, self.n // max(self.n_buckets, 1))


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """O(N) scatter inverse — ``inv[perm[pos]] = pos``."""
    n = perm.shape[0]
    inv = torch.zeros((n,), dtype=torch.int32, device=perm.device)
    inv[perm.long()] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return inv


def reorder_by_assignment(codes: torch.Tensor, assign: torch.Tensor,
                          n_buckets: int) -> BucketLayout:
    """Physically cluster ``codes`` by bucket id. assign: (N,) int in
    [0, n_buckets). Stable: within a bucket, original id order survives."""
    assign = torch.as_tensor(assign, device=codes.device).to(torch.int64)
    perm = torch.argsort(assign, stable=True).to(torch.int32)
    inv = invert_permutation(perm)
    counts = torch.bincount(assign, minlength=n_buckets)[:n_buckets]
    starts = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=codes.device),
                        torch.cumsum(counts, 0).to(torch.int32)])
    return BucketLayout(codes=codes[perm.long()], perm=perm, inv=inv,
                        starts=starts)


def hamming_prefix_assign(codes: torch.Tensor, d: int, bits: int,
                          positions: torch.Tensor | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure-Hamming bucketing — no float vectors required.

    Picks the ``bits`` most *balanced* bit positions (empirical mean
    closest to 1/2) and groups codes by that key. The means are exact
    integer counts times the f32 reciprocal of N — how ``jnp.mean``
    computes them on XLA's CPU backend — so equal and near-equal means
    order identically in both packages and ``perm`` agrees bit-for-bit.

    Returns (assign (N,) int32 in [0, 2^bits), positions (bits,) int32)."""
    b = binary.unpack_bits(codes, d)                       # (N, d)
    if positions is None:
        n = b.shape[0]
        recip = torch.tensor(np.float32(1.0) / np.float32(n),
                             dtype=torch.float32, device=b.device)
        means = b.sum(dim=0, dtype=torch.int64).to(torch.float32) * recip
        positions = torch.argsort(torch.abs(means - 0.5),
                                  stable=True)[:bits].to(torch.int32)
    sel = b[:, positions.long()].to(torch.int32)           # (N, bits)
    weights = 1 << torch.arange(positions.shape[0], dtype=torch.int32,
                                device=b.device)
    return (sel * weights).sum(dim=-1, dtype=torch.int32), positions


def default_bits(n: int) -> int:
    """Heuristic key width for the Hamming fallback: ~256 rows per bucket,
    clamped to [1, 12]."""
    return max(1, min(12, int(np.log2(max(n // 256, 2)))))


def build_layout(codes: torch.Tensor, d: int, n_buckets: int | None = None,
                 assign: torch.Tensor | None = None) -> BucketLayout:
    """Build a bucket-clustered layout. With ``assign`` (e.g. k-means/IVF
    cluster ids) the reorder follows the index's own buckets (``n_buckets``
    defaults to max(assign) + 1); without, the pure-Hamming prefix fallback
    buckets by LSH key. Runs on the codes' device."""
    if assign is None:
        bits = (n_buckets - 1).bit_length() if n_buckets else (
            default_bits(codes.shape[0]))
        assign, _ = hamming_prefix_assign(codes, d, bits)
        n_buckets = 1 << bits
    else:
        assign = torch.as_tensor(assign, device=codes.device)
        hi = int(assign.max()) + 1
        n_buckets = hi if n_buckets is None else n_buckets
        # an out-of-range bucket id would fall off `starts` and its rows
        # would silently vanish from every masked probe — refuse instead
        if hi > n_buckets:
            raise ValueError(f"assign ids reach {hi - 1} >= {n_buckets}")
        if int(assign.min()) < 0:
            raise ValueError("negative bucket id")
    return reorder_by_assignment(codes, assign, n_buckets)


def local_sort(codes: torch.Tensor, d: int, bits: int | None = None,
               n_valid=None):
    """Reorder by ``bits`` evenly spaced code bits (static positions) and
    stable-sort. Returns (codes_sorted, perm) with perm[pos] = local id.

    ``n_valid``: rows at local id >= n_valid are padding — their key is
    forced past every real key, so they stay at positions [n_valid, n)."""
    n = codes.shape[0]
    bits = bits if bits is not None else default_bits(n)
    bits = max(1, min(bits, d))
    positions = torch.arange(bits, dtype=torch.int64,
                             device=codes.device) * (d // bits)
    b = binary.unpack_bits(codes, d)[:, positions].to(torch.int32)
    weights = 1 << torch.arange(bits, dtype=torch.int32, device=codes.device)
    key = (b * weights).sum(dim=-1, dtype=torch.int32)
    if n_valid is not None:
        key = torch.where(torch.arange(n, device=codes.device) < int(n_valid),
                          key, 1 << 30)
    perm = torch.argsort(key, stable=True).to(torch.int32)
    return codes[perm.long()], perm


def to_original_ids(perm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Map layout positions to original ids through ``perm``; sentinel rows
    (position >= N) pass through unchanged."""
    n = perm.shape[0]
    return torch.where(ids < n, perm[torch.clamp(ids, max=n - 1).long()], ids)


def original_ids(layout: BucketLayout, dists: torch.Tensor, ids: torch.Tensor,
                 d: int) -> torch.Tensor:
    """Map kernel-space positions back to original ids; sentinel slots
    (dist > d or position >= N) become -1."""
    real = (ids < layout.n) & (dists <= d)
    return torch.where(real, to_original_ids(layout.perm, ids), -1)
