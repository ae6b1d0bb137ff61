"""Plain reference of exact Hamming kNN: XOR and popcount of every
(query, stored code) pair, then the k smallest distances.

It imports only torch. It takes the codes and queries the benchmark made,
never anything the program made, and computes on whatever device they are
on, in blocks of queries and rows so that the (queries, rows) distance
block stays under ``BLOCK_ELEMS`` elements.
"""
from __future__ import annotations

import torch

BLOCK_ELEMS = 1 << 27
_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (sign bit included) -> int32 in [0, 32].
    Arithmetic shifts smear the sign bit only into bits that the masks
    clear."""
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def distances(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S, W) x (R, W) int32 codes -> (S, R) int32 Hamming distances."""
    out = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.int32,
                      device=x.device)
    for w in range(q.shape[1]):
        out += popcount(q[:, w, None] ^ x[None, :, w])
    return out


def knn_distances(q: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest distances of each query over every row of ``x``,
    ascending: (S, k) int32. Requires k <= rows."""
    q = q.to(device=x.device, dtype=torch.int32)
    if k > x.shape[0]:
        raise ValueError(f"k={k} exceeds the {x.shape[0]} rows")
    s_blk = max(1, min(q.shape[0], 64))
    r_blk = max(k, BLOCK_ELEMS // s_blk)
    out = []
    for s0 in range(0, q.shape[0], s_blk):
        qb = q[s0:s0 + s_blk]
        best = None
        for r0 in range(0, x.shape[0], r_blk):
            dist = distances(qb, x[r0:r0 + r_blk])
            kk = min(k, dist.shape[1])
            top = torch.topk(dist, kk, dim=1, largest=False).values
            best = top if best is None else torch.cat([best, top], dim=1)
            best = torch.topk(best, min(k, best.shape[1]), dim=1,
                              largest=False).values
        out.append(torch.sort(best, dim=1).values)
    return torch.cat(out)


def distances_of(q: torch.Tensor, x: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Distance of each query to each of its listed rows: q (S, W), ids
    (S, k) in [0, rows) -> (S, k) int32."""
    q = q.to(device=x.device, dtype=torch.int32)
    rows = x[ids.to(device=x.device, dtype=torch.int64)]        # (S, k, W)
    return popcount(rows ^ q[:, None, :]).sum(dim=2, dtype=torch.int32)
