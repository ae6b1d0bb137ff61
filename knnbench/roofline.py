"""The least time one exact Hamming kNN search needs on one H100, counted
from the algorithm's work and not from any kernel's.

Every (query, stored code) pair is scored once. The compute term takes 2·d
operations a pair, a ±1 int8 plane product on the tensor cores, at the
data sheet's dense int8 rate. The bytes term reads the codes and the
queries once and writes the (dists, ids) answer once, at the HBM rate. The
least time is the larger of the two, so a share of it reads the same
whatever kernels do the search, fused or split.

The peaks are a frozen copy of the program's constants (NVIDIA H100 SXM
data sheet, dense rates, 700 W); they are not imported. The card's b1
``mma`` (AND and popcount) has no data-sheet rate: a share near 100 % means
this count is to be revisited, not that the card beat its peak.
"""
from __future__ import annotations

INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12
WORD_BYTES = 4
ANSWER_BYTES = 8          # an int32 distance and an int32 id per slot


def search_ops(q: int, n: int, d: int) -> float:
    return 2.0 * d * q * n


def search_bytes(q: int, n: int, d: int, k: int) -> float:
    words = d // 32
    return float(WORD_BYTES * words * (n + q) + ANSWER_BYTES * q * k)


def least_seconds(q: int, n: int, d: int, k: int) -> float:
    """The larger of the compute and the bytes term, in seconds."""
    return max(search_ops(q, n, d) / INT8_OPS_PER_S,
               search_bytes(q, n, d, k) / HBM_BYTES_PER_S)

