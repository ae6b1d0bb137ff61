"""The benchmark's one traffic generator: the query pool and the order of
its batches, made on the device from ``--seed``. A traffic file's
parameters are all it reads, so a new mix is a new data file:

* ``queries``: ``"store"`` draws fresh codes from the store's own process
  (``Store.sample`` of ``stores/<codes.kind>.py``), ``"uniform"`` draws
  uniformly random codes.
* ``batch`` and ``pool_queries``: the pool holds ``pool_queries`` codes on
  the host; batch ``i`` of a window is slice ``order[i % nb]`` of it,
  ``order`` a seeded permutation of its ``nb`` batches. Every seed sends
  the same sizes in the same loop, in another order.

Packed codes are int32 words, 32 bits each, as the program takes them.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32
# the query generator's seed is the store's plus this
QUERY_SEED_OFFSET = 0x9E3779B9


def words_of(d: int) -> int:
    if d <= 0 or d % WORD:
        raise ValueError(f"d must be a positive multiple of {WORD}, got {d}")
    return d // WORD


def random_words(g: torch.Generator, rows: int, w: int) -> torch.Tensor:
    """(rows, w) int32 of uniformly random bits, in one call."""
    return torch.randint(0, 256, (rows, 4 * w), dtype=torch.uint8,
                         generator=g, device=g.device).view(torch.int32)


def make_pool(traffic: dict, store, seed: int,
              pool_queries: int | None = None) -> torch.Tensor:
    """The traffic's query pool, made on the store's device and returned
    on the host: (pool, W) int32, a whole number of batches."""
    batch = traffic["batch"]
    pool = traffic["pool_queries"] if pool_queries is None else pool_queries
    pool = max(batch, pool // batch * batch)
    g = torch.Generator(device=store.codes.device).manual_seed(
        seed + QUERY_SEED_OFFSET)
    kind = traffic["queries"]
    if kind == "store":
        q = store.sample(g, pool)
    elif kind == "uniform":
        q = random_words(g, pool, store.codes.shape[1])
    else:
        raise ValueError(f"unknown queries kind {kind!r}")
    return q.cpu()


class Batches:
    """Batch ``i`` of the closed loop: a view of the host pool."""

    def __init__(self, pool: torch.Tensor, batch: int, seed: int):
        self.pool, self.batch = pool, batch
        self.order = np.random.default_rng([seed, 1]).permutation(
            pool.shape[0] // batch)

    def __call__(self, i: int) -> torch.Tensor:
        s = int(self.order[i % len(self.order)]) * self.batch
        return self.pool[s:s + self.batch]
