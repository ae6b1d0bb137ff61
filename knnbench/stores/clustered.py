"""A synthetic store made on the device from ``--seed``: a configuration
whose ``codes.kind`` is ``"clustered"``.

``codes.centres`` random codes; every stored code is a centre drawn
uniformly with each bit flipped with probability ``2 ** -codes.flip_log2``
(the AND of ``flip_log2`` random words). ``Store.sample`` draws fresh codes
from the same process (same centres, new owners and flips): the traffic's
``"store"`` queries.
"""
from __future__ import annotations

import torch

from knnbench import gen


def clustered(g: torch.Generator, rows: int, centres: torch.Tensor,
              flip_log2: int) -> torch.Tensor:
    """``rows`` codes, each a random centre with every bit flipped with
    probability 2 ** -flip_log2."""
    owner = torch.randint(0, centres.shape[0], (rows,), generator=g,
                          device=g.device)
    noise = gen.random_words(g, rows, centres.shape[1])
    for _ in range(flip_log2 - 1):
        noise &= gen.random_words(g, rows, centres.shape[1])
    return centres[owner] ^ noise


class Store:
    """The stored codes and what drawing more from their process needs."""

    def __init__(self, codes: torch.Tensor, centres: torch.Tensor,
                 flip_log2: int):
        self.codes, self.centres, self.flip_log2 = codes, centres, flip_log2

    def sample(self, g: torch.Generator, rows: int) -> torch.Tensor:
        return clustered(g, rows, self.centres, self.flip_log2)


def make(cfg: dict, seed: int, device, n: int) -> Store:
    """``n`` codes of ``cfg["d"]`` bits on ``device``."""
    spec = cfg["codes"]
    g = torch.Generator(device=device).manual_seed(seed)
    centres = gen.random_words(g, spec["centres"], gen.words_of(cfg["d"]))
    return Store(clustered(g, n, centres, spec["flip_log2"]), centres,
                 spec["flip_log2"])
