"""Plain-PyTorch oracles (port of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.binary import hamming_xor


def hamming_distance_ref(q_packed: torch.Tensor,
                         x_packed: torch.Tensor) -> torch.Tensor:
    """q: (Q, W) int32 packed codes; x: (N, W) -> (Q, N) int32."""
    return hamming_xor(q_packed, x_packed)


def hamming_hist_ref(q_packed: torch.Tensor, x_packed: torch.Tensor,
                     bins: int) -> torch.Tensor:
    """Distance histogram over the bounded domain [0, bins) — pass 1 of the
    counting select. -> (Q, bins) int32."""
    dist = torch.clamp(hamming_distance_ref(q_packed, x_packed), max=bins - 1)
    hist = torch.zeros((dist.shape[0], bins), dtype=torch.int32,
                       device=dist.device)
    return hist.scatter_add_(1, dist.long(),
                             torch.ones_like(dist, dtype=torch.int32))


def bitpack_ref(bits: torch.Tensor) -> torch.Tensor:
    """bits: (N, d) {0,1}, d % 32 == 0 -> (N, d//32) int32 (bit i of word w
    is dim w*32+i)."""
    n, d = bits.shape
    b = bits.reshape(n, d // 32, 32).to(torch.int32)
    out = torch.zeros((n, d // 32), dtype=torch.int32, device=bits.device)
    for i in range(32):
        out |= b[:, :, i] << i
    return out
