"""Binary codes: packing and Hamming distance (port of ``repro.core.binary``).

Codes are stored as ``torch.int32`` with the bit pattern of ``repro``'s
uint32 codes: bit i of word w is dim 32w+i. PyTorch has no popcount, so
``popcount32`` is a SWAR count written for int32, whose ``>>`` is an
arithmetic shift: every step masks away the sign bits a shift drags in.

* ``hamming_xor`` — bit-packed XOR + popcount, one word at a time so the
  (Q, N, W) XOR tensor never exists;
* ``hamming_mxu`` — +/-1 encoding, distance = (d - q.x)/2 through one
  float32 matrix product (exact: every product is +/-1 and every partial
  sum an integer below 2^24).

Both agree bit-for-bit with ``hamming_ref``.
"""
from __future__ import annotations

import torch

WORD = 32

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def padded_words(d: int) -> int:
    return (d + WORD - 1) // WORD


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of an int32 tensor (all 32 bits, sign included)
    -> int32 in [0, 32]."""
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4          # bytes hold counts; v is now >= 0
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits: (..., d) in {0,1} -> packed (..., ceil(d/32)) int32."""
    d = bits.shape[-1]
    W = padded_words(d)
    pad = W * WORD - d
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(*bits.shape[:-1], W, WORD).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        WORD, dtype=torch.int64, device=bits.device)
    # values reach 2^32 - 1; the int32 cast wraps them onto the uint32 pattern
    return (b * weights).sum(dim=-1).to(torch.int32)


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """packed: (..., W) int32 -> (..., d) uint8 in {0,1}."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1],
                        packed.shape[-1] * WORD)[..., :d].to(torch.uint8)


def hamming_ref(q_bits: torch.Tensor, x_bits: torch.Tensor) -> torch.Tensor:
    """Oracle: q_bits (Q, d), x_bits (N, d) in {0,1} -> (Q, N) int32."""
    diff = q_bits[:, None, :].to(torch.int32) != x_bits[None, :, :].to(torch.int32)
    return diff.sum(dim=-1, dtype=torch.int32)


def hamming_xor(q_packed: torch.Tensor, x_packed: torch.Tensor) -> torch.Tensor:
    """Bit-packed XOR+popcount. q: (Q, W) int32, x: (N, W) -> (Q, N) int32."""
    q = q_packed.to(torch.int32)
    x = x_packed.to(torch.int32)
    dist = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.int32,
                       device=q.device)
    for w in range(q.shape[1]):
        dist += popcount32(q[:, w, None] ^ x[None, :, w])
    return dist


def hamming_mxu(q_bits: torch.Tensor, x_bits: torch.Tensor,
                d: int | None = None) -> torch.Tensor:
    """Matmul path: distance = (d - <2q-1, 2x-1>) / 2, one float32 product.

    q_bits: (Q, d), x_bits: (N, d) in {0,1} -> (Q, N) int32 (exact)."""
    d = d if d is not None else q_bits.shape[-1]
    qs = (2 * q_bits.to(torch.int8) - 1).to(torch.float32)
    xs = (2 * x_bits.to(torch.int8) - 1).to(torch.float32)
    return ((d - qs @ xs.T) * 0.5).to(torch.int32)
