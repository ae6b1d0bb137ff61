"""Binary quantization: ITQ (the paper's offline pipeline) + LSH codes
(port of ``repro.core.quantize``).

ITQ (Gong & Lazebnik, CVPR'11): PCA to ``bits`` dims, then alternate
  B = sign(V R)          (discretize)
  R = U W^T  from  svd(V^T B) = U S W^T   (orthogonal Procrustes)
minimizing ||B - V R||_F over rotations.

Random state comes from a caller's ``torch.Generator``; it cannot give
``jax.random``'s numbers, and SVD signs differ between libraries, so a
port-trained ITQ matches ``repro``'s by its invariants (subspace,
orthogonality, objective), not bit for bit. ``itq_encode`` on carried
``ITQParams`` matches exactly away from zero projections.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_mod


class ITQParams(NamedTuple):
    mean: torch.Tensor       # (dim,)
    proj: torch.Tensor       # (dim, bits)  PCA
    rot: torch.Tensor        # (bits, bits) learned rotation


def _generator(gen: Optional[torch.Generator], device) -> torch.Generator:
    return gen if gen is not None else torch.Generator(device).manual_seed(0)


def itq_train(x: torch.Tensor, bits: int, iters: int = 30,
              generator: Optional[torch.Generator] = None) -> ITQParams:
    """x: (n, dim). Returns encode params on x's device. ``generator``
    (on x's device; default seeded 0) draws the initial rotation."""
    x = x.float()
    mean = torch.mean(x, dim=0)
    xc = x - mean
    # PCA via SVD of the (dim, dim) covariance
    cov = (xc.T @ xc) / x.shape[0]
    _, _, vt = torch.linalg.svd(cov, full_matrices=False)
    proj = vt[:bits].T.contiguous()                              # (dim, bits)
    v = xc @ proj                                                # (n, bits)
    g = _generator(generator, x.device)
    r = torch.linalg.qr(torch.randn((bits, bits), generator=g,
                                    device=g.device).to(x.device))[0]
    for _ in range(iters):
        b = torch.sign(v @ r)
        u, _, wt = torch.linalg.svd(v.T @ b, full_matrices=False)
        r = u @ wt
    return ITQParams(mean=mean, proj=proj, rot=r)


def itq_encode(x: torch.Tensor, p: ITQParams) -> torch.Tensor:
    """x: (..., dim) -> bits (..., code_bits) uint8 in {0,1}."""
    return (itq_project(x, p) > 0).to(torch.uint8)


def itq_project(x: torch.Tensor, p: ITQParams) -> torch.Tensor:
    """The continuous rotated projection ``itq_encode`` signs: (..., dim) ->
    (..., code_bits) f32."""
    return (x.float() - p.mean) @ p.proj @ p.rot


def itq_objective(x: torch.Tensor, p: ITQParams) -> torch.Tensor:
    """Quantization loss ||B - VR||_F^2 / n (monotone under training)."""
    vr = (x.float() - p.mean) @ p.proj @ p.rot
    b = torch.sign(vr)
    return torch.mean(torch.sum(torch.square(b - vr), dim=-1))


class LSHParams(NamedTuple):
    proj: torch.Tensor       # (dim, bits) gaussian hyperplanes


def lsh_train(dim: int, bits: int,
              generator: Optional[torch.Generator] = None,
              device=None) -> LSHParams:
    """Gaussian hyperplanes drawn from ``generator`` (default: seeded 0),
    on ``device`` — CUDA unless ``device="cpu"``."""
    dev = device_mod.resolve(device)
    g = _generator(generator, dev)
    proj = torch.randn((dim, bits), generator=g, device=g.device)
    return LSHParams(proj=proj.to(dev))


def lsh_encode(x: torch.Tensor, p: LSHParams) -> torch.Tensor:
    return (x.float() @ p.proj > 0).to(torch.uint8)
