"""Modality frontend stubs (port of ``repro.models.frontends``).

The ``[audio]`` / ``[vlm]`` configs cover the transformer backbone only:
the EnCodec / CLIP-anyres encoders are out of scope, and the model takes
*precomputed* frame or patch embeddings, projected by its
``frontend.proj`` and prepended to the token sequence. This module holds
the stub widths and a seeded synthetic embedding generator. ``repro``
draws its prefix from ``jax.random``, which a ``torch.Generator`` cannot
reproduce: code that compares the two carries the arrays across.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig

# raw embedding width delivered by the (stubbed) modality encoder
_FRONTEND_DIMS = {
    "audio_frames": 128,      # EnCodec latent frame width
    "vision_patches": 1024,   # CLIP-L patch embedding width
}


def frontend_dim(cfg: ModelConfig) -> int:
    if cfg.frontend == "none":
        return 0
    return _FRONTEND_DIMS[cfg.frontend]


def synthetic_prefix(cfg: ModelConfig, batch: int,
                     gen: Optional[torch.Generator] = None, device=None
                     ) -> Optional[torch.Tensor]:
    """Seeded stand-in for precomputed frontend embeddings: (batch,
    frontend_positions, frontend_dim) in the model dtype, drawn N(0, 1) in
    f32 on the generator's device (a fresh one seeded 17 on ``device``
    when ``gen`` is None), then cast and moved to ``device`` — CUDA unless
    ``device="cpu"``. None for a config without a frontend."""
    if cfg.frontend == "none":
        return None
    dev = device_mod.resolve(device)
    if gen is None:
        gen = torch.Generator(dev).manual_seed(17)
    x = torch.randn((batch, cfg.frontend_positions, frontend_dim(cfg)),
                    generator=gen, device=gen.device, dtype=torch.float32)
    return x.to(device=dev, dtype=getattr(torch, cfg.dtype))
