"""Foundational model layers (port of ``repro.models.layers``).

Each layer's weights live in an ``nn.Module`` under ``repro``'s leaf
names and in ``repro``'s (in, out) layout (``x @ w``), so weights carried
from ``repro`` need no transposes. Every layer has an ``*_init`` that
returns the module with weights drawn from a caller's ``torch.Generator``,
and an apply function of ``repro``'s name and signature that takes the
module where ``repro`` takes the param dict: the modules hold weights,
the functions compute. Parameters are created without gradients; the
train step (``dist/steps.make_train_step``) turns them on for the model it
trains.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.configs.base import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _empty(shape, dtype, device) -> nn.Parameter:
    return _param(torch.empty(shape, dtype=dtype, device=device))


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on the generator's device, then cast,
    as ``repro`` draws in f32 and casts."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else in_dim ** -0.5
    return _normal(gen, (in_dim, out_dim), scale, dtype,
                   device if device is not None else gen.device)


def einsum_product(equation: str, compute, *operands) -> torch.Tensor:
    """``compute()``: the einsum ``equation`` of ``operands`` written out
    as broadcast products and sums (faster under autograd than
    ``torch.einsum``'s batched products where most pairs have nothing to
    sum). A torch function mode sees one call of this function with the
    equation (``launch/op_analysis`` charges it as the einsum)."""
    if has_torch_function(operands):
        return handle_torch_function(einsum_product, operands, equation,
                                     compute, *operands)
    return compute()


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = _param(torch.ones((dim,), dtype=torch.float32,
                                       device=device))


def rmsnorm_init(dim: int, device=None) -> RMSNorm:
    return RMSNorm(dim, device)


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params.scale
    return y.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu / geglu / gelu / relu_sq)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str, dtype,
                 device=None):
        super().__init__()
        self.w_out = _empty((d_ff, d_model), dtype, device)
        if activation in ("swiglu", "geglu"):
            self.w_gate = _empty((d_model, d_ff), dtype, device)
        self.w_up = _empty((d_model, d_ff), dtype, device)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype, device=None) -> MLP:
    m = MLP(d_model, d_ff, activation, dtype, device)
    for p in m.parameters():
        p.copy_(dense_init(gen, *p.shape, dtype, device=p.device))
    return m


def mlp(params: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ params.w_gate) * (x @ params.w_up)
    elif activation == "geglu":
        h = F.gelu(x @ params.w_gate, approximate="tanh") * (x @ params.w_up)
    elif activation == "gelu":
        h = F.gelu(x @ params.w_up, approximate="tanh")
    elif activation == "relu_sq":
        h = torch.square(F.relu(x @ params.w_up))
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return h @ params.w_out


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device=None):
        super().__init__()
        self.table = _empty((vocab, d_model), dtype, device)


def embedding_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
                   device=None) -> Embedding:
    e = Embedding(vocab, d_model, dtype, device)
    e.table.copy_(_normal(gen, (vocab, d_model), 0.02, dtype, e.table.device))
    return e


def embed(params: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding's backward sums each row's gradients in a fixed order on
    # the CPU; indexing's accumulates in parallel and varies run to run
    return F.embedding(tokens, params.table)


def unembed(params: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) output table: (..., d) -> (..., vocab)."""
    return x @ params.table.T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level cross entropy over logits (..., V)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
