"""Mamba2 (SSD) block — chunked parallel scan for prefill, O(1)-state
recurrent step for decode (port of ``repro.models.mamba2``).

State-space recurrence per head h (P channels, N state):
    h_t = a_t * h_{t-1} + dt_t * (B_t outer x_t)      a_t = exp(dt_t * A_h), A_h < 0
    y_t = C_t . h_t + D_h * x_t

The chunked (SSD) algorithm computes, per chunk of length L:
  intra:  Y[t] += sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s x_s
  inter:  Y[t] += exp(l_t) * (C_t . h_in)
  carry:  h_out = exp(l_L) h_in + sum_s exp(l_L - l_s) dt_s (B_s outer x_s)
with l_t the within-chunk cumulative log-decay (f32; every exponent is
<= 0, so the exps are stable). ``repro`` scans the chunks with
``lax.scan``; here they are a Python loop over the same body.

The weights keep ``repro``'s leaf names and (in, out) layout: separate
w_z/w_x/w_b/w_c/w_dt projections and one depthwise conv per stream.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (RMSNorm, _empty, _normal, _param,
                                       dense_init, rmsnorm)


class MambaState(NamedTuple):
    ssm: torch.Tensor        # (B, H, P, N) f32
    conv_x: torch.Tensor     # (B, W-1, d_inner) rolling raw inputs
    conv_b: torch.Tensor     # (B, W-1, N)
    conv_c: torch.Tensor     # (B, W-1, N)


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads


class Mamba2(nn.Module):
    """One Mamba2 mixer's weights under ``repro``'s leaf names."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        ssm, d = cfg.ssm, cfg.d_model
        d_inner, n_heads = _dims(cfg)
        f32 = torch.float32
        self.w_z = _empty((d, d_inner), dtype, device)
        self.w_x = _empty((d, d_inner), dtype, device)
        self.w_b = _empty((d, ssm.state_dim), dtype, device)
        self.w_c = _empty((d, ssm.state_dim), dtype, device)
        self.w_dt = _empty((d, n_heads), dtype, device)
        self.conv_x = _empty((ssm.conv_width, d_inner), dtype, device)
        self.conv_b = _empty((ssm.conv_width, ssm.state_dim), dtype, device)
        self.conv_c = _empty((ssm.conv_width, ssm.state_dim), dtype, device)
        self.a_log = _empty((n_heads,), f32, device)
        self.d_skip = _param(torch.ones((n_heads,), dtype=f32, device=device))
        self.dt_bias = _param(torch.zeros((n_heads,), dtype=f32,
                                          device=device))
        self.norm = RMSNorm(d_inner, device)
        self.w_out = _empty((d_inner, d), dtype, device)


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                device=None) -> Mamba2:
    """Weights drawn from ``gen`` as ``repro`` draws them: dense layers
    N(0, 1/in), convs N(0, 1/W), a_log = log(linspace(1, 16, H))."""
    m = Mamba2(cfg, dtype, device)
    for name in ("w_z", "w_x", "w_b", "w_c", "w_dt"):
        w = getattr(m, name)
        w.copy_(dense_init(gen, *w.shape, dtype, device=w.device))
    width = cfg.ssm.conv_width
    for name in ("conv_x", "conv_b", "conv_c"):
        w = getattr(m, name)
        w.copy_(_normal(gen, tuple(w.shape), width ** -0.5, dtype, w.device))
    m.w_out.copy_(dense_init(gen, *m.w_out.shape, dtype, device=m.w_out.device))
    n_heads = m.a_log.shape[0]
    m.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                           dtype=torch.float32,
                                           device=m.a_log.device)))
    return m


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv via shifted adds + silu. x: (B, S, C); w: (W, C).

    ``state``: (B, W-1, C) past raw inputs (decode). Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # (B, S+W-1, C)
    S = x.shape[1]
    y = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S, :] * w[i]
    y = F.silu(y.float()).to(x.dtype)
    return y, xp[:, -(W - 1):, :]


def _ssd_chunked(x, b_mat, c_mat, dt, a_log, chunk: int):
    """x: (B,S,H,P); b_mat/c_mat: (B,S,N); dt: (B,S,H) f32.

    Returns (y (B,S,H,P) f32, h_final (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    L = min(chunk, S)
    S_pad = ((S + L - 1) // L) * L
    if S_pad != S:
        # pad with inert steps: x=0 (no contribution), dt=0 => decay exp(0)=1
        # (state preserved), so the returned state is exact.
        pz = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, S_pad - S))
        x, b_mat, c_mat, dt = pz(x), pz(b_mat), pz(c_mat), pz(dt)
    S_orig, S = S, S_pad
    nc = S // L

    a = -torch.exp(a_log)                                     # (H,) negative
    loga_step = dt * a                                        # (B,S,H) <= 0
    xf, bf, cf = x.float(), b_mat.float(), c_mat.float()
    idx = torch.arange(L, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, :, :, None]   # (1,L,L,1) t,s

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        x_l, b_l, c_l = xf[:, sl], bf[:, sl], cf[:, sl]
        dt_l, lg = dt[:, sl], loga_step[:, sl]
        l_cum = torch.cumsum(lg, dim=1)                       # (B,L,H)
        # intra-chunk
        cb = torch.einsum("bln,bsn->bls", c_l, b_l)           # (B,L,L)
        diff = l_cum[:, :, None, :] - l_cum[:, None, :, :]    # (B,L,L,H) t,s
        decay = torch.where(mask, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        scores = cb[:, :, :, None] * decay                    # (B,L,L,H)
        dtx = dt_l[..., None] * x_l                           # (B,L,H,P)
        y = torch.einsum("blsh,bshp->blhp", scores, dtx)
        # inter-chunk (carried state)
        y = y + torch.exp(l_cum)[..., None] * torch.einsum(
            "bln,bhpn->blhp", c_l, h)
        # state update
        rem = torch.exp(l_cum[:, -1:, :] - l_cum)             # (B,L,H)
        h = torch.exp(l_cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bsh,bsn,bshp->bhpn", rem * dt_l, b_l, x_l)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S_orig]
    return y, h


def _projections(params: Mamba2, x: torch.Tensor,
                 state: Optional[MambaState]):
    z = x @ params.w_z
    x_in = x @ params.w_x
    b_in = x @ params.w_b
    c_in = x @ params.w_c
    dt = x @ params.w_dt
    sx = None if state is None else state.conv_x
    sb = None if state is None else state.conv_b
    sc = None if state is None else state.conv_c
    x_ssm, nx = _causal_conv(x_in, params.conv_x, sx)
    b_mat, nb = _causal_conv(b_in, params.conv_b, sb)
    c_mat, nc = _causal_conv(c_in, params.conv_c, sc)
    return z, x_ssm, b_mat, c_mat, dt, (nx, nb, nc)


def _gated_out(params: Mamba2, cfg: ModelConfig, y: torch.Tensor, z):
    y = rmsnorm(params.norm, y * F.silu(z), cfg.norm_eps)
    return y @ params.w_out


def mamba2_forward(params: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                   return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, d_model)."""
    ssm = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    B, S, _ = x.shape
    z, x_ssm, b_mat, c_mat, dt, conv_states = _projections(params, x, None)
    dt = F.softplus(dt.float() + params.dt_bias)
    xh = x_ssm.reshape(B, S, n_heads, ssm.head_dim)
    y, h = _ssd_chunked(xh, b_mat, c_mat, dt, params.a_log, ssm.chunk_size)
    y = y + params.d_skip[None, None, :, None] * xh.float()
    out = _gated_out(params, cfg, y.reshape(B, S, d_inner).to(x.dtype), z)
    if return_state:
        nx, nb, nc = conv_states
        return out, MambaState(ssm=h, conv_x=nx, conv_b=nb, conv_c=nc)
    return out


def mamba2_step(params: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                state: MambaState):
    """Single-token decode. x: (B, 1, d_model) -> (y, new_state)."""
    ssm = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    B = x.shape[0]
    z, x_ssm, b_mat, c_mat, dt, conv_states = _projections(params, x, state)
    dt = F.softplus(dt.float() + params.dt_bias)[:, 0]       # (B,H)
    xh = x_ssm.reshape(B, n_heads, ssm.head_dim).float()
    bf = b_mat[:, 0].float()                                  # (B,N)
    cf = c_mat[:, 0].float()
    a_step = torch.exp(dt * -torch.exp(params.a_log))         # (B,H)
    h = state.ssm * a_step[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bf, xh)
    y = (torch.einsum("bn,bhpn->bhp", cf, h)
         + params.d_skip[None, :, None] * xh)
    out = _gated_out(params, cfg, y.reshape(B, 1, d_inner).to(x.dtype), z)
    nx, nb, nc = conv_states
    return out, MambaState(ssm=h, conv_x=nx, conv_b=nb, conv_c=nc)


def init_mamba_state(cfg: ModelConfig, batch: int, device=None
                     ) -> MambaState:
    ssm = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    dt = getattr(torch, cfg.dtype)
    w1 = ssm.conv_width - 1
    zeros = lambda shape, t: torch.zeros(shape, dtype=t, device=device)
    return MambaState(
        ssm=zeros((batch, n_heads, ssm.head_dim, ssm.state_dim),
                  torch.float32),
        conv_x=zeros((batch, w1, d_inner), dt),
        conv_b=zeros((batch, w1, ssm.state_dim), dt),
        conv_c=zeros((batch, w1, ssm.state_dim), dt),
    )
