"""RWKV6 (Finch) block — data-dependent per-channel decay time-mix plus
squared-relu channel-mix (port of ``repro.models.rwkv6``).

Per head (hd key channels i, hd value channels j):
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] v_t[j]
    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
with w_t = exp(-exp(w0 + lora(x))) in (0,1) — the data-dependent decay that
distinguishes Finch from RWKV5.

Chunked evaluation (prefill): within a chunk the contribution of step s to
step t>s decays by exp(Lc[t-1] - Lc[s]) per channel (Lc = cumulative log
decay). The per-channel decay tensor is materialized (every exponent <= 0,
so exact and stable) and contracted; the carried state handles chunk
boundaries. Decode is the O(1)-state recurrence. ``repro`` scans chunks
and steps with ``lax.scan``; here they are Python loops over the same
bodies.

The time-mix and channel-mix weights live in one module (``tm``), under
``repro``'s leaf names.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_empty, _normal, _param, dense_init,
                                       einsum_product)

WKV_CHUNK = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # (B, H, hd, hd) f32
    shift_t: torch.Tensor    # (B, d) last token (time-mix shift)
    shift_c: torch.Tensor    # (B, d) last token (channel-mix shift)


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    n_heads = cfg.d_model // hd
    return n_heads, hd


class RWKV6(nn.Module):
    """One RWKV6 layer's time-mix and channel-mix weights."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, lora = cfg.d_model, cfg.rwkv.decay_lora
        n_heads, hd = _dims(cfg)
        f32 = torch.float32
        full = lambda shape, v: _param(torch.full(shape, v, dtype=f32,
                                                  device=device))
        # time-mix
        self.mu = _empty((5, d), f32, device)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _empty((d, d), dtype, device))
        self.decay_base = full((d,), -2.0)                    # w0
        self.decay_a = _empty((d, lora), dtype, device)
        self.decay_b = _empty((lora, d), f32, device)
        self.bonus = full((n_heads, hd), 0.0)                 # u
        self.ln_scale = full((n_heads, hd), 1.0)
        # channel-mix
        self.mu_c = full((2, d), 0.5)
        self.w_k_cm = _empty((d, cfg.d_ff), dtype, device)
        self.w_v_cm = _empty((cfg.d_ff, d), dtype, device)
        self.w_r_cm = _empty((d, d), dtype, device)


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               device=None) -> RWKV6:
    """Weights drawn from ``gen`` as ``repro`` draws them: mu U(0, 1),
    dense layers N(0, 1/in), decay_b N(0, 1e-4) in f32."""
    m = RWKV6(cfg, dtype, device)
    m.mu.copy_(torch.rand(tuple(m.mu.shape), generator=gen, device=gen.device,
                          dtype=torch.float32).to(m.mu.device))
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "decay_a", "w_k_cm",
                 "w_v_cm", "w_r_cm"):
        w = getattr(m, name)
        w.copy_(dense_init(gen, *w.shape, dtype, device=w.device))
    m.decay_b.copy_(_normal(gen, tuple(m.decay_b.shape), 0.01,
                            torch.float32, m.decay_b.device))
    return m


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """Token shift: (B, S, d) -> previous token's activation."""
    pad = (torch.zeros_like(x[:, :1]) if last is None
           else last[:, None, :].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def _decay(params: RWKV6, xw: torch.Tensor):
    """Data-dependent per-channel log-decay (<= 0). xw: (B,S,d) -> f32 (B,S,d)."""
    lora = torch.tanh(xw @ params.decay_a).float() @ params.decay_b
    return -torch.exp(params.decay_base + lora)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, eps: float):
    """Per-head RMS norm. y: (B,S,H,hd)."""
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale


def _wkv_chunked(r, k, v, logw, bonus, chunk: int):
    """r,k,v: (B,S,H,hd) f32; logw: (B,S,H,hd) <= 0.

    Returns (y (B,S,H,hd) f32, final state (B,H,hd,hd))."""
    B, S, H, hd = r.shape
    L = min(chunk, S)
    S_pad = ((S + L - 1) // L) * L
    if S_pad != S:
        # inert padding: k=0 (no contribution), logw=0 (state preserved)
        pz = lambda a: F.pad(a, (0, 0, 0, 0, 0, S_pad - S))
        r, k, v, logw = pz(r), pz(k), pz(v), pz(logw)
    S_orig, S = S, S_pad
    nc = S // L
    idx = torch.arange(L, device=r.device)
    # s < t strict, as (1, t, s, 1, 1)
    tri_lower = (idx[:, None] > idx[None, :])[None, :, :, None, None]

    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        r_l, k_l, v_l, w_l = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        lc = torch.cumsum(w_l, dim=1)                         # (B,L,H,hd) L_t
        # decay from s to t (strict): exp(L_{t-1} - L_s) = exp(L_t - w_t - L_s)
        diff = (lc - w_l)[:, :, None] - lc[:, None, :]        # (B,t,s,H,hd)
        decay = torch.where(tri_lower, torch.exp(torch.clamp(diff, max=0.0)),
                            0.0)
        # intra-chunk strict-past contribution
        scores = einsum_product(
            "bthi,btshi,bshi->btsh",
            lambda: (r_l[:, :, None] * decay * k_l[:, None, :]).sum(-1),
            r_l, decay, k_l)
        y = torch.einsum("btsh,bshj->bthj", scores, v_l)
        # current-token bonus
        y = y + einsum_product(
            "bthi,hi,bthi,bthj->bthj",
            lambda: (r_l * bonus * k_l).sum(-1, keepdim=True) * v_l,
            r_l, bonus, k_l, v_l)
        # carried state: y_t += sum_i r[t,i] exp(L_{t-1})[i] S_in[i,j]
        rstate = r_l * torch.exp(lc - w_l)
        y = y + torch.einsum("bthi,bhij->bthj", rstate, state)
        # state update: S_out = diag(exp(L_L)) S_in + sum_s exp(L_L - L_s) k_s v_s
        rem = torch.exp(lc[:, -1:] - lc)                      # (B,L,H,hd)
        state = torch.exp(lc[:, -1])[..., None] * state + torch.einsum(
            "bshi,bshj->bhij", rem * k_l, v_l)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S_orig], state


def _wkv_steps(r, k, v, logw, bonus, state):
    """The recurrence one step at a time from ``state`` (the decode path):
    r,k,v,logw (B,S,H,hd) f32 -> (y (B,S,H,hd), final state)."""
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], logw[:, t]
        y_t = (torch.einsum("bhi,bhij->bhj", r_t, state)
               + einsum_product(
                   "bhi,hi,bhi,bhj->bhj",
                   lambda: (r_t * bonus * k_t).sum(-1, keepdim=True) * v_t,
                   r_t, bonus, k_t, v_t))
        state = (torch.exp(w_t)[..., None] * state
                 + torch.einsum("bhi,bhj->bhij", k_t, v_t))
        ys.append(y_t)
    return torch.stack(ys, dim=1), state


def _time_mix_inputs(params: RWKV6, x, last):
    xx = _shift(x, last)
    sx = (xx - x).float()
    xf = x.float()
    mixed = xf[None] + params.mu[:, None, None, :] * sx[None]  # (5,B,S,d)
    return [m.to(x.dtype) for m in mixed]


def _time_mix_heads(params: RWKV6, cfg: ModelConfig, x, last):
    """r, k, v, log-decay (B, S, H, hd) f32 and the gate (B, S, d)."""
    B, S, _ = x.shape
    H, hd = _dims(cfg)
    xr, xk, xv, xw, xg = _time_mix_inputs(params, x, last)
    heads = lambda t: t.reshape(B, S, H, hd).float()
    return (heads(xr @ params.w_r), heads(xk @ params.w_k),
            heads(xv @ params.w_v), heads(_decay(params, xw)),
            F.silu(xg @ params.w_g))


def rwkv6_time_mix(params: RWKV6, cfg: ModelConfig, x: torch.Tensor,
                   state: Optional[RWKVState] = None,
                   return_state: bool = False):
    """x: (B, S, d). From a zero state (``state`` None) the chunked form;
    from a given state the step-by-step continuation."""
    B, S, d = x.shape
    last = None if state is None else state.shift_t
    r, k, v, logw, g = _time_mix_heads(params, cfg, x, last)
    if state is None:
        y, s_fin = _wkv_chunked(r, k, v, logw, params.bonus, WKV_CHUNK)
    else:
        y, s_fin = _wkv_steps(r, k, v, logw, params.bonus, state.wkv)
    y = _group_norm(y, params.ln_scale, cfg.norm_eps).reshape(B, S, d)
    out = (y.to(x.dtype) * g) @ params.w_o
    if return_state:
        return out, s_fin, x[:, -1]
    return out


def rwkv6_channel_mix(params: RWKV6, cfg: ModelConfig, x: torch.Tensor,
                      state: Optional[RWKVState] = None,
                      return_state: bool = False):
    last = None if state is None else state.shift_c
    xx = _shift(x, last)
    sx = (xx - x).float()
    xf = x.float()
    xk = (xf + params.mu_c[0] * sx).to(x.dtype)
    xr = (xf + params.mu_c[1] * sx).to(x.dtype)
    vv = torch.square(F.relu(xk @ params.w_k_cm)) @ params.w_v_cm
    out = torch.sigmoid((xr @ params.w_r_cm).float()).to(x.dtype) * vv
    if return_state:
        return out, x[:, -1]
    return out


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> RWKVState:
    H, hd = _dims(cfg)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    return RWKVState(
        wkv=torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                        device=device),
        shift_t=torch.zeros((batch, d), dtype=dt, device=device),
        shift_c=torch.zeros((batch, d), dtype=dt, device=device),
    )
