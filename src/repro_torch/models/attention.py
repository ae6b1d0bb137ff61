"""GQA/MQA causal attention with blockwise (online-softmax) prefill and a
KV-cache decode step (port of ``repro.models.attention``).

Prefill by default (``impl="xla"``, the name kept from ``repro``) never
materializes the (S, S) score matrix: it streams KV chunks with a running
(max, sum, acc) online softmax in plain PyTorch. Two schedules:

* rectangular (baseline): every (q-chunk, kv-chunk) pair is computed and the
  causal mask zeroes the upper triangle — ~2x the useful FLOPs.
* triangular (``causal_skip=True``): only the (i, j <= i) chunk pairs —
  exact-FLOP causal attention.

``impl="flash"`` runs K4 (``kernels/ops.flash_attention``): the CUDA kernel
on the card, its plain version on the CPU. Decode attends one new token
against the cache.

Dtypes follow ``repro``: scores and the softmax state are f32; q is scaled
in the model dtype before the blockwise scan (as ``repro`` multiplies by a
weakly typed constant, the scale is rounded to the model dtype first), while
K4 scales after its f32 upcast, as the Pallas kernel does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.layers import _empty, apply_rope, dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, hd)
    v: torch.Tensor       # (B, S_max, KV, hd)


class Attention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype, device=None):
        super().__init__()
        self.wq = _empty((d_model, num_heads, head_dim), dtype, device)
        self.wk = _empty((d_model, num_kv_heads, head_dim), dtype, device)
        self.wv = _empty((d_model, num_kv_heads, head_dim), dtype, device)
        self.wo = _empty((num_heads, head_dim, d_model), dtype, device)


def attention_init(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, dtype,
                   device=None) -> Attention:
    a = Attention(d_model, num_heads, num_kv_heads, head_dim, dtype, device)
    for w in (a.wq, a.wk, a.wv):
        w.copy_(dense_init(gen, d_model, w.shape[1] * head_dim, dtype,
                           device=w.device).reshape(w.shape))
    a.wo.copy_(dense_init(gen, num_heads * head_dim, d_model, dtype,
                          device=a.wo.device).reshape(a.wo.shape))
    return a


def _qkv(params: Attention, x: torch.Tensor, positions: torch.Tensor,
         rope_theta: float):
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", x, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x, params.wv)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd), k: (B, Sk, KV, hd) -> (B, KV, G, Sq, Sk)."""
    return torch.einsum("bqhgk,bshk->bhgqs", q, k)


def _grouped_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, KV, G, Sq, Sk), v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)."""
    return torch.einsum("bhgqs,bshk->bqhgk", p, v)


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x * scale with the constant rounded to x's dtype first."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def _online_step(carry, k_blk, v_blk, q, mask, p_bf16: bool = False):
    """One online-softmax accumulation step.

    carry: (acc (B,KV,G,Sq,hd) f32, m (B,KV,G,Sq) f32, l (B,KV,G,Sq) f32)
    """
    acc, m, l = carry
    s = _grouped_scores(q, k_blk).float()                     # (B,KV,G,Sq,Kc)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    alpha = torch.exp(m - m_new)
    # guard the fully-masked case (s == m_new == NEG_INF would give exp(0)=1)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), 0.0)
    l = l * alpha + torch.sum(p, dim=-1)
    # repro's knob: the probabilities in the model dtype; (acc, l) stay f32
    p = p.to(v_blk.dtype) if p_bf16 else p
    pv = _grouped_out(p, v_blk.to(p.dtype)).float()
    acc = acc * alpha[..., None] + pv.permute(0, 2, 3, 1, 4)
    return acc, m_new, l


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, chunk: int = 1024,
                               causal_skip: bool = False,
                               p_bf16: bool = False) -> torch.Tensor:
    """q,k,v: (B, S, H|KV, hd) post-rope. Returns (B, S, H, hd).

    Streams KV in ``chunk``-sized blocks with an online softmax; optionally
    skips fully-masked chunk pairs (triangular schedule).
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    chunk = min(chunk, S)
    S_pad = ((S + chunk - 1) // chunk) * chunk
    if S_pad != S:
        # pad with future positions: causal masking (kpos <= qpos < S) keeps
        # them invisible to every real query; padded q rows are sliced off.
        pz = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, S_pad - S))
        q, k, v = pz(q), pz(k), pz(v)
    S_orig, S = S, S_pad
    q = _scaled(q, scale).reshape(B, S, KV, G, hd)
    nc = S // chunk
    pos_in = torch.arange(chunk, device=q.device)

    def pair(i, j, carry):
        q_i = q[:, i * chunk:(i + 1) * chunk]
        k_j = k[:, j * chunk:(j + 1) * chunk]
        v_j = v[:, j * chunk:(j + 1) * chunk]
        mask = ((j * chunk + pos_in[None, :])
                <= (i * chunk + pos_in[:, None]))            # (Sq, Kc)
        return _online_step(carry, k_j, v_j, q_i, mask, p_bf16)

    outs = []
    for i in range(nc):
        carry = (torch.zeros((B, KV, G, chunk, hd), dtype=torch.float32,
                             device=q.device),
                 torch.full((B, KV, G, chunk), NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros((B, KV, G, chunk), dtype=torch.float32,
                             device=q.device))
        # rectangular: every kv chunk; triangular: only j <= i
        for j in range(i + 1 if causal_skip else nc):
            carry = pair(i, j, carry)
        acc, _, l = carry
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))      # (B, chunk, KV, G, hd)
    out = torch.cat(outs, dim=1)[:, :S_orig]
    return out.reshape(B, S_orig, H, hd).to(v.dtype)


def attention_prefill(params: Attention, x: torch.Tensor,
                      positions: torch.Tensor, rope_theta: float,
                      chunk: int = 1024, causal_skip: bool = False,
                      p_bf16: bool = False, impl: str = "xla",
                      return_cache: bool = False):
    """Full-sequence causal attention. x: (B, S, d). ``impl``: 'xla'
    (blockwise online-softmax scan in plain PyTorch) or 'flash' (K4;
    forward-only, so serving paths only)."""
    q, k, v = _qkv(params, x, positions, rope_theta)
    if impl == "flash":
        from repro_torch.kernels import ops
        out = ops.flash_attention(q, k, v, bq=min(chunk, 512),
                                  bk=min(chunk, 512))
    elif impl == "xla":
        out = blockwise_causal_attention(q, k, v, chunk=chunk,
                                         causal_skip=causal_skip,
                                         p_bf16=p_bf16)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    y = torch.einsum("bshk,hkd->bsd", out, params.wo)
    if return_cache:
        return y, KVCache(k=k, v=v)
    return y


def attention_decode(params: Attention, x: torch.Tensor, cache: KVCache, pos,
                     rope_theta: float, active: Optional[torch.Tensor] = None):
    """One-token decode. x: (B, 1, d); cache holds S_max past positions;
    ``pos`` is the new token's index — scalar or per-row (B,) vector
    (continuous batching). Rows with ``active`` False leave the cache
    untouched.

    Returns (y (B, 1, d), updated cache); the cache passed in is not
    modified."""
    B = x.shape[0]
    S_max = cache.k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    positions = pos[:, None]
    q, k_new, v_new = _qkv(params, x, positions, rope_theta)
    write = pos if active is None else torch.where(active, pos, S_max)
    # per-row cache insert as a select, as repro does
    iota = torch.arange(S_max, device=x.device)
    sel = (iota[None, :] == write[:, None])[:, :, None, None]
    k = torch.where(sel, k_new.to(cache.k.dtype), cache.k)
    v = torch.where(sel, v_new.to(cache.v.dtype), cache.v)

    KV = k.shape[2]
    H = q.shape[2]
    G = H // KV
    hd = q.shape[3]
    qg = _scaled(q, hd ** -0.5).reshape(B, 1, KV, G, hd)
    s = _grouped_scores(qg, k).float()                        # (B,KV,G,1,S)
    valid = (iota[None, :] <= pos[:, None])[:, None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _grouped_out(p.to(v.dtype), v)                      # (B,1,KV,G,hd)
    y = torch.einsum("bshk,hkd->bsd", out.reshape(B, 1, H, hd), params.wo)
    return y, KVCache(k=k, v=v)
