"""Causal LM of the attention families (port of ``repro.models.lm``).

The model is an ``nn.Module`` tree — ``embed`` (the table), ``blocks`` (one
``Block`` per layer: ln1, attn, ln2, mlp), ``final_norm`` and, untied,
``unembed`` — with ``repro``'s leaf names and (in, out) weight layout. The
module-level functions keep ``repro``'s names and signatures, with the
module where ``repro`` takes the param pytree:

  forward        — full-sequence logits (scoring, datastore builds)
  prefill        — full sequence + the decode state (stacked KV caches)
  decode_step    — one token against the decode state

The layer stack is a Python loop over ``blocks`` (``repro`` scans stacked
params). The decode state keeps ``repro``'s shape: ``{"pos": (B,) int32,
"cache": KVCache}`` with k, v of (L, B, S_max, KV, hd).

MoE, Mamba2, RWKV6, the hybrid stack and the modality frontends raise
``NotImplementedError`` (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch import device as device_mod
from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.models.attention import (Attention, KVCache,
                                          attention_decode, attention_init,
                                          attention_prefill)
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, _dtype,
                                       embed, embedding_init, mlp, mlp_init,
                                       rmsnorm, unembed)

_QUEUE_11 = "ROADMAP queue 1 item 11"


@dataclasses.dataclass
class RunCtx:
    """Execution-context knobs threaded through the model. ``repro``'s
    mesh, sharding and MoE fields wait with the sharded and MoE paths."""

    causal_skip: bool = False          # triangular attention schedule
    attn_p_bf16: bool = False          # bf16 probability tensor
    attn_impl: str = "xla"             # 'xla' (blockwise) | 'flash' (K4)
    remat: bool = True                 # no effect without gradients
    attn_chunk: int = 1024


DEFAULT_CTX = RunCtx()


def _check_supported(cfg: ModelConfig) -> None:
    kind = cfg.block_pattern[0]
    if cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid (shared-attention) stack is not ported "
            f"yet: {_QUEUE_11}")
    if kind != BlockKind.ATTENTION or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: {kind.value} blocks are not ported yet: "
            f"{_QUEUE_11}")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet: "
            f"{_QUEUE_11}")


class Block(nn.Module):
    """Attention + MLP residual block."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm,
                 mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class LM(nn.Module):
    def __init__(self, embed: Embedding, blocks, final_norm: RMSNorm,
                 unembed: Optional[Embedding] = None):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        if unembed is not None:
            self.unembed = unembed

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def _build(cfg: ModelConfig, device, gen: Optional[torch.Generator] = None
           ) -> LM:
    """The module tree of ``cfg`` on ``device``: weights drawn from ``gen``,
    or left uninitialized when ``gen`` is None."""
    _check_supported(cfg)
    dt, d, hd = _dtype(cfg), cfg.d_model, cfg.resolved_head_dim

    def table():
        if gen is None:
            return Embedding(cfg.vocab_size, d, dt, device)
        return embedding_init(gen, cfg.vocab_size, d, dt, device)

    def block():
        if gen is None:
            attn = Attention(d, cfg.num_heads, cfg.num_kv_heads, hd, dt,
                             device)
            ff = MLP(d, cfg.d_ff, cfg.mlp_activation, dt, device)
        else:
            attn = attention_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                  hd, dt, device)
            ff = mlp_init(gen, d, cfg.d_ff, cfg.mlp_activation, dt, device)
        return Block(RMSNorm(d, device), attn, RMSNorm(d, device), ff)

    emb = table()
    blocks = [block() for _ in range(cfg.num_layers)]
    return LM(emb, blocks, RMSNorm(d, device),
              None if cfg.tie_embeddings else table())


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> LM:
    """The model with weights drawn from ``gen`` (on the generator's
    device, then moved), on ``device`` — CUDA unless ``device="cpu"``."""
    return _build(cfg, device_mod.resolve(device), gen)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the constructed module (no MoE here, so
    ``active_only`` changes nothing)."""
    return sum(p.numel() for p in _build(cfg, "meta").parameters())


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

def _embed_scale(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma scales embeddings by sqrt(d_model), rounded to the model
    dtype first (repro multiplies by ``jnp.asarray(..., x.dtype)``)."""
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _embed_inputs(model: LM, cfg: ModelConfig, tokens, prefix_emb):
    if prefix_emb is not None:
        raise NotImplementedError(f"prefix embeddings (frontends) are not "
                                  f"ported yet: {_QUEUE_11}")
    x = _embed_scale(cfg, embed(model.embed, tokens))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _apply_attn_mlp(p: Block, cfg: ModelConfig, ctx: RunCtx, x, positions,
                    want_cache: bool):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    out = attention_prefill(p.attn, h, positions, cfg.rope_theta,
                            chunk=ctx.attn_chunk, causal_skip=ctx.causal_skip,
                            p_bf16=ctx.attn_p_bf16, impl=ctx.attn_impl,
                            return_cache=want_cache)
    a, cache = out if want_cache else (out, None)
    x = x + a
    x = x + mlp(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps), cfg.mlp_activation)
    return x, cache


def _run_stack(model: LM, cfg: ModelConfig, ctx: RunCtx, x, positions,
               want_cache: bool = False):
    """Returns (hidden, aux_loss, stacked caches-or-None)."""
    _check_supported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for blk in model.blocks:
        x, cache = _apply_attn_mlp(blk, cfg, ctx, x, positions, want_cache)
        caches.append(cache)
    if not want_cache:
        return x, aux, None
    return x, aux, KVCache(k=torch.stack([c.k for c in caches]),
                           v=torch.stack([c.v for c in caches]))


def _logits(model: LM, cfg: ModelConfig, x):
    h = rmsnorm(model.final_norm, x, cfg.norm_eps)
    table = model.embed if cfg.tie_embeddings else model.unembed
    return unembed(table, h), h


def forward(model: LM, cfg: ModelConfig, tokens, prefix_emb=None,
            ctx: RunCtx = DEFAULT_CTX, return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V), aux[, final-norm hidden])."""
    x, positions = _embed_inputs(model, cfg, tokens, prefix_emb)
    x, aux, _ = _run_stack(model, cfg, ctx, x, positions, want_cache=False)
    logits, h = _logits(model, cfg, x)
    if return_hidden:
        return logits, aux, h
    return logits, aux


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def prefill(model: LM, cfg: ModelConfig, tokens, prefix_emb=None,
            ctx: RunCtx = DEFAULT_CTX):
    """Full-sequence forward that also returns the decode state."""
    x, positions = _embed_inputs(model, cfg, tokens, prefix_emb)
    x, _, caches = _run_stack(model, cfg, ctx, x, positions, want_cache=True)
    logits, _ = _logits(model, cfg, x)
    state = {"pos": torch.full((tokens.shape[0],), x.shape[1],
                               dtype=torch.int32, device=x.device),
             "cache": caches}
    return logits, state


def _keep_active(active, new, old):
    """Select updated state rows only where active (batch is axis 0)."""
    if active is None:
        return new
    pick = lambda n, o: torch.where(
        active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
    if isinstance(new, torch.Tensor):
        return pick(new, old)
    return type(new)(*(pick(n, o) for n, o in zip(new, old)))


def _decode_attn_mlp(p: Block, cfg: ModelConfig, ctx: RunCtx, x,
                     cache: KVCache, pos, active):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    y, new_cache = attention_decode(p.attn, h, cache, pos, cfg.rope_theta,
                                    active=active)
    x = x + y
    x = x + mlp(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps), cfg.mlp_activation)
    return x, new_cache


def decode_step(model: LM, cfg: ModelConfig, token, state,
                ctx: RunCtx = DEFAULT_CTX, active=None,
                return_hidden: bool = False):
    """token: (B, 1) int; state from ``init_decode_state`` or ``prefill``.
    ``pos`` may be per-row; rows with ``active`` False (continuous batching
    free slots) keep their state unchanged.

    Returns (logits (B,1,V), new_state[, hidden]); ``state`` itself is not
    modified."""
    _check_supported(cfg)
    B = token.shape[0]
    pos = torch.as_tensor(state["pos"], dtype=torch.int32,
                          device=token.device)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    x = _embed_scale(cfg, embed(model.embed, token))
    cache = state["cache"]
    ks, vs = [], []
    for i, blk in enumerate(model.blocks):
        x, c = _decode_attn_mlp(blk, cfg, ctx, x,
                                KVCache(k=cache.k[i], v=cache.v[i]), pos,
                                active)
        ks.append(c.k)
        vs.append(c.v)
    logits, h = _logits(model, cfg, x)
    new_pos = pos + (1 if active is None else active.to(torch.int32))
    new_state = {"pos": new_pos,
                 "cache": KVCache(k=torch.stack(ks), v=torch.stack(vs))}
    if return_hidden:
        return logits, new_state, h
    return logits, new_state


def pad_decode_state(cfg: ModelConfig, state, max_len: int):
    """Grow the KV-cache capacity of a prefill state to ``max_len``."""
    _check_supported(cfg)

    def pad(a):
        extra = max_len - a.shape[2]
        if extra <= 0:
            return a
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, extra))

    c = state["cache"]
    return {"pos": state["pos"], "cache": KVCache(k=pad(c.k), v=pad(c.v))}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """Zero decode state with capacity ``max_len``, on ``device`` — CUDA
    unless ``device="cpu"``."""
    _check_supported(cfg)
    dev = device_mod.resolve(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    zeros = lambda: torch.zeros(shape, dtype=_dtype(cfg), device=dev)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "cache": KVCache(k=zeros(), v=zeros())}
