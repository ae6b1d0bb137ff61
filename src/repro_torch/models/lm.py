"""Causal LM over every family ``repro`` registers: attention (with the
modality frontends), MoE, the Mamba2 hybrid and RWKV6 (port of
``repro.models.lm``).

The model is an ``nn.Module`` tree with ``repro``'s leaf names and (in,
out) weight layout: ``embed`` (the table), ``blocks``, ``final_norm`` and,
untied, ``unembed``, and for a frontend config ``frontend.proj``
(frontend_dim, d_model), which projects the precomputed prefix embeddings
that ``forward``, ``loss_fn`` and ``prefill`` prepend to the tokens
(``loss_fn`` drops those P positions; the decode state's ``pos`` counts
them). ``blocks`` holds one ``Block`` (ln1, attn, ln2, mlp) per layer for
attention archs, one ``MoEBlock`` (ln1, attn, ln2, moe) per layer for MoE,
one ``RWKVBlock`` (ln1, tm, ln2) per layer for RWKV6, one ``MambaBlock``
(ln, mamba) per layer for a pure Mamba2 stack, and for the hybrid
(zamba2) ``num_layers // shared_attn_every`` groups of
``shared_attn_every`` ``MambaBlock``s, each group followed by the ONE
weight-shared attention + MLP block ``shared_attn`` (a single module
applied once per group, as ``repro`` applies one param tree). The
module-level functions keep ``repro``'s names and signatures, with the
module where ``repro`` takes the param pytree:

  forward        — full-sequence logits (training, scoring, datastore builds)
  loss_fn        — next-token cross entropy for the train step
  prefill        — full sequence + the decode state
  decode_step    — one token against the decode state

The layer stack is a Python loop over ``blocks`` (``repro`` scans stacked
params); with ``RunCtx.remat`` and gradients on, each block (each group in
the hybrid) runs under ``torch.utils.checkpoint`` (``repro``'s
``jax.checkpoint`` of the scan body), so the backward pass keeps one
activation per block and recomputes the rest. The decode state keeps
``repro``'s shapes, every leaf stacked on a leading layer axis:

  attention  {"pos": (B,) int32, "cache": KVCache}, k, v (L, B, S_max, KV, hd)
             (MoE too)
  hybrid     {"pos", "cache": {"kv": KVCache (G, B, S_max, KV, hd),
                               "mamba": MambaState (G, per_group, B, ...)}}
  RWKV6      {"pos", "cache": RWKVState (L, B, ...)}

As in ``repro``, a pure Mamba2 stack has no decode step, and a frontend
config's forward, loss and prefill need the prefix (its decode steps take
tokens alone). MoE blocks route through ``models/moe.moe_forward``: the
reference expert loop without a mesh; with ``RunCtx.mesh`` each rank holds
its own experts (``carry.expert_shard``) and its data-parallel slice of
the batch, replicated over ``ep_axis``, and ``a2a`` runs on this rank's
sequence chunk, the chunks gathered back over the expert axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.overrides import _get_current_function_mode_stack
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.models import frontends
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (Attention, KVCache,
                                          attention_decode, attention_init,
                                          attention_prefill)
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, _dtype,
                                       _empty, cross_entropy,
                                       dense_init, embed, embedding_init,
                                       mlp, mlp_init, rmsnorm, unembed)
from repro_torch.models.mamba2 import (Mamba2, MambaState, init_mamba_state,
                                       mamba2_forward, mamba2_init,
                                       mamba2_step)
from repro_torch.models.rwkv6 import (RWKV6, RWKVState, init_rwkv_state,
                                      rwkv6_channel_mix, rwkv6_init,
                                      rwkv6_time_mix)

@dataclasses.dataclass
class RunCtx:
    """Execution-context knobs threaded through the model. ``mesh`` is a
    ``DeviceMesh`` with ``mesh_dim_names``; only the MoE blocks read it
    (expert parallelism over ``ep_axis``). ``aux_mesh`` is the mesh whose
    ranks each hold a slice of the batch while every rank runs the whole
    MoE layer (``pure_dp``, ``repro``'s ``RunCtx(mesh=None)``, or an
    expert axis of size 1): the router's load-balancing statistics are
    summed over it. ``repro``'s
    ``tp_axis`` and activation sharder have no counterpart: the port's
    activations are not sharded."""

    mesh: Any = None
    aux_mesh: Any = None
    dp_axes: Tuple[str, ...] = ("data",)
    ep_axis: str = "model"
    causal_skip: bool = False          # triangular attention schedule
    attn_p_bf16: bool = False          # bf16 probability tensor
    moe_a2a_int8: bool = False         # quantized MoE dispatch
    attn_impl: str = "xla"             # 'xla' (blockwise) | 'flash' (K4)
    remat: bool = True                 # checkpoint each block (with grads)
    attn_chunk: int = 1024
    moe_strategy: str = "auto"


DEFAULT_CTX = RunCtx()


def _groups(cfg: ModelConfig):
    """(groups, per_group) of the hybrid stack."""
    return cfg.num_layers // cfg.shared_attn_every, cfg.shared_attn_every


class Block(nn.Module):
    """Attention + MLP residual block."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm,
                 mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class MoEBlock(nn.Module):
    """Attention + MoE residual block."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm,
                 moe: moe_mod.MoE):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.moe = ln1, attn, ln2, moe


class Frontend(nn.Module):
    """The projection of the frontend's prefix embeddings."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.proj = _empty((frontends.frontend_dim(cfg), cfg.d_model),
                           _dtype(cfg), device)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 residual block."""

    def __init__(self, ln: RMSNorm, mamba: Mamba2):
        super().__init__()
        self.ln, self.mamba = ln, mamba


class RWKVBlock(nn.Module):
    """RWKV6 time-mix + channel-mix residual block (both under ``tm``)."""

    def __init__(self, ln1: RMSNorm, tm: RWKV6, ln2: RMSNorm):
        super().__init__()
        self.ln1, self.tm, self.ln2 = ln1, tm, ln2


class LM(nn.Module):
    def __init__(self, embed: Embedding, blocks, final_norm: RMSNorm,
                 unembed: Optional[Embedding] = None,
                 shared_attn: Optional[Block] = None,
                 frontend: Optional[Frontend] = None):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        if unembed is not None:
            self.unembed = unembed
        if shared_attn is not None:
            self.shared_attn = shared_attn
        if frontend is not None:
            self.frontend = frontend

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def _build(cfg: ModelConfig, device, gen: Optional[torch.Generator] = None
           ) -> LM:
    """The module tree of ``cfg`` on ``device``: weights drawn from ``gen``,
    or left uninitialized when ``gen`` is None."""
    dt, d, hd = _dtype(cfg), cfg.d_model, cfg.resolved_head_dim

    def table():
        if gen is None:
            return Embedding(cfg.vocab_size, d, dt, device)
        return embedding_init(gen, cfg.vocab_size, d, dt, device)

    def attention():
        if gen is None:
            return Attention(d, cfg.num_heads, cfg.num_kv_heads, hd, dt,
                             device)
        return attention_init(gen, d, cfg.num_heads, cfg.num_kv_heads, hd,
                              dt, device)

    def block():
        attn = attention()
        ff = (MLP(d, cfg.d_ff, cfg.mlp_activation, dt, device) if gen is None
              else mlp_init(gen, d, cfg.d_ff, cfg.mlp_activation, dt, device))
        return Block(RMSNorm(d, device), attn, RMSNorm(d, device), ff)

    def moe_block():
        attn = attention()
        experts = (moe_mod.MoE(cfg, dt, device) if gen is None
                   else moe_mod.moe_init(gen, cfg, dt, device))
        return MoEBlock(RMSNorm(d, device), attn, RMSNorm(d, device), experts)

    def mamba_block():
        mix = (Mamba2(cfg, dt, device) if gen is None
               else mamba2_init(gen, cfg, dt, device))
        return MambaBlock(RMSNorm(d, device), mix)

    def rwkv_block():
        mix = (RWKV6(cfg, dt, device) if gen is None
               else rwkv6_init(gen, cfg, dt, device))
        return RWKVBlock(RMSNorm(d, device), mix, RMSNorm(d, device))

    emb = table()
    shared = None
    kind = cfg.block_pattern[0]
    if cfg.shared_attn_every:
        groups, per_group = _groups(cfg)
        blocks = [nn.ModuleList([mamba_block() for _ in range(per_group)])
                  for _ in range(groups)]
        shared = block()
    elif kind == BlockKind.ATTENTION:
        blocks = [block() for _ in range(cfg.num_layers)]
    elif kind == BlockKind.MOE:
        blocks = [moe_block() for _ in range(cfg.num_layers)]
    elif kind == BlockKind.MAMBA2:
        blocks = [mamba_block() for _ in range(cfg.num_layers)]
    elif kind == BlockKind.RWKV6:
        blocks = [rwkv_block() for _ in range(cfg.num_layers)]
    else:
        raise ValueError(kind)
    unemb = None if cfg.tie_embeddings else table()
    front = None
    if cfg.frontend != "none":
        front = Frontend(cfg, device)
        if gen is not None:
            front.proj.copy_(dense_init(gen, *front.proj.shape, dt,
                                        device=device))
    return LM(emb, blocks, RMSNorm(d, device), unemb, shared, front)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> LM:
    """The model with weights drawn from ``gen`` (on the generator's
    device, then moved), on ``device`` — CUDA unless ``device="cpu"``."""
    return _build(cfg, device_mod.resolve(device), gen)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the constructed module; with ``active_only`` an MoE
    model counts its experts (``w_gate``, ``w_up``, ``w_out``) at the
    routed fraction K/E, as ``repro`` does."""
    named = dict(_build(cfg, "meta").named_parameters())
    total = sum(p.numel() for p in named.values())
    if active_only and cfg.moe is not None:
        expert_total = sum(p.numel() for n, p in named.items()
                           if n.split(".")[2:] in (["moe", "w_gate"],
                                                   ["moe", "w_up"],
                                                   ["moe", "w_out"]))
        active_frac = cfg.moe.experts_per_token / cfg.moe.num_experts
        total = total - expert_total + int(expert_total * active_frac)
    return total


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
    """Token embeddings (gemma-scaled), with a frontend config's projected
    prefix (B, P, frontend_dim) prepended; positions over S + P."""
    x = _embed_scale(cfg, embed(model.embed, tokens))
    if cfg.frontend != "none":
        if prefix_emb is None:
            raise ValueError(f"{cfg.name} requires frontend embeddings "
                             f"(prefix_emb)")
        pre = torch.as_tensor(prefix_emb, device=x.device).to(x.dtype)
        x = torch.cat([pre @ model.frontend.proj, x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _attn_prefill(p, cfg: ModelConfig, ctx: RunCtx, x, positions,
                  want_cache: bool):
    """x + the block's attention over the full sequence, and its cache."""
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    out = attention_prefill(p.attn, h, positions, cfg.rope_theta,
                            chunk=ctx.attn_chunk, causal_skip=ctx.causal_skip,
                            p_bf16=ctx.attn_p_bf16, impl=ctx.attn_impl,
                            return_cache=want_cache)
    a, cache = out if want_cache else (out, None)
    return x + a, cache


def _apply_attn_mlp(p: Block, cfg: ModelConfig, ctx: RunCtx, x, positions,
                    want_cache: bool):
    x, cache = _attn_prefill(p, cfg, ctx, x, positions, want_cache)
    x = x + mlp(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps), cfg.mlp_activation)
    return x, cache


def _moe(p: moe_mod.MoE, cfg: ModelConfig, ctx: RunCtx, h, strategy: str,
         a2a_int8: bool):
    """``moe_forward`` on the block's normed (B, S, d) input. On a mesh
    ``h`` is this rank's batch slice, replicated over ``ctx.ep_axis``:
    ``a2a`` runs on this rank's S / n chunk (``moe.ep_chunk``) and the
    chunks are gathered back over the expert axis (``moe.ep_gather``,
    through ``ops._all_gather``) before the shared and dense branches,
    which run on the whole ``h`` as ``repro`` runs them outside its
    ``shard_map``."""
    n = moe_mod.ep_size(ctx.mesh, ctx.ep_axis)
    kw = dict(mesh=ctx.mesh, dp_axes=ctx.dp_axes, ep_axis=ctx.ep_axis,
              a2a_int8=a2a_int8)
    if n == 1:
        return moe_mod.moe_forward(p, cfg, h, aux_mesh=ctx.aux_mesh, **kw)
    B, S, d = h.shape
    strategy = moe_mod.resolve_strategy(strategy, S, n)
    if strategy != "a2a":
        return moe_mod.moe_forward(p, cfg, h, strategy=strategy, **kw)
    r = int(ctx.mesh.get_local_rank(ctx.ep_axis))
    y, aux = moe_mod.moe_routed(
        p, cfg, moe_mod.ep_chunk(h, ctx.mesh, ctx.ep_axis, r, n),
        strategy="a2a", **kw)
    chunks = moe_mod.ep_gather(y, ctx.mesh, ctx.ep_axis, r, n)
    y = chunks.permute(1, 0, 2, 3).reshape(B, S, d)
    return moe_mod.add_dense_branches(p, cfg, h, y), aux


def _apply_moe_block(p: MoEBlock, cfg: ModelConfig, ctx: RunCtx, x,
                     positions, want_cache: bool):
    """Returns (x, aux, cache)."""
    x, cache = _attn_prefill(p, cfg, ctx, x, positions, want_cache)
    y, aux = _moe(p.moe, cfg, ctx, rmsnorm(p.ln2, x, cfg.norm_eps),
                  ctx.moe_strategy, ctx.moe_a2a_int8)
    return x + y, aux, cache


def _apply_mamba_block(p: MambaBlock, cfg: ModelConfig, x,
                       want_state: bool):
    y = mamba2_forward(p.mamba, cfg, rmsnorm(p.ln, x, cfg.norm_eps),
                       return_state=want_state)
    y, st = y if want_state else (y, None)
    return x + y, st


def _apply_rwkv_block(p: RWKVBlock, cfg: ModelConfig, x, want_state: bool,
                      state: Optional[RWKVState] = None):
    """From ``state`` (decode) or a zero state (prefill); the new state
    when ``want_state``."""
    out = rwkv6_time_mix(p.tm, cfg, rmsnorm(p.ln1, x, cfg.norm_eps), state,
                         return_state=want_state)
    tm, s_fin, last_t = out if want_state else (out, None, None)
    h = x + tm
    out = rwkv6_channel_mix(p.tm, cfg, rmsnorm(p.ln2, h, cfg.norm_eps), state,
                            return_state=want_state)
    cm, last_c = out if want_state else (out, None)
    new = (RWKVState(wkv=s_fin, shift_t=last_t, shift_c=last_c)
           if want_state else None)
    return h + cm, new


def _stack(items):
    """A list of NamedTuples of tensors -> one of stacked tensors."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def _at(state, *idx):
    """The layer ``idx`` of a stacked NamedTuple state."""
    return type(state)(*(f[idx] for f in state))


def _stack_units(model: LM, cfg: ModelConfig, ctx: RunCtx, positions,
                 want_cache: bool):
    """The stack as (unit, fn) pairs with ``fn(unit, x) -> (x, aux,
    cache)`` (aux None but for MoE blocks): one per block, one per group
    in the hybrid, and the function that stacks the units' caches into the
    decode state's ``cache``."""
    kind = cfg.block_pattern[0]
    if cfg.shared_attn_every:
        def group(blocks, x):
            sts = []
            for blk in blocks:
                x, st = _apply_mamba_block(blk, cfg, x, want_cache)
                sts.append(st)
            x, kv = _apply_attn_mlp(model.shared_attn, cfg, ctx, x,
                                    positions, want_cache)
            return x, None, (_stack(sts) if want_cache else None, kv)

        finish = lambda cs: {"kv": _stack([c[1] for c in cs]),
                             "mamba": _stack([c[0] for c in cs])}
        return [(g, group) for g in model.blocks], finish

    def no_aux(f):
        def unit(blk, x):
            y, cache = f(blk, x)
            return y, None, cache
        return unit

    if kind == BlockKind.ATTENTION:
        fn = no_aux(lambda blk, x: _apply_attn_mlp(blk, cfg, ctx, x,
                                                   positions, want_cache))
    elif kind == BlockKind.MOE:
        fn = lambda blk, x: _apply_moe_block(blk, cfg, ctx, x, positions,
                                             want_cache)
    elif kind == BlockKind.MAMBA2:
        fn = no_aux(lambda blk, x: _apply_mamba_block(blk, cfg, x,
                                                      want_cache))
    elif kind == BlockKind.RWKV6:
        fn = no_aux(lambda blk, x: _apply_rwkv_block(blk, cfg, x,
                                                     want_cache))
    else:
        raise ValueError(kind)
    return [(blk, fn) for blk in model.blocks], _stack


def _same_function_modes():
    """``checkpoint``'s contexts: the recomputation runs under the torch
    function modes the forward ran under (the autograd engine does not
    carry them into the backward pass; ``launch/op_analysis`` counts
    ``torch.einsum`` through one)."""
    modes = _get_current_function_mode_stack()

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            for m in modes:
                stack.enter_context(m)
            yield

    return contextlib.nullcontext(), recompute()


def _run_stack(model: LM, cfg: ModelConfig, ctx: RunCtx, x, positions,
               want_cache: bool = False):
    """Returns (hidden, aux_loss, the decode state's cache or None); the
    aux loss is the sum of the MoE blocks' (0 without them)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    units, finish = _stack_units(model, cfg, ctx, positions, want_cache)
    remat = not want_cache and ctx.remat and torch.is_grad_enabled()
    caches = []
    for unit, fn in units:
        if remat:
            x, aux_l = checkpoint(lambda u, h, f=fn: f(u, h)[:2], unit, x,
                                  use_reentrant=False,
                                  context_fn=_same_function_modes)
        else:
            x, aux_l, cache = fn(unit, x)
            caches.append(cache)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux, finish(caches) if want_cache else None


def _logits(model: LM, cfg: ModelConfig, x):
    h = rmsnorm(model.final_norm, x, cfg.norm_eps)
    table = model.embed if cfg.tie_embeddings else model.unembed
    return unembed(table, h), h


def forward(model: LM, cfg: ModelConfig, tokens, prefix_emb=None,
            ctx: RunCtx = DEFAULT_CTX, return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S(+P), V), aux[, final-norm
    hidden])."""
    x, positions = _embed_inputs(model, cfg, tokens, prefix_emb)
    x, aux, _ = _run_stack(model, cfg, ctx, x, positions, want_cache=False)
    logits, h = _logits(model, cfg, x)
    if return_hidden:
        return logits, aux, h
    return logits, aux


def loss_fn(model: LM, cfg: ModelConfig, batch, ctx: RunCtx = DEFAULT_CTX):
    """batch: {'tokens': (B,S), 'labels': (B,S), optional 'mask' and
    'prefix_emb'} -> (loss, {'ce', 'aux'}). The frontend's P prefix
    positions are dropped from the loss; the aux weight is the MoE
    router's (0 without MoE)."""
    logits, aux = forward(model, cfg, batch["tokens"],
                          batch.get("prefix_emb"), ctx)
    P = logits.shape[1] - batch["labels"].shape[1]
    if P:
        logits = logits[:, P:]
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    aux_w = cfg.moe.router_aux_loss if cfg.moe is not None else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def prefill(model: LM, cfg: ModelConfig, tokens, prefix_emb=None,
            ctx: RunCtx = DEFAULT_CTX):
    """Full-sequence forward that also returns the decode state (KV
    caches, Mamba2 states or RWKV states, as the family has); its ``pos``
    counts the prefix positions too."""
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


def _decode_moe_block(p: MoEBlock, cfg: ModelConfig, ctx: RunCtx, x,
                      cache: KVCache, pos, active):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    y, new_cache = attention_decode(p.attn, h, cache, pos, cfg.rope_theta,
                                    active=active)
    x = x + y
    # repro's decode passes no a2a_int8, and allgather on a mesh
    y2, _ = _moe(p.moe, cfg, ctx, rmsnorm(p.ln2, x, cfg.norm_eps),
                 "allgather" if ctx.mesh is not None else "auto", False)
    return x + y2, new_cache


def _decode_mamba(blk: MambaBlock, cfg: ModelConfig, x, st: MambaState,
                  active):
    y, new_st = mamba2_step(blk.mamba, cfg, rmsnorm(blk.ln, x, cfg.norm_eps),
                            st)
    return x + y, _keep_active(active, new_st, st)


def decode_step(model: LM, cfg: ModelConfig, token, state,
                ctx: RunCtx = DEFAULT_CTX, active=None,
                return_hidden: bool = False):
    """token: (B, 1) int; state from ``init_decode_state`` or ``prefill``.
    ``pos`` may be per-row; rows with ``active`` False (continuous batching
    free slots) keep their state unchanged.

    Returns (logits (B,1,V), new_state[, hidden]); ``state`` itself is not
    modified."""
    kind = cfg.block_pattern[0]
    B = token.shape[0]
    pos = torch.as_tensor(state["pos"], dtype=torch.int32,
                          device=token.device)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    x = _embed_scale(cfg, embed(model.embed, token))
    cache = state["cache"]
    if cfg.shared_attn_every:
        kvs, ms = [], []
        for g, group in enumerate(model.blocks):
            sts = []
            for i, blk in enumerate(group):
                x, st = _decode_mamba(blk, cfg, x, _at(cache["mamba"], g, i),
                                      active)
                sts.append(st)
            x, kv = _decode_attn_mlp(model.shared_attn, cfg, ctx, x,
                                     _at(cache["kv"], g), pos, active)
            kvs.append(kv)
            ms.append(_stack(sts))
        new_cache = {"kv": _stack(kvs), "mamba": _stack(ms)}
    elif kind in (BlockKind.ATTENTION, BlockKind.MOE):
        layer = (_decode_attn_mlp if kind == BlockKind.ATTENTION
                 else _decode_moe_block)
        kvs = []
        for i, blk in enumerate(model.blocks):
            x, kv = layer(blk, cfg, ctx, x, _at(cache, i), pos, active)
            kvs.append(kv)
        new_cache = _stack(kvs)
    elif kind == BlockKind.RWKV6:
        sts = []
        for i, blk in enumerate(model.blocks):
            st = _at(cache, i)
            x, new_st = _apply_rwkv_block(blk, cfg, x, True, st)
            sts.append(_keep_active(active, new_st, st))
        new_cache = _stack(sts)
    else:
        # repro's decode_step has no branch for a pure Mamba2 stack
        raise ValueError(kind)
    logits, h = _logits(model, cfg, x)
    new_pos = pos + (1 if active is None else active.to(torch.int32))
    new_state = {"pos": new_pos, "cache": new_cache}
    if return_hidden:
        return logits, new_state, h
    return logits, new_state


def pad_decode_state(cfg: ModelConfig, state, max_len: int):
    """Grow the KV-cache capacity of a prefill state to ``max_len``; the
    recurrent states have no length and stay as they are."""

    def pad(a):
        extra = max_len - a.shape[2]
        if extra <= 0:
            return a
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, extra))

    pad_kv = lambda c: KVCache(k=pad(c.k), v=pad(c.v))
    cache = state["cache"]
    if cfg.shared_attn_every:
        cache = {"kv": pad_kv(cache["kv"]), "mamba": cache["mamba"]}
    elif isinstance(cache, KVCache):
        cache = pad_kv(cache)
    return {"pos": state["pos"], "cache": cache}


def zero_recurrent_row(cfg: ModelConfig, cache, row: int):
    """The decode state's ``cache`` with batch row ``row`` of every
    recurrent leaf (the Mamba2 and RWKV6 states) zeroed, as a fresh state
    has it; KV caches come back as they are (their stale rows are masked
    by position). ``cache`` itself is not modified."""
    def zero(st, axis):
        idx = torch.tensor([row], device=st[0].device)
        return type(st)(*(a.index_fill(axis, idx, 0) for a in st))

    if cfg.shared_attn_every:
        return {"kv": cache["kv"], "mamba": zero(cache["mamba"], 2)}
    if isinstance(cache, KVCache):
        return cache
    return zero(cache, 1)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """Zero decode state with capacity ``max_len``, on ``device`` — CUDA
    unless ``device="cpu"``."""
    dev = device_mod.resolve(device)

    def kv(n_stack):
        shape = (n_stack, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        zeros = lambda: torch.zeros(shape, dtype=_dtype(cfg), device=dev)
        return KVCache(k=zeros(), v=zeros())

    def stacked(st, *lead):
        return type(st)(*(torch.zeros(lead + tuple(a.shape), dtype=a.dtype,
                                      device=dev) for a in st))

    pos0 = torch.zeros((batch,), dtype=torch.int32, device=dev)
    kind = cfg.block_pattern[0]
    if cfg.shared_attn_every:
        ms = stacked(init_mamba_state(cfg, batch, "meta"), *_groups(cfg))
        return {"pos": pos0, "cache": {"kv": kv(_groups(cfg)[0]),
                                       "mamba": ms}}
    if kind in (BlockKind.ATTENTION, BlockKind.MOE):
        return {"pos": pos0, "cache": kv(cfg.num_layers)}
    if kind == BlockKind.RWKV6:
        return {"pos": pos0, "cache": stacked(
            init_rwkv_state(cfg, batch, "meta"), cfg.num_layers)}
    if kind == BlockKind.MAMBA2:
        return {"pos": pos0, "cache": stacked(
            init_mamba_state(cfg, batch, "meta"), cfg.num_layers)}
    raise ValueError(kind)
