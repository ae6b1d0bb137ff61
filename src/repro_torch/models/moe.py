"""Mixture-of-Experts FFN with expert parallelism on ``torch.distributed``
(port of ``repro.models.moe``).

Three execution strategies, as in ``repro``:

* ``reference`` — loop over experts with masking; exact, used on a single
  device (and the numerics oracle). Every expert runs on every token, E/K
  times the routed work: ``repro``'s single-device design, kept.
* ``a2a`` — production EP: tokens are sequence-sharded over the expert
  axis, routed entries are exchanged with an all-to-all (dispatch), expert
  FFNs run on their owning rank, and a reverse all-to-all returns outputs
  (drop policy at static capacity).
* ``allgather`` — decode-friendly: tokens are replicated over the expert
  axis, every rank computes only its local experts' assignments, and an
  ``all_reduce`` (``repro``'s psum) combines partial outputs.

The weights live in an ``MoE`` module under ``repro``'s leaf names:
``router`` (d, E) in **f32 whatever the model dtype**, ``w_gate`` and
``w_up`` (E, d, ff), ``w_out`` (E, ff, d), and the optional ``shared``
(a swiglu MLP of width ``expert_d_ff * num_shared_experts``) and ``dense``
(the dense residual, ``cfg.mlp_activation``) MLPs.

**Expert parallelism.** Where ``repro`` runs under ``shard_map`` on the
global arrays, a rank here passes its own slice and its own experts, as
the sharded search does: ``x`` is (B_loc, S / n, d) for ``a2a`` (sharded
over the batch on the data axes and over the sequence on ``ep_axis``) and
(B_loc, S, d) for ``allgather`` (replicated over ``ep_axis``); the module
holds experts [r·E/n, (r+1)·E/n) of rank r of ``ep_axis``
(``carry.expert_shard`` slices them). The all-to-all group is the
``DeviceMesh``'s subgroup of ``ep_axis`` at this rank's data coordinates,
which every rank creates in the same order when the mesh is built. How
an all-to-all travels is ``a2a_transport``'s choice.

Dropped entries (past a capacity) are masked out, never clamped into a
slot: ``repro``'s ``.at[...].set(mode="drop")`` writes nothing for them.
Routes take ties to the lower expert id, as ``lax.top_k`` does.

**Under autograd** the collectives are ``torch.autograd.Function``s whose
backward is the transpose ``shard_map`` gives the same code (with its
replication checks off, as ``repro`` runs it), on the same transport:

* the all-to-all's backward is the reverse all-to-all (the same
  exchange: chunk i goes to rank i);
* a psum's backward is the psum of the cotangent;
* an input replicated over ``ep_axis`` (the router; the tokens under
  ``allgather``) enters through ``_ep_entry``, whose backward sums the
  cotangent over the expert axis (``shard_map`` sums an input's
  cotangent over the axes its spec leaves out);
* an output replicated over ``ep_axis`` (``allgather``'s y, the aux)
  leaves through ``_ep_exit``, whose backward divides the cotangent by
  the axis size (``shard_map`` divides an output's cotangent by its
  replica count).

The data axes need neither: a rank's loss is its own batch slice's, and
the train step averages the gradients over the ranks that hold
different data (``dist/steps.py``). The int8 dispatch's codes carry no
gradient (``repro``'s ``astype(int8)``): the gradient reaches the
payload through its scale alone.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import _all_gather, _psum, axis_size, n_shards_of
from repro_torch.models.layers import (MLP, _empty, _normal, _param, mlp,
                                       mlp_init)

# the f32 reciprocal XLA multiplies by where the reference divides by 127
_INV127 = 1.0 / 127.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class MoE(nn.Module):
    """The experts, the f32 router and the optional shared / dense MLPs.
    ``num_experts`` is the count this module holds: E, or E/n for one
    rank's shard."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 num_experts: Optional[int] = None):
        super().__init__()
        moe = cfg.moe
        d, ff = cfg.d_model, moe.expert_d_ff
        E = moe.num_experts if num_experts is None else num_experts
        self.router = _param(torch.empty((d, moe.num_experts),
                                         dtype=torch.float32, device=device))
        self.w_gate = _empty((E, d, ff), dtype, device)
        self.w_up = _empty((E, d, ff), dtype, device)
        self.w_out = _empty((E, ff, d), dtype, device)
        if moe.num_shared_experts:
            self.shared = MLP(d, ff * moe.num_shared_experts, "swiglu", dtype,
                              device)
        if moe.dense_residual_d_ff:
            self.dense = MLP(d, moe.dense_residual_d_ff, cfg.mlp_activation,
                             dtype, device)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             device=None) -> MoE:
    """The layer with weights drawn from ``gen`` at ``repro``'s scales:
    router and ``w_gate`` / ``w_up`` d^-1/2, ``w_out`` ff^-1/2. Each
    expert's matrix is drawn on its own, so the f32 draw never holds more
    than one expert."""
    d, ff = cfg.d_model, cfg.moe.expert_d_ff
    dev = device if device is not None else gen.device
    m = MoE(cfg, dtype, dev)
    m.router.copy_(_normal(gen, m.router.shape, d ** -0.5, torch.float32,
                           dev))
    for w, scale in ((m.w_gate, d ** -0.5), (m.w_up, d ** -0.5),
                     (m.w_out, ff ** -0.5)):
        for e in range(w.shape[0]):
            w[e].copy_(_normal(gen, w.shape[1:], scale, dtype, dev))
    moe = cfg.moe
    if moe.num_shared_experts:
        m.shared = mlp_init(gen, d, ff * moe.num_shared_experts, "swiglu",
                            dtype, dev)
    if moe.dense_residual_d_ff:
        m.dense = mlp_init(gen, d, moe.dense_residual_d_ff,
                           cfg.mlp_activation, dtype, dev)
    return m


def _route(router_w: torch.Tensor, x_tok: torch.Tensor, k: int):
    """x_tok: (T, d) -> (weights (T,K) f32, idx (T,K) int64, probs (T,E)
    f32). The top k by a stable descending sort, so equal probabilities
    go to the lower expert id (``lax.top_k``'s order; ``torch.topk``
    leaves ties unordered)."""
    logits = x_tok.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx, probs


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor,
              num_experts: int, mesh=None) -> torch.Tensor:
    """Switch-style load-balancing loss (local shard statistics). With
    ``mesh`` (the unsharded layer on ranks that each hold a slice of the
    batch: ``pure_dp``) the expert counts and the probabilities are summed
    over all its ranks first, so the loss is the global batch's, as
    ``repro``'s on its global arrays."""
    T, K = idx.shape
    f = torch.zeros((num_experts,), dtype=torch.float32, device=idx.device)
    f = f.index_add(0, idx.reshape(-1),
                    torch.ones((T * K,), dtype=torch.float32,
                               device=idx.device))
    if mesh is None:
        f = f / (T * K)
        p_mean = probs.mean(0)
    else:
        axes, n = tuple(mesh.mesh_dim_names), mesh.size()
        f = _psum(f, mesh, axes) / (T * K * n)
        p_mean = _psum(probs.sum(0), mesh, axes) / (T * n)
    return num_experts * torch.sum(f * p_mean)


def _expert_ffn(w_gate, w_up, w_out, xbuf: torch.Tensor) -> torch.Tensor:
    """xbuf: (E_loc, C, d) -> (E_loc, C, d)."""
    g = torch.einsum("ecd,edf->ecf", xbuf, w_gate)
    u = torch.einsum("ecd,edf->ecf", xbuf, w_up)
    h = (F.silu(g.float()) * u.float()).to(xbuf.dtype)
    return torch.einsum("ecf,efd->ecd", h, w_out)


def _rank_in_group(group: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Stable rank of each element within its group. group: (N,) int in
    [0, G)."""
    oh = F.one_hot(group.long(), num_groups).to(torch.int32)      # (N, G)
    ranks = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    return ranks[torch.arange(group.shape[0], device=group.device),
                 group.long()]


def _put_kept(buf: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
              keep: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``buf`` (n, c + 1, ...) with ``values`` written at (i, j) where
    ``keep``, cut to (n, c, ...): a dropped entry goes to the scratch
    column c, as ``repro``'s ``.at[...].set(mode="drop")`` writes nothing
    for an index out of bounds. Every shape is the data's, so the write traces on
    fake tensors."""
    c = buf.shape[1] - 1
    buf[torch.where(keep, i, 0), torch.where(keep, j, c)] = values
    return buf[:, :c]


def _take_kept(src: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Rows ``src[i, j]`` where ``keep``, zero rows elsewhere."""
    rows = src[torch.where(keep, i, 0), torch.where(keep, j, 0)]
    return torch.where(keep[:, None], rows, 0)


def _combine(flat_w: torch.Tensor, y_slot: torch.Tensor, T: int,
             K: int) -> torch.Tensor:
    """(T, d) f32: each token's K weighted outputs added in top-k order
    to a zero row — the order of ``repro``'s ``out.at[flat_tok].add``."""
    terms = (flat_w[:, None] * y_slot.float()).reshape(T, K, -1)
    out = torch.zeros_like(terms[:, 0])
    for j in range(K):
        out = out + terms[:, j]
    return out


# ---------------------------------------------------------------------------
# reference path
# ---------------------------------------------------------------------------

def moe_reference(params: MoE, cfg: ModelConfig, x_tok: torch.Tensor,
                  aux_mesh=None):
    """Exact capacity-free MoE on one device. x_tok: (T, d). y is
    accumulated in f32 in expert order 0..E-1, as ``repro``'s scan.
    ``aux_mesh``: the ranks over which the batch is split (``_aux_loss``)."""
    moe = cfg.moe
    weights, idx, probs = _route(params.router, x_tok, moe.experts_per_token)
    y = torch.zeros(x_tok.shape, dtype=torch.float32, device=x_tok.device)
    for e in range(moe.num_experts):
        w_e = torch.where(idx == e, weights, 0.0).sum(-1)          # (T,)
        g = F.silu((x_tok @ params.w_gate[e]).float())
        u = (x_tok @ params.w_up[e]).float()
        out = (g * u).to(x_tok.dtype) @ params.w_out[e]
        y = y + w_e[:, None] * out.float()
    return y.to(x_tok.dtype), _aux_loss(probs, idx, moe.num_experts,
                                        aux_mesh)


# ---------------------------------------------------------------------------
# the all-to-all
# ---------------------------------------------------------------------------

def a2a_transport(x: torch.Tensor, group) -> str:
    """How ``_all_to_all`` moves ``x`` over ``group``: ``"all_reduce"`` on
    gloo with a CUDA tensor, ``"all_to_all_single"`` otherwise.

    Gloo runs ``all_to_all_single`` on CPU tensors only; for CUDA tensors
    it takes ``all_reduce`` alone. So with gloo on the card (several ranks
    sharing it) each rank writes its n outgoing chunks into its own row of
    a zeroed (n, n, ...) buffer, one ``all_reduce(SUM)`` adds the buffers,
    and rank r reads column r: every slot has one writer, so the sum is
    the payload's exact bits, at n times the bytes. NCCL and gloo on CPU
    tensors exchange the chunks directly."""
    if dist.get_backend(group) == "gloo" and x.is_cuda:
        return "all_reduce"
    return "all_to_all_single"


def _exchange(x: torch.Tensor, group, transport: str) -> torch.Tensor:
    x = x.contiguous()
    if transport == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    if transport != "all_reduce":
        raise ValueError(f"unknown transport {transport!r}")
    n, me = x.shape[0], dist.get_rank(group)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[me] = x
    dist.all_reduce(buf, group=group)
    return buf[:, me].contiguous()


class _AllToAll(torch.autograd.Function):
    """The exchange under autograd; its backward is the same exchange of
    the cotangent (``lax.all_to_all``'s transpose at split = concat = 0)."""

    @staticmethod
    def forward(ctx, x, group, transport):
        ctx.group, ctx.transport = group, transport
        return _exchange(x, group, transport)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.transport), None, None


def _all_to_all(x: torch.Tensor, group, transport: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` over ``group``:
    chunk i of axis 0 (size n) goes to the group's rank i, and what
    arrives is stacked by source rank."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group, transport)
    return _exchange(x, group, transport)


class _EpEntry(torch.autograd.Function):
    """Identity; the backward sums the cotangent over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _EpExit(torch.autograd.Function):
    """Identity; the backward divides the cotangent by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ChunkOf(torch.autograd.Function):
    """Chunk ``r`` of ``n`` along axis 1 of a tensor replicated over the
    mesh's ``ep_axis``; the backward gathers every rank's chunk cotangent
    into the whole (the sum over the axis of the zero-padded chunks)."""

    @staticmethod
    def forward(ctx, x, mesh, ep_axis, r, n):
        ctx.mesh, ctx.axes, ctx.r, ctx.n = mesh, (ep_axis,), r, n
        s = x.shape[1] // n
        return x[:, r * s:(r + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = _all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.n, ctx.r)
        return torch.cat(parts.unbind(0), dim=1), None, None, None, None


class _GatherChunks(torch.autograd.Function):
    """(n, *y.shape): every rank's ``y`` by rank over the mesh's
    ``ep_axis``, to be used alike by every rank of it; the backward is
    this rank's own row of the cotangent (each rank's loss already counts
    every row once)."""

    @staticmethod
    def forward(ctx, y, mesh, ep_axis, r, n):
        ctx.r = r
        return _all_gather(y, mesh, (ep_axis,), n, r)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.r].contiguous(), None, None, None, None


def ep_chunk(x: torch.Tensor, mesh, ep_axis: str, r: int,
             n: int) -> torch.Tensor:
    """Rank ``r``'s sequence chunk of the (B, S, d) ``x`` that every rank
    of the expert axis holds alike: the ``a2a`` strategy's input."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ChunkOf.apply(x, mesh, ep_axis, r, n)
    s = x.shape[1] // n
    return x[:, r * s:(r + 1) * s]


def ep_gather(y: torch.Tensor, mesh, ep_axis: str, r: int,
              n: int) -> torch.Tensor:
    """The ``a2a`` chunks of every rank of the expert axis, (n, B, S/n,
    d), the same on every rank."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _GatherChunks.apply(y, mesh, ep_axis, r, n)
    return _all_gather(y, mesh, (ep_axis,), n, r)


def _ep_entry(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over the expert axis, entering the EP region
    (module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _EpEntry.apply(x, group)
    return x


def _ep_exit(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``, replicated over the expert axis of size ``n``, leaving the
    EP region (module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _EpExit.apply(x, n)
    return x


def _a2a_quantized(x: torch.Tensor, group, transport: str,
                   int8: bool) -> torch.Tensor:
    """all_to_all with optional int8 payload (per-slot scales) — halves the
    dispatch bytes vs bf16. The scale is ``max|x| / 127`` through the f32
    reciprocal (the reference's jitted division); ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    if not int8:
        return _all_to_all(x, group, transport)
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) * _INV127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    rq = _all_to_all(q, group, transport)
    rs = _all_to_all(scale, group, transport)
    return (rq.float() * rs).to(x.dtype)


# ---------------------------------------------------------------------------
# EP via all-to-all (sequence-sharded tokens)
# ---------------------------------------------------------------------------

def _moe_a2a_local(params: MoE, cfg: ModelConfig, x_loc: torch.Tensor,
                   group, n_shards: int, a2a_int8: bool = False):
    """One rank's share. x_loc: (T_loc, d); ``params`` holds this rank's
    E/n experts and the whole router."""
    moe = cfg.moe
    K, E = moe.experts_per_token, moe.num_experts
    E_loc = E // n_shards
    T_loc, d = x_loc.shape
    transport = a2a_transport(x_loc, group)

    weights, idx, probs = _route(_ep_entry(params.router, group), x_loc, K)
    aux = _aux_loss(probs, idx, E)

    # --- dispatch: pack entries per destination shard -----------------------
    flat_e = idx.reshape(-1)                                   # (T_loc*K,)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(T_loc * K, device=x_loc.device) // K
    dest = flat_e // E_loc
    # int() truncates, as repro's Python arithmetic does
    c_send = _round_up(max(1, int(moe.capacity_factor * T_loc * K
                                  / n_shards)), 8)
    rank = _rank_in_group(dest, n_shards)
    keep = rank < c_send

    send_x = _put_kept(x_loc.new_zeros((n_shards, c_send + 1, d)), dest,
                       rank, keep, x_loc[flat_tok])
    send_eid = _put_kept(torch.full((n_shards, c_send + 1), -1,
                                    dtype=torch.int32, device=x_loc.device),
                         dest, rank, keep, flat_e.to(torch.int32))

    recv_x = _a2a_quantized(send_x, group, transport, a2a_int8)
    recv_eid = _all_to_all(send_eid, group, transport)

    # --- local expert compute ------------------------------------------------
    rx = recv_x.reshape(-1, d)                             # (n*c_send, d)
    re = recv_eid.reshape(-1).long()
    valid = re >= 0
    eloc = torch.where(valid, re % E_loc, 0)
    c_exp = _round_up(max(1, int(moe.capacity_factor * rx.shape[0]
                                 / E_loc)), 8)
    erank = _rank_in_group(torch.where(valid, eloc, E_loc), E_loc + 1)
    ekeep = valid & (erank < c_exp)
    xbuf = _put_kept(x_loc.new_zeros((E_loc, c_exp + 1, d)), eloc, erank,
                     ekeep, rx)
    ybuf = _expert_ffn(params.w_gate, params.w_up, params.w_out, xbuf)
    ry = _take_kept(ybuf, eloc, erank, ekeep)

    # --- return + combine ----------------------------------------------------
    back = _a2a_quantized(ry.reshape(n_shards, c_send, d), group, transport,
                          a2a_int8)
    y_slot = _take_kept(back, dest, rank, keep)
    out = _combine(flat_w, y_slot, T_loc, K)
    return out.to(x_loc.dtype), aux


# ---------------------------------------------------------------------------
# EP via token replication + all_reduce (decode)
# ---------------------------------------------------------------------------

def _moe_allgather_local(params: MoE, cfg: ModelConfig, x_loc: torch.Tensor,
                         mesh, ep_axis: str):
    """Tokens replicated over the expert axis; each rank computes its local
    experts and partial outputs are summed over ``ep_axis``. x_loc: (T,
    d)."""
    moe = cfg.moe
    K, E = moe.experts_per_token, moe.num_experts
    n_shards = ep_size(mesh, ep_axis)
    shard = int(mesh.get_local_rank(ep_axis))
    group = mesh.get_group(ep_axis)
    E_loc = E // n_shards
    T, d = x_loc.shape
    x_loc = _ep_entry(x_loc, group)

    weights, idx, probs = _route(_ep_entry(params.router, group), x_loc, K)
    aux = _aux_loss(probs, idx, E)

    flat_e = idx.reshape(-1)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(T * K, device=x_loc.device) // K
    mine = (flat_e // E_loc) == shard
    eloc = torch.where(mine, flat_e % E_loc, E_loc)
    c_exp = _round_up(max(1, int(moe.capacity_factor * T * K / E)), 8)
    rank = _rank_in_group(eloc, E_loc + 1)
    keep = mine & (rank < c_exp)
    xbuf = _put_kept(x_loc.new_zeros((E_loc, c_exp + 1, d)), eloc, rank,
                     keep, x_loc[flat_tok])
    ybuf = _expert_ffn(params.w_gate, params.w_up, params.w_out, xbuf)
    y_slot = _take_kept(ybuf, eloc, rank, keep)
    out = _combine(flat_w, y_slot, T, K)
    out = _ep_exit(_psum(out, mesh, (ep_axis,)), n_shards)
    return out.to(x_loc.dtype), aux


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def ep_size(mesh, ep_axis: str) -> int:
    """The expert-parallel degree: the size of ``ep_axis``, or 1 without a
    mesh or without that axis (then ``moe_forward`` runs the reference)."""
    if mesh is None or ep_axis not in mesh.mesh_dim_names:
        return 1
    return axis_size(mesh, ep_axis)


def resolve_strategy(strategy: str, seq_len: int, n_shards: int) -> str:
    """``"auto"`` -> ``"a2a"`` when the GLOBAL sequence length splits
    evenly over the expert axis (``S % n == 0 and S >= n``), else
    ``"allgather"``; a named strategy is returned as it is."""
    if strategy != "auto":
        return strategy
    even = seq_len % n_shards == 0 and seq_len >= n_shards
    return "a2a" if even else "allgather"


def moe_forward(params: MoE, cfg: ModelConfig, x: torch.Tensor, mesh=None,
                dp_axes: Sequence[str] = ("data",), ep_axis: str = "model",
                strategy: str = "auto", a2a_int8: bool = False,
                aux_mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Adds shared-expert and dense-residual
    branches per config (plain MLPs outside the EP path).

    Without a mesh (or with ``ep_axis`` of size 1) this is
    ``moe_reference`` over all tokens (its aux over ``aux_mesh``'s ranks,
    when the batch is split over them). On a mesh, ``x`` and ``params``
    are this rank's slice and experts (module docstring) and the result
    is this rank's slice; ``aux`` is averaged over every axis. There the
    strategy must be named: ``"auto"`` depends on the global sequence
    length, which ``repro`` reads from the unsharded x and a rank's slice
    does not show (``resolve_strategy`` resolves it from that length)."""
    y, aux = moe_routed(params, cfg, x, mesh, dp_axes, ep_axis, strategy,
                        a2a_int8, aux_mesh)
    return add_dense_branches(params, cfg, x, y), aux


def moe_routed(params: MoE, cfg: ModelConfig, x: torch.Tensor, mesh=None,
               dp_axes: Sequence[str] = ("data",), ep_axis: str = "model",
               strategy: str = "auto", a2a_int8: bool = False,
               aux_mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_forward`` without the shared and dense branches: the routed
    experts' (y, aux)."""
    B, S, d = x.shape
    n_shards = ep_size(mesh, ep_axis)
    if n_shards == 1:
        y_tok, aux = moe_reference(params, cfg, x.reshape(-1, d), aux_mesh)
        return y_tok.reshape(B, S, d), aux
    group = mesh.get_group(ep_axis)
    x_tok = x.reshape(-1, d)
    if strategy == "a2a":
        y_tok, aux = _moe_a2a_local(params, cfg, x_tok, group, n_shards,
                                    a2a_int8)
    elif strategy == "allgather":
        y_tok, aux = _moe_allgather_local(params, cfg, x_tok, mesh, ep_axis)
    else:
        raise ValueError(f"MoE strategy {strategy!r} on a mesh: name "
                         f"'a2a' or 'allgather' (resolve_strategy)")
    axes = tuple(dp_axes) + (ep_axis,)
    aux = _psum(aux, mesh, axes) / n_shards_of(mesh, axes)
    return y_tok.reshape(B, S, d), _ep_exit(aux, n_shards)


def add_dense_branches(params: MoE, cfg: ModelConfig, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """``y`` plus the shared-expert and dense-residual MLPs of ``x``."""
    moe = cfg.moe
    if moe.num_shared_experts:
        y = y + mlp(params.shared, x, "swiglu")
    if moe.dense_residual_d_ff:
        y = y + mlp(params.dense, x, cfg.mlp_activation)
    return y
