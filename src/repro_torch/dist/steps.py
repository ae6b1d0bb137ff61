"""Step builders: the one place the train, prefill and serve computations
are assembled (port of ``repro.dist.steps``).

The port's arrays are not sharded, so each builder returns its step
function alone (the specs live in ``dist/sharding.py``); on a mesh the
train step runs on every rank with that rank's share (``make_train_step``).
The prefill and serve steps run under ``torch.inference_mode``; the train
step runs autograd over the blockwise attention path. The serve builder
is memoized per (cfg, max_len, retrieval variant), as ``repro``'s is (the
degraded probe variant keys on the identity of its probe positions, as
there): the server asks for its rungs' steps again mid-serve, and
failover must find the step it already has. The per-unit
search steps of dist/search.py are memoized per (bins, k) as there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import retrieval as retrieval_mod
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.optim import optimizer


def dp_axes(mesh) -> Tuple[str, ...]:
    """Every mesh axis except the tensor/expert axis is data parallel."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def expert_parallel(cfg: ModelConfig, mesh, pure_dp: bool = False) -> bool:
    """Whether a train step on ``mesh`` splits the experts over its
    ``"model"`` axis (an MoE config, not ``pure_dp``, that axis > 1)."""
    return (mesh is not None and cfg.moe is not None and not pure_dp
            and moe_mod.ep_size(mesh, "model") > 1)


def batch_axes(cfg: ModelConfig, mesh, pure_dp: bool = False
               ) -> Tuple[str, ...]:
    """The mesh axes over which a train step's ranks hold different slices
    of the batch: the data axes under expert parallelism (the ranks of
    the expert axis hold the same slice), else every axis."""
    if expert_parallel(cfg, mesh, pure_dp):
        return dp_axes(mesh)
    return tuple(mesh.mesh_dim_names)


def shard_batch(batch: dict, cfg: ModelConfig, tc: TrainConfig, mesh,
                pure_dp: bool = False) -> dict:
    """This rank's slice of the global batch (numpy arrays or tensors,
    the batch on the leading axis) for ``make_train_step(..., mesh=)``:
    of each of the ``tc.microbatches`` microbatches of the global batch,
    the rows of this rank's flat index over ``batch_axes``, so a
    microbatch holds on each rank the rows ``repro``'s sharded step gives
    that device."""
    axes = batch_axes(cfg, mesh, pure_dp)
    n, f = ops.n_shards_of(mesh, axes), ops.flat_index(mesh, axes)
    micro = max(int(tc.microbatches), 1)

    def one(v):
        per = v.shape[0] // (micro * n)
        if per * micro * n != v.shape[0]:
            raise ValueError(f"a batch of {v.shape[0]} does not split into "
                             f"{micro} microbatches over {n} ranks")
        v = v.reshape((micro, n, per) + tuple(v.shape[1:]))[:, f]
        return v.reshape((micro * per,) + tuple(v.shape[2:]))

    return {k: one(v) for k, v in batch.items()}


def _mean_over(tensors, mesh, axes, n: int) -> None:
    """Each tensor replaced in place by its mean over the ranks of
    ``axes``: one ``all_reduce`` per dtype over a flat copy."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        for a in axes:
            dist.all_reduce(flat, group=mesh.get_group(a))
        flat.div_(n)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_grad_fn(cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                 causal_skip: bool = False, attn_p_bf16: bool = False,
                 pure_dp: bool = False, moe_a2a_int8: bool = False,
                 device=None):
    """The train step's first half (``make_train_step``'s arguments):
    ``grad_fn(model, batch) -> (grads, metrics {loss, ce, aux})``, the
    gradients the parameters' ``.grad`` (averaged over the microbatches
    and over ``batch_axes``), the metrics global."""
    dev = device_mod.resolve(device)
    ep = expert_parallel(cfg, mesh, pure_dp)
    ctx = lm.RunCtx(mesh=mesh if ep else None,
                    aux_mesh=None if ep else mesh,
                    dp_axes=dp_axes(mesh) if mesh is not None else ("data",),
                    causal_skip=causal_skip, attn_p_bf16=attn_p_bf16,
                    moe_a2a_int8=moe_a2a_int8, remat=tc.remat)
    micro = max(int(tc.microbatches), 1)
    axes = batch_axes(cfg, mesh, pure_dp) if mesh is not None else ()
    n_data = ops.n_shards_of(mesh, axes) if mesh is not None else 1

    def grad_fn(model, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        if mesh is not None and "mask" in batch:
            raise ValueError("a loss mask on a mesh is not supported: each "
                             "rank would average over its own mask")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mbs = ([{k: v.reshape((micro, v.shape[0] // micro) + v.shape[1:])[i]
                 for k, v in batch.items()} for i in range(micro)]
               if micro > 1 else [batch])
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        asum = {"ce": lsum.clone(), "aux": lsum.clone()}
        for b in mbs:
            lval, aux = lm.loss_fn(model, cfg, b, ctx)
            lval.backward()
            lsum += lval.detach()
            for k in asum:
                asum[k] += aux[k].detach()
        grads = {n: p.grad.div_(micro) if micro > 1 else p.grad
                 for n, p in params.items()}
        if n_data > 1:
            _mean_over([grads[k] for k in sorted(grads)], mesh, axes, n_data)
            both = torch.stack([lsum, asum["ce"]])
            _mean_over([both], mesh, axes, n_data)
            lsum, asum["ce"] = both.unbind()
        metrics = {k: a / micro for k, a in asum.items()}
        metrics["loss"] = lsum / micro
        return grads, metrics

    return grad_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                    causal_skip: bool = False, attn_p_bf16: bool = False,
                    pure_dp: bool = False, moe_a2a_int8: bool = False,
                    device=None):
    """Returns ``step_fn(model, opt_state, batch, step) -> (model,
    opt_state, metrics)`` with metrics at least {loss, ce, aux, grad_norm,
    lr}; the batch's tensors are moved to ``device`` — CUDA unless
    ``device="cpu"``. Every registered family trains.

    The step turns ``requires_grad`` on for the model it trains and
    updates its parameters and ``opt_state``'s moments in place (the
    reference's donated buffers). ``tc.microbatches > 1`` splits the batch
    and accumulates the gradients in the param dtype, then divides them
    by M; loss and aux are averaged in f32. Attention takes the blockwise
    path (``attn_impl="xla"``): K4 is forward-only.

    With ``mesh`` (a ``DeviceMesh``; ``"model"`` is the expert axis, the
    others are data axes) every rank calls the step with its own slice of
    the global batch (``shard_batch``) and, for an MoE config, its own
    experts (``carry.expert_shard``) — unless ``pure_dp``, where every
    rank holds the whole model, runs ``moe_reference`` (``repro``'s
    ``RunCtx(mesh=None)``) and its slice of the batch over every axis.
    After the backward pass the gradients are averaged over the ranks
    that hold different data (``batch_axes``: under expert parallelism
    the data axes, where the expert leaves differ by rank and the other
    leaves agree over the expert axis); the update then counts the expert
    leaves over the expert axis (``optimizer.update(mesh=)``).
    ``moe_a2a_int8`` quantizes the all-to-all dispatch. The expert
    parallel strategy is ``repro``'s "auto": a2a when the global sequence
    length splits over the expert axis, else allgather. The metrics are
    the global ones, the same on every rank."""
    ep = expert_parallel(cfg, mesh, pure_dp)
    grad_fn = make_grad_fn(cfg, tc, mesh=mesh, causal_skip=causal_skip,
                           attn_p_bf16=attn_p_bf16, pure_dp=pure_dp,
                           moe_a2a_int8=moe_a2a_int8, device=device)

    def step(model, opt_state, batch, step_idx):
        params = dict(model.named_parameters())
        grads, metrics = grad_fn(model, batch)
        _, new_opt, om = optimizer.update(grads, opt_state, params, tc,
                                          step_idx,
                                          mesh=mesh if ep else None)
        for p in params.values():
            p.grad = None
        metrics.update(om)
        return model, new_opt, metrics

    return step

# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, seq_len: int, *,
                      causal_skip: bool = False, attn_p_bf16: bool = False,
                      attn_chunk: int = 1024, attn_impl: str = "xla",
                      device=None):
    """Returns ``prefill_fn(model, batch) -> (logits, decode_state)`` over
    the full prompt, with ``batch["tokens"]`` (B, S) (and a frontend
    config's ``batch["prefix_emb"]``) moved to ``device`` — CUDA unless
    ``device="cpu"``. ``seq_len`` is ``repro``'s argument; as
    there, the prompts' own length is what runs."""
    dev = device_mod.resolve(device)
    ctx = lm.RunCtx(causal_skip=causal_skip, attn_p_bf16=attn_p_bf16,
                    attn_chunk=attn_chunk, attn_impl=attn_impl)

    @torch.inference_mode()
    def prefill_fn(model, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        return lm.prefill(model, cfg, tokens, batch.get("prefix_emb"), ctx)

    return prefill_fn


# ---------------------------------------------------------------------------
# per-unit search steps (host-orchestrated fault-tolerant search)
# ---------------------------------------------------------------------------

# (bins, k) -> (hist_fn, topk_fn). dist/search.py calls one hist and one
# top-k per SURVIVING unit per query; units die and fail over mid-stream,
# so the callables are shared across units and never rebuilt on the
# failover path.
_UNIT_STEP_CACHE: dict = {}


def unit_search_steps(bins: int, k: int):
    """Memoized per-unit callables for dist/search.py: ``hist(q, x) ->
    (Q, bins)`` partial histogram (one K1 launch on CUDA tensors) and
    ``topk(q, x) -> (dists, ids)`` local top-k (one K1 and one K2) over
    ONE unit's row range, on the tensors' device."""
    key = (int(bins), int(k))
    hit = _UNIT_STEP_CACHE.get(key)
    if hit is not None:
        return hit

    @torch.inference_mode()
    def hist(q, x):
        return ops.hamming_hist(q, x, key[0])

    @torch.inference_mode()
    def topk(q, x):
        return ops.hamming_topk(q, x, key[1], key[0])

    _UNIT_STEP_CACHE[key] = (hist, topk)
    return hist, topk


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

# (cfg, max_len, with_retrieval, nprobe, id(probe_positions), select,
#  recall_target) -> serve_fn
_SERVE_CACHE: dict = {}


def make_serve_step(cfg: ModelConfig, max_len: int, *,
                    with_retrieval: Optional[bool] = None, nprobe: int = 0,
                    probe_positions=None, select: Optional[str] = None,
                    recall_target: Optional[float] = None):
    """Returns ``serve_fn(model, token (B,1), state, active (B,)[, store])
    -> (logits (B,1,V) f32, new_state)`` — one decode step for every active
    slot; the store argument exists iff retrieval is on. ``nprobe > 0``
    (with the store's hamming-prefix ``probe_positions``) builds the
    DEGRADED variant: a masked probe of the ``nprobe`` nearest buckets
    instead of the full exact plan; ``select="approx"`` + ``recall_target``
    builds the APPROX rung, the partial-reduce tier at a bounded recall
    loss."""
    if with_retrieval is None:
        with_retrieval = cfg.retrieval.enabled
    key = (cfg, int(max_len), bool(with_retrieval), int(nprobe),
           id(probe_positions) if probe_positions is not None else None,
           select,
           float(recall_target) if recall_target is not None else None)
    if key in _SERVE_CACHE:
        return _SERVE_CACHE[key]

    rcfg = cfg.retrieval
    if with_retrieval:
        @torch.inference_mode()
        def serve_fn(model, token, state, active, store):
            logits, new_state, hidden = lm.decode_step(
                model, cfg, token, state, active=active, return_hidden=True)
            knn = retrieval_mod.knn_logits(
                store, hidden[:, 0, :], rcfg, cfg.vocab_size, select=select,
                recall_target=recall_target, nprobe=nprobe,
                probe_positions=probe_positions)
            mixed = retrieval_mod.interpolate(logits[:, 0, :], knn,
                                              rcfg.interpolation)
            return mixed[:, None, :], new_state
    else:
        @torch.inference_mode()
        def serve_fn(model, token, state, active):
            logits, new_state = lm.decode_step(model, cfg, token, state,
                                               active=active)
            return logits.float(), new_state

    _SERVE_CACHE[key] = serve_fn
    return serve_fn
