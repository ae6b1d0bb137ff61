"""Step builders: the one place the train, prefill and serve computations
are assembled (port of the single-device half of ``repro.dist.steps``).

Without a mesh there are no partition specs to return, so each builder
returns its step function alone (the specs live in ``dist/sharding.py``).
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

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import retrieval as retrieval_mod
from repro_torch.models import lm
from repro_torch.optim import optimizer


def dp_axes(mesh) -> Tuple[str, ...]:
    """Every mesh axis except the tensor/expert axis is data parallel."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    causal_skip: bool = False, attn_p_bf16: bool = False,
                    device=None):
    """Returns ``step_fn(model, opt_state, batch, step) -> (model,
    opt_state, metrics)`` with metrics at least {loss, ce, aux, grad_norm,
    lr}; the batch's tokens and labels are moved to ``device`` — CUDA
    unless ``device="cpu"``.

    The step turns ``requires_grad`` on for the model it trains and
    updates its parameters and ``opt_state``'s moments in place (the
    reference's donated buffers). ``tc.microbatches > 1`` splits the batch
    and accumulates the gradients in the param dtype, then divides them
    by M; loss and aux are averaged in f32. Attention takes the blockwise
    path (``attn_impl="xla"``): K4 is forward-only."""
    dev = device_mod.resolve(device)
    ctx = lm.RunCtx(causal_skip=causal_skip, attn_p_bf16=attn_p_bf16,
                    remat=tc.remat)
    micro = max(int(tc.microbatches), 1)

    def step(model, opt_state, batch, step_idx):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
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
        _, new_opt, om = optimizer.update(grads, opt_state, params, tc,
                                          step_idx)
        for p in params.values():
            p.grad = None
        metrics = {k: a / micro for k, a in asum.items()}
        metrics.update(om)
        metrics["loss"] = lsum / micro
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
    the full prompt, with ``batch["tokens"]`` (B, S) moved to ``device`` —
    CUDA unless ``device="cpu"``. ``seq_len`` is ``repro``'s argument; as
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
    from repro_torch.kernels import ops

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
