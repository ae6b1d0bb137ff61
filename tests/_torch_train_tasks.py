"""Rank-side tasks of the port's mesh training tests: every rank of a
``_torch_world.World`` builds the model from ``repro``'s numpy weights,
keeps its own experts (``carry.expert_shard``, unless ``pure_dp``), takes
train steps on its slice of each global batch (``steps.shard_batch``)
and returns numpy arrays. Only ``torch``, ``numpy`` and ``repro_torch``
are imported.
"""
from __future__ import annotations

import numpy as np
import torch

from _torch_world import mesh
from repro_torch import carry
from repro_torch.configs import TrainConfig
from repro_torch.dist import steps
from repro_torch.optim import optimizer


def ep_train(shape, names, cfg, tree, tc_kw, batches, pure_dp, int8,
             transport=None):
    """Train steps on a ``shape`` mesh from ``repro``'s weights: (this
    rank's params {name: array}, the metrics of each step, its mesh
    coordinates). ``transport`` forces the all-to-all's transport (the
    card's ``"all_reduce"`` on CPU tensors)."""
    from repro_torch.models import moe

    if transport is not None:
        real = moe.a2a_transport
        moe.a2a_transport = lambda x, group: transport
        try:
            return ep_train(shape, names, cfg, tree, tc_kw, batches,
                            pure_dp, int8)
        finally:
            moe.a2a_transport = real
    m = mesh(shape, names)
    coords = tuple(int(m.get_local_rank(a)) for a in names)
    tc = TrainConfig(**tc_kw)
    model = carry.lm_params(tree, cfg, device="cpu")
    if not pure_dp:
        carry.expert_shard(model, cfg, coords[1], shape[1])
    opt = optimizer.init(dict(model.named_parameters()), tc)
    step = steps.make_train_step(cfg, tc, mesh=m, pure_dp=pure_dp,
                                 moe_a2a_int8=int8, device="cpu")
    metrics = []
    for s, b in enumerate(batches):
        local = steps.shard_batch(b, cfg, tc, m, pure_dp=pure_dp)
        model, opt, met = step(model, opt, local, s)
        metrics.append({k: float(v) for k, v in met.items()})
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    return params, metrics, coords


def ep_grads(shape, names, cfg, tree, batch, pure_dp, int8):
    """The loss gradients of one global batch on a ``shape`` mesh, as the
    train step averages them: (this rank's {name: grad}, the loss, its
    mesh coordinates)."""
    m = mesh(shape, names)
    coords = tuple(int(m.get_local_rank(a)) for a in names)
    tc = TrainConfig()
    model = carry.lm_params(tree, cfg, device="cpu")
    if not pure_dp:
        carry.expert_shard(model, cfg, coords[1], shape[1])
    grad_fn = steps.make_grad_fn(cfg, tc, mesh=m, pure_dp=pure_dp,
                                 moe_a2a_int8=int8, device="cpu")
    grads, met = grad_fn(model, steps.shard_batch(batch, cfg, tc, m,
                                                  pure_dp=pure_dp))
    return ({n: g.numpy().copy() for n, g in grads.items()},
            float(met["loss"]), coords)


def int8_dispatch_grad(shape, names, x_all, ct_all):
    """The int8 dispatch under autograd: this rank's slot of the global
    ``x_all`` (flat over the mesh axes, each an (n, C, d) send buffer)
    through ``moe._a2a_quantized`` over the expert axis, and the gradient
    of ``sum(y * ct)`` with respect to it: (y, grad, flat index)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    m = mesh(shape, names)
    g = m.get_group(names[1])
    f = ops.flat_index(m, names)
    xt = torch.from_numpy(x_all[f].copy()).requires_grad_(True)
    y = moe._a2a_quantized(xt, g, moe.a2a_transport(xt, g), True)
    (y * torch.from_numpy(ct_all[f].copy())).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), f


def mesh_trainer(shape, names, cfg, tc_kw, root, preempt_at=None):
    """``trainer.train`` on a ``shape`` mesh (S = 16, global batch 4):
    (this rank's params and first moments {name: array}, its coords, the
    report's resumed_from, steps_done and final_loss), or ("preempted",
    coords)."""
    from repro_torch.runtime import trainer

    m = mesh(shape, names)
    coords = tuple(int(m.get_local_rank(a)) for a in names)
    try:
        rep = trainer.train(cfg, TrainConfig(**tc_kw), seq_len=16,
                            global_batch=4, device="cpu", mesh=m,
                            ckpt_dir=root, ckpt_every=2, log_every=0,
                            preempt_at=preempt_at)
    except trainer.PreemptionError:
        return "preempted", coords
    params = {n: p.detach().numpy().copy()
              for n, p in rep.model.named_parameters()}
    mu = {n: t.numpy().copy() for n, t in rep.opt_state.mu.items()}
    return ((params, mu), coords, rep.resumed_from, rep.steps_done,
            rep.final_loss)
