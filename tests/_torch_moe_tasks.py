"""Rank-side tasks of the port's expert-parallel MoE tests: every rank of a
``_torch_world.World`` builds the MoE layer from numpy weights, keeps its
own experts (``carry.expert_shard``) and its own slice of the tokens, and
returns numpy arrays. Only ``torch``, ``numpy`` and ``repro_torch`` are
imported.
"""
from __future__ import annotations

import numpy as np
import torch

from _torch_world import mesh
from repro_torch import carry
from repro_torch.models import moe


def layer(cfg, weights: dict) -> moe.MoE:
    """The whole MoE layer of ``cfg`` on the CPU from ``{leaf: array}``
    (``repro``'s ``moe_init`` tree, flattened with dots)."""
    m = moe.MoE(cfg, getattr(torch, cfg.dtype), "cpu")
    for name, p in m.named_parameters():
        p.copy_(carry.tensor(weights[name], "cpu"))
    return m


def token_slice(x, coords, sizes, strategy: str):
    """This rank's slice of the global (B, S, d) tokens: the batch split
    over the data axis, the sequence over the expert axis for ``a2a``."""
    (di, ei), (dn, en) = coords, sizes
    b = x.shape[0] // dn
    x = x[di * b:(di + 1) * b]
    if strategy == "a2a":
        s = x.shape[1] // en
        x = x[:, ei * s:(ei + 1) * s]
    return x


def ep_forward(shape, names, cfg, weights, x, strategy, a2a_int8):
    """``moe.moe_forward`` on this rank's experts and tokens: (y slice,
    aux, the transport the all-to-all took)."""
    m = mesh(shape, names)
    coords = tuple(int(m.get_local_rank(a)) for a in names)
    full = layer(cfg, weights)
    part = carry.expert_shard(full, cfg, coords[1], shape[1])
    xs = torch.from_numpy(token_slice(x, coords, shape, strategy))
    y, aux = moe.moe_forward(part, cfg, xs, mesh=m, dp_axes=(names[0],),
                             ep_axis=names[1], strategy=strategy,
                             a2a_int8=a2a_int8)
    transport = moe.a2a_transport(xs, m.get_group(names[1]))
    return y.numpy(), float(aux), coords, transport


def all_to_all_both(shape, names, n_rows):
    """``moe._all_to_all`` of a rank-dependent (n, n_rows, 3) f32 and
    int8 payload by each transport."""
    m = mesh(shape, names)
    g = m.get_group(names[1])
    n = shape[1]
    me = int(m.get_local_rank(names[1])) + 10 * int(
        m.get_local_rank(names[0]))
    out = []
    for dt in (torch.float32, torch.int8):
        x = (torch.arange(n * n_rows * 3).reshape(n, n_rows, 3) % 50
             + me).to(dt)
        out += [moe._all_to_all(x, g, t).numpy()
                for t in ("all_to_all_single", "all_reduce")]
    return tuple(out)


def ep_lm_forward(shape, names, cfg, tree, tokens, strategy):
    """``lm.forward`` of a model whose MoE blocks hold this rank's experts,
    with ``RunCtx.mesh`` set, on this rank's batch slice: (logits, aux)."""
    from repro_torch.models import lm

    m = mesh(shape, names)
    coords = tuple(int(m.get_local_rank(a)) for a in names)
    model = carry.lm_params(tree, cfg, device="cpu")
    for blk in model.blocks:
        blk.moe = carry.expert_shard(blk.moe, cfg, coords[1], shape[1])
    tok = torch.from_numpy(token_slice(tokens, coords, shape, "allgather"))
    ctx = lm.RunCtx(mesh=m, dp_axes=(names[0],), ep_axis=names[1],
                    moe_strategy=strategy)
    logits, aux = lm.forward(model, cfg, tok, ctx=ctx)
    return logits.numpy(), float(aux), coords


def rank_in_group(group, num_groups):
    """``moe._rank_in_group`` on numpy input."""
    return moe._rank_in_group(torch.from_numpy(np.asarray(group)),
                              num_groups).numpy()
