"""AdamW with warmup+cosine schedule, global-norm clipping, and optional
int8 gradient compression with error feedback (port of
``repro.optim.optimizer``).

Trees are dicts of tensors keyed by the model's ``named_parameters()``
names. The algorithm is the reference's: int8_ef compression first, then
clipping, then the bias-corrected AdamW with decoupled weight decay on
matrices, the update computed in f32 and cast back to the param dtype;
moments in f32, or blockwise int8 with nu kept in sqrt space.

The reference stacks the blocks' parameters on a layer axis, so the
port's ``blocks.<i>.<rest>`` of every layer lies in the one reference
leaf ``blocks.*.<rest>``, and the hybrid's ``blocks.<g>.<i>.<rest>`` in
the leaf ``blocks.*.*.<rest>`` stacked on (groups, per_group)
(``_leaf``; its one ``shared_attn`` is not stacked): that leaf's rank
decides weight decay, and its layers share one int8_ef scale. An MoE
layer's experts ``blocks.<i>.moe.w_gate|w_up|w_out`` lie in the (L, E,
...) leaf. The blockwise int8 moments run along the last dim, which
stacking leaves alone, so their scales are per layer as they are.

With expert parallelism (``update(..., mesh=)``) each rank holds E/n of
every expert leaf and the whole of the others, as ``carry.expert_shard``
splits them: the global grad norm adds the expert leaves' squares over
the expert axis and counts the replicated leaves once, and an expert
leaf's int8_ef scale is the max over the whole leaf (an ``all_reduce``
of MAX over the expert axis), which is what ``repro``'s update computes
on its global arrays.

Where the reference returns new trees, ``update`` writes the parameters
and the moments IN PLACE, one tensor at a time under ``torch.no_grad()``
(at full width a second copy of the model would not fit beside the
moments), and returns the same dicts. ``_q8``'s scale is the block max
times the f32 reciprocal of 127: the reference's ``/ 127.0`` under jit is
that product on XLA-CPU, so the int8 codes and scales are the same bits.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig

# the f32 reciprocal XLA multiplies by where the reference divides by 127
_INV127 = 1.0 / 127.0
_BLOCK = re.compile(r"^blocks\.\d+\.(\d+\.)?")
_EXPERT = re.compile(r"^blocks\.\d+\.moe\.(w_gate|w_up|w_out)$")


class AdamState(NamedTuple):
    mu: dict          # first moments (f32 — or int8 q with opt_int8)
    nu: dict          # second moments
    count: torch.Tensor  # step counter (int32, 0-d)
    ef: Optional[dict] = None   # error-feedback residual (grad compression)
    mu_scale: Optional[dict] = None   # blockwise f32 scales (opt_int8)
    nu_scale: Optional[dict] = None


def map_moments(state: AdamState, fn) -> AdamState:
    """``state`` with ``fn`` applied to each of its per-parameter dicts."""
    part = lambda t: None if t is None else fn(t)
    return state._replace(mu=part(state.mu), nu=part(state.nu),
                          ef=part(state.ef), mu_scale=part(state.mu_scale),
                          nu_scale=part(state.nu_scale))


def _blocks(shape):
    """Blockwise-quantization layout: blocks of 128 along the last dim when
    divisible, else one block per row. Returns (n_blocks, block)."""
    if not shape:
        return 1, 1
    last = shape[-1]
    block = 128 if last % 128 == 0 else last
    return last // block, block


def _q8(x: torch.Tensor):
    """Symmetric BLOCKWISE int8 quantization -> (q, scale)."""
    shape = tuple(x.shape)
    nb, block = _blocks(shape)
    xr = x.reshape(shape[:-1] + (nb, block)) if shape else x.reshape(1, 1)
    scale = torch.clamp(xr.abs().amax(-1, keepdim=True), min=1e-20) * _INV127
    q = torch.clamp(torch.round(xr / scale), -127, 127).to(torch.int8)
    return q.reshape(shape), scale.squeeze(-1)


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    shape = tuple(q.shape)
    nb, block = _blocks(shape)
    qr = q.reshape(shape[:-1] + (nb, block)) if shape else q.reshape(1, 1)
    return (qr.float() * scale[..., None]).reshape(shape)


def schedule(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% (a 0-d f32 tensor)."""
    step = torch.as_tensor(step).float()
    warm = step / max(tc.warmup_steps, 1)
    progress = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1),
                           0.0, 1.0)
    cosine = 0.1 + 0.45 * (1 + torch.cos(torch.pi * progress))
    return tc.learning_rate * torch.where(step < tc.warmup_steps, warm,
                                          cosine)


def init(params: Dict[str, torch.Tensor], tc: TrainConfig) -> AdamState:
    """Zero moments on each parameter's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = next(iter(params.values())).device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if tc.opt_int8:
        zq = lambda p: torch.zeros(p.shape, dtype=torch.int8, device=p.device)

        def zs(p):
            nb, _ = _blocks(tuple(p.shape))
            shape = tuple(p.shape[:-1]) + (nb,) if p.dim() else (1, 1)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdamState(
            mu={k: zq(p) for k, p in params.items()},
            nu={k: zq(p) for k, p in params.items()},
            count=count, ef=None,
            mu_scale={k: zs(p) for k, p in params.items()},
            nu_scale={k: zs(p) for k, p in params.items()})
    return AdamState(
        mu={k: zeros(p) for k, p in params.items()},
        nu={k: zeros(p) for k, p in params.items()},
        count=count,
        ef=({k: zeros(p) for k, p in params.items()}
            if tc.grad_compression == "int8_ef" else None))


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaves in the
    reference's order: sorted keys)."""
    leaves = [torch.sum(torch.square(tree[k].float())) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: ``float / tensor`` would multiply by a reciprocal
    num = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to at most ``max_norm`` in f32, their norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, norm


def _leaf(name: str) -> str:
    """The reference leaf that parameter ``name`` lies in."""
    m = _BLOCK.match(name)
    if m is None:
        return name
    return ("blocks.*.*." if m.group(1) else "blocks.*.") + name[m.end():]


def is_expert(name: str) -> bool:
    """Whether ``name`` is an expert tensor (split over the expert axis
    under expert parallelism)."""
    return _EXPERT.match(name) is not None


def _ep_group(mesh, ep_axis: str):
    """The expert axis's process group, or None without a split."""
    if mesh is None or ep_axis not in mesh.mesh_dim_names:
        return None
    if mesh.size(list(mesh.mesh_dim_names).index(ep_axis)) == 1:
        return None
    return mesh.get_group(ep_axis)


def decayed(params: Dict[str, torch.Tensor]) -> set:
    """The names weight decay applies to: those whose reference leaf has
    two or more dims — every block parameter (stacked on the layer axis,
    the norm scales too) and the other matrices."""
    return {k for k, p in params.items() if _leaf(k) != k or p.dim() >= 2}


def _ef_amax(gs: List[torch.Tensor], efs: List[torch.Tensor]):
    """The max of ``|g + ef|`` over tensors that form one leaf."""
    return torch.stack([(g.float() + ef).abs().amax()
                        for g, ef in zip(gs, efs)]).amax()


def _ef_scale(gs: List[torch.Tensor], efs: List[torch.Tensor]):
    """The int8_ef scale shared by tensors that form one leaf: the max of
    ``|g + ef|`` over all of them, over 127."""
    return torch.clamp(_ef_amax(gs, efs), min=1e-12) * _INV127


def _compress_codes(g: torch.Tensor, ef: torch.Tensor, scale: torch.Tensor):
    """(int8 codes, residual) of ``g + ef`` at ``scale``."""
    gf = g.float() + ef
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, gf - q.float() * scale


def compress_int8(g: torch.Tensor, ef: torch.Tensor):
    """Symmetric int8 quantization with error feedback: (dequantized f32
    gradient, residual that re-enters next step)."""
    scale = _ef_scale([g], [ef])
    q, res = _compress_codes(g, ef, scale)
    return q.float() * scale, res


def _adamw(p, gf, m, v, *, lr, bc1, bc2, tc: TrainConfig, decay: bool):
    """One AdamW step of one tensor: ``m`` and ``v`` (f32) in place, ``p``
    in place in its own dtype."""
    b1, b2 = tc.b1, tc.b2
    m.mul_(b1).add_(gf * (1 - b1))
    v.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
    delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(1e-8))
    if decay:                       # decoupled weight decay on matrices
        delta.add_(p.float() * tc.weight_decay)
    p.copy_(p.float() - delta.mul_(lr))


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: AdamState,
           params: Dict[str, torch.Tensor], tc: TrainConfig, step,
           mesh=None, ep_axis: str = "model"):
    """One AdamW step. Returns (params, new_state, metrics {grad_norm,
    lr}); ``params`` and the state's moment dicts are updated in place.
    ``mesh``: the experts are split over its ``ep_axis`` (module
    docstring); the other leaves, and every gradient, are the same on
    every rank of that axis."""
    names = sorted(params)
    decay = decayed(params)
    group = _ep_group(mesh, ep_axis)
    split = {k for k in names if group is not None and is_expert(k)}
    if tc.grad_compression == "int8_ef" and state.ef is not None:
        # the codes stand in for the dequantized gradients (a quarter of
        # their bytes) until the norm over all of them is known
        leaves: Dict[str, list] = {}
        for k in names:
            leaves.setdefault(_leaf(k), []).append(k)
        amax = {leaf: _ef_amax([grads[k] for k in ks],
                               [state.ef[k] for k in ks])
                for leaf, ks in leaves.items()}
        over = sorted(leaf for leaf, ks in leaves.items() if ks[0] in split)
        if over:              # one MAX over the expert axis for all of them
            both = torch.stack([amax[leaf] for leaf in over])
            dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
            amax.update(zip(over, both.unbind()))
        codes = {}
        for leaf, ks in leaves.items():
            scale = torch.clamp(amax[leaf], min=1e-12) * _INV127
            for k in ks:
                q, res = _compress_codes(grads[k], state.ef[k], scale)
                state.ef[k].copy_(res)
                codes[k] = (q, scale)
        grad_f32 = lambda k: codes[k][0].float() * codes[k][1]
    else:
        grad_f32 = lambda k: grads[k].float()
    sq = {k: torch.sum(torch.square(grad_f32(k))) for k in names}
    if split:
        own = torch.stack([sq[k] for k in names if k in split]).sum()
        dist.all_reduce(own, group=group)
        rest = [sq[k] for k in names if k not in split]
        gnorm = torch.sqrt(torch.stack(rest).sum() + own)
    else:
        gnorm = torch.sqrt(torch.sum(torch.stack([sq[k] for k in names])))
    clip = _clip_scale(gnorm, tc.grad_clip)
    count = state.count + 1
    lr = schedule(tc, step).to(count.device)
    cf = count.float()
    bc1 = 1 - tc.b1 ** cf
    bc2 = 1 - tc.b2 ** cf
    kw = dict(lr=lr, bc1=bc1, bc2=bc2, tc=tc)
    for k in names:
        p = params[k]
        gf = grad_f32(k) * clip
        if tc.opt_int8:
            m = _dq8(state.mu[k], state.mu_scale[k])
            v = torch.square(_dq8(state.nu[k], state.nu_scale[k]))
            _adamw(p, gf, m, v, decay=k in decay, **kw)
            for q_t, s_t, x in ((state.mu, state.mu_scale, m),
                                (state.nu, state.nu_scale, torch.sqrt(v))):
                q, s = _q8(x)
                q_t[k].copy_(q)
                s_t[k].copy_(s)
        else:
            _adamw(p, gf, state.mu[k], state.nu[k], decay=k in decay, **kw)
    return params, state._replace(count=count), {"grad_norm": gnorm,
                                                 "lr": lr}
