"""Shared checks of the recurrent families' LM (zamba2-2.7b's Mamba2
hybrid and rwkv6-1.6b's RWKV6 stack) against ``repro``, used by
``test_torch_mamba2.py`` and ``test_torch_rwkv6.py``.

Weights come from ``repro.models.lm.init_params`` on the ``scaled_down``
config in float32 and cross through ``carry.lm_params``; inputs from a
numpy seed. ``repro`` runs jitted, as its own tests run it. Tolerances:
max |diff| <= 1e-5 through one block, <= 1e-4 on logits through the
stack (only the order of f32 sums differs), greedy tokens identical."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.models import lm as jlm
from repro_torch import carry
from repro_torch.configs import get_config, scaled_down
from repro_torch.models import lm as tlm

BLOCK_ATOL = 1e-5
LOGITS_ATOL = 1e-4


class Env:
    """One arch at its scaled f32 config: both configs, ``repro``'s params
    (jax and numpy), the carried model and jitted ``repro`` entry points."""

    def __init__(self, arch: str):
        self.arch = arch
        self.jc = jscaled_down(jget_config(arch), dtype="float32")
        self.tc = scaled_down(get_config(arch), dtype="float32")
        self.params = jlm.init_params(jax.random.PRNGKey(0), self.jc)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.params)
        self.model = carry.lm_params(self.np_params, self.tc, device="cpu")
        jc = self.jc
        self.forward = jax.jit(lambda p, t: jlm.forward(
            p, jc, t, return_hidden=True))
        self.prefill = jax.jit(lambda p, t: jlm.prefill(p, jc, t))
        self.decode = jax.jit(lambda p, t, s, a: jlm.decode_step(
            p, jc, t, s, active=a))
        self.decode_all = jax.jit(lambda p, t, s: jlm.decode_step(p, jc, t, s))

    def tokens(self, B, S, seed=0):
        return np.random.default_rng(seed).integers(
            0, self.jc.vocab_size, (B, S)).astype(np.int32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_leaves(tree):
    """The port's decode state (dicts and NamedTuples) in JAX's leaf order:
    dict keys sorted, NamedTuple fields in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in t_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in t_leaves(v)]
    return [tree]


def assert_close(t, j, atol):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j, np.float32), atol=atol,
                               rtol=0)


def assert_close_scaled(t, j, atol=BLOCK_ATOL):
    """``atol`` times the reference's largest magnitude (at least 1): the
    chunked scans' raw outputs reach |4|, where f32 rounds at 4.8e-7 and
    the two frameworks' cumulative sums of the log-decay (~1e2 over a
    chunk) differ by ~1e-5 (at S=64 in ``test_ssd_chunked``, ``repro``
    itself lies 9e-6 from a float64 evaluation, the port 4e-6)."""
    scale = max(1.0, float(np.abs(np.asarray(j)).max()))
    assert_close(t, j, atol * scale)


def assert_state_close(t_state, j_state, atol=BLOCK_ATOL):
    tl, jl = t_leaves(t_state), jax.tree_util.tree_leaves(j_state)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        assert_close(a, b, atol)


def check_param_count(arch: str, expected: int):
    """The full config's count, from a meta-device build and from
    ``jax.eval_shape``: nothing allocated."""
    assert tlm.param_count(get_config(arch)) == jlm.param_count(
        jget_config(arch)) == expected
    t = scaled_down(get_config(arch))
    assert tlm.param_count(t) == jlm.param_count(jscaled_down(
        jget_config(arch)))
    full = dataclasses.asdict(get_config(arch))
    assert full == dataclasses.asdict(jget_config(arch))


def check_forward(env: Env, S: int):
    tok = env.tokens(2, S, seed=S)
    jl, _, jh = env.forward(env.params, jnp.asarray(tok))
    with torch.no_grad():
        tl, aux, th = tlm.forward(env.model, env.tc, torch.from_numpy(tok),
                                  return_hidden=True)
    assert float(aux) == 0.0
    assert_close(th, jh, LOGITS_ATOL)
    assert_close(tl, jl, LOGITS_ATOL)


def check_prefill_then_decode(env: Env, S=21, steps=4, max_len=40):
    """prefill -> pad_decode_state -> greedy decode of ``steps`` tokens:
    the logits, every state leaf and the greedy tokens."""
    tok = env.tokens(2, S, seed=3)
    jl, js = env.prefill(env.params, jnp.asarray(tok))
    with torch.no_grad():
        tl, ts = tlm.prefill(env.model, env.tc, torch.from_numpy(tok))
    assert_close(tl, jl, LOGITS_ATOL)
    assert_state_close(ts, js, LOGITS_ATOL)
    js = jlm.pad_decode_state(env.jc, js, max_len)
    ts = tlm.pad_decode_state(env.tc, ts, max_len)
    assert [tuple(a.shape) for a in t_leaves(ts)] == [
        np.shape(b) for b in jax.tree_util.tree_leaves(js)]
    nxt_j = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    nxt_t = tl[:, -1].argmax(-1)[:, None]
    for _ in range(steps):
        assert np.array_equal(nxt_t.numpy(), nxt_j)
        jd, js = env.decode_all(env.params, jnp.asarray(nxt_j), js)
        with torch.no_grad():
            td, ts = tlm.decode_step(env.model, env.tc, nxt_t, ts)
        assert_close(td, jd, LOGITS_ATOL)
        nxt_j = np.asarray(jnp.argmax(jd[:, -1], -1))[:, None].astype(
            np.int32)
        nxt_t = td[:, -1].argmax(-1)[:, None]
    assert np.array_equal(nxt_t.numpy(), nxt_j)
    assert_state_close(ts, js, LOGITS_ATOL)


def check_decode_with_active(env: Env):
    """From a zero state: rows with ``active`` False keep every state leaf
    and their ``pos``; active rows advance as ``repro``'s do."""
    B = 3
    js = jlm.init_decode_state(env.jc, B, 16)
    ts = tlm.init_decode_state(env.tc, B, 16, device="cpu")
    assert [tuple(a.shape) for a in t_leaves(ts)] == [
        np.shape(b) for b in jax.tree_util.tree_leaves(js)]
    active = np.array([True, False, True])
    tok = env.tokens(B, 5, seed=9)
    for t in range(tok.shape[1]):
        a = active if t % 2 == 0 else np.array([True, True, False])
        col = tok[:, t:t + 1]
        jd, js = env.decode(env.params, jnp.asarray(col), js, jnp.asarray(a))
        before = _batch_leaves(env.tc, ts)
        with torch.no_grad():
            td, ts = tlm.decode_step(env.model, env.tc, torch.from_numpy(col),
                                     ts, active=torch.from_numpy(a))
        assert_close(td, jd, LOGITS_ATOL)
        for (old, ax), (new, _) in zip(before, _batch_leaves(env.tc, ts)):
            for r in np.where(~a)[0]:
                assert torch.equal(new.select(ax, int(r)),
                                   old.select(ax, int(r)))
    assert_state_close(ts, js, LOGITS_ATOL)
    assert np.array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))


def _batch_leaves(cfg, state):
    """(leaf, batch axis) of every cache leaf: the hybrid's KV caches are
    stacked on groups, its Mamba2 states on (groups, per_group); RWKV
    states on layers."""
    cache = state["cache"]
    if cfg.shared_attn_every:
        return ([(a, 1) for a in cache["kv"]]
                + [(a, 2) for a in cache["mamba"]])
    return [(a, 1) for a in cache]


def check_loss_under_autograd(env: Env):
    """``lm.loss_fn`` with gradients on (blockwise attention, remat on and
    off): the loss equals ``repro``'s, every parameter gets a finite
    gradient, and remat changes no gradient."""
    tok = env.tokens(2, 17, seed=5)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    j_loss, _ = jax.jit(lambda p: jlm.loss_fn(p, env.jc, {
        k: jnp.asarray(v) for k, v in batch.items()}))(env.params)
    grads = []
    for remat in (True, False):
        model = carry.lm_params(env.np_params, env.tc, device="cpu")
        for p in model.parameters():
            p.requires_grad_(True)
        loss, _ = tlm.loss_fn(model, env.tc, {
            k: torch.from_numpy(v) for k, v in batch.items()},
            tlm.RunCtx(remat=remat))
        loss.backward()
        assert_close(loss, j_loss, LOGITS_ATOL)
        g = {n: p.grad for n, p in model.named_parameters()}
        assert all(v is not None and bool(torch.isfinite(v).all())
                   for v in g.values())
        grads.append(g)
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], atol=1e-6,
                                   rtol=1e-5)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(tree._fields),
                [_structure(v) for v in tree])
    return "leaf"


def check_decode_state_specs(env: Env):
    """``dist/sharding.decode_state_specs``: the reference's structure
    (dict keys, NamedTuple names and fields), every leaf replicated."""
    from torch.distributed.tensor import Replicate

    from repro.dist import sharding as jsharding
    from repro_torch.dist import sharding

    specs = sharding.decode_state_specs(env.tc)
    assert _structure(specs) == _structure(
        jsharding.decode_state_specs(env.jc))
    assert all(isinstance(v, Replicate) for v in t_leaves(specs))
