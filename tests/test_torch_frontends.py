"""PyTorch port vs the JAX reference: the modality frontends
(``models/frontends.py``) and the prefix path of ``models/lm.py`` — the
``frontend.proj`` leaf, ``forward``, ``loss_fn``, ``prefill`` (and the
decode steps after it), ``dist/steps.make_prefill_step`` and a train step
with ``prefix_emb`` in the batch.

Configs are ``scaled_down`` llava-next-mistral-7b (576 prefix positions
of width 1024) and musicgen-medium (64 of width 128), in f32. Weights
come from ``repro.models.lm.init_params`` through ``carry.lm_params``;
``repro``'s ``synthetic_prefix`` draws from ``jax.random``, which a
``torch.Generator`` cannot reproduce, so the prefix crosses as numpy, as
the tokens do. Tolerances: logits 1e-4; the loss within 1e-5; after
three train steps every parameter within 1e-6, as
``tests/test_torch_train.py`` holds gemma.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import compat
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.dist import steps as jsteps
from repro.models import frontends as jfe
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro_torch import carry
from repro_torch.configs import TrainConfig, get_config, scaled_down
from repro_torch.dist import steps
from repro_torch.models import frontends as tfe
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizer as topt

ARCHS = ("llava-next-mistral-7b", "musicgen-medium")
LOGITS = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 12

_ENVS = {}


def _env(arch):
    """(repro cfg, port cfg, repro params, numpy params, the port's
    model, the prefix as numpy)."""
    if arch not in _ENVS:
        jc = jscaled_down(jget_config(arch), dtype="float32")
        tc = scaled_down(get_config(arch), dtype="float32")
        params = jlm.init_params(jax.random.PRNGKey(0), jc)
        np_params = jax.tree_util.tree_map(np.asarray, params)
        pre = np.array(jfe.synthetic_prefix(jc, B))
        _ENVS[arch] = (jc, tc, params, np_params, pre)
    jc, tc, params, np_params, pre = _ENVS[arch]
    return jc, tc, params, np_params, carry.lm_params(np_params, tc,
                                                      device="cpu"), pre


def _tokens(vocab, seed=0, S=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or LOGITS))


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_dim_and_synthetic_prefix(arch):
    jc, tc = jget_config(arch), get_config(arch)
    assert tfe.frontend_dim(tc) == jfe.frontend_dim(jc) > 0
    gen = lambda: torch.Generator().manual_seed(3)
    a = tfe.synthetic_prefix(tc, 2, gen(), device="cpu")
    assert a.shape == (2, tc.frontend_positions, tfe.frontend_dim(tc))
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, tfe.synthetic_prefix(tc, 2, gen(), device="cpu"))
    default = tfe.synthetic_prefix(tc, 2, device="cpu")
    assert torch.equal(default, tfe.synthetic_prefix(tc, 2, device="cpu"))
    assert abs(float(default.float().std()) - 1.0) < 0.05
    assert tfe.frontend_dim(get_config("gemma-2b")) == 0
    assert tfe.synthetic_prefix(get_config("gemma-2b"), 2,
                                device="cpu") is None


@pytest.mark.parametrize("arch", ARCHS)
def test_proj_leaf_and_param_count(arch):
    jc, tc, params, np_params, model, _ = _env(arch)
    assert tuple(model.frontend.proj.shape) == params["frontend"]["proj"].shape
    assert np.array_equal(model.frontend.proj.numpy(),
                          np_params["frontend"]["proj"])
    assert tlm.param_count(tc) == jlm.param_count(jc)
    full = get_config(arch)
    drawn = tlm.init_params(torch.Generator().manual_seed(0),
                            scaled_down(full), "cpu")
    assert drawn.frontend.proj.dtype == torch.bfloat16
    assert tlm.param_count(full) == jlm.param_count(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_with_prefix(arch):
    jc, tc, params, _, model, pre = _env(arch)
    tok = _tokens(tc.vocab_size)
    jl, _ = jlm.forward(params, jc, jnp.asarray(tok), jnp.asarray(pre))
    tl, _ = tlm.forward(model, tc, torch.from_numpy(tok),
                        torch.from_numpy(pre))
    assert tl.shape == (B, tc.frontend_positions + S, tc.vocab_size)
    _close(tl, jl)
    batch = {"tokens": tok, "labels": _tokens(tc.vocab_size, seed=1),
             "prefix_emb": pre}
    jloss, jm = jlm.loss_fn(params, jc, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    tloss, tm = tlm.loss_fn(model, tc, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) < 1e-5
    assert abs(float(tm["ce"]) - float(jm["ce"])) < 1e-5
    with pytest.raises(ValueError, match="frontend embeddings"):
        tlm.forward(model, tc, torch.from_numpy(tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_with_prefix(arch):
    """prefill over P + S positions (pos = S + P), then decode steps on
    tokens alone, through the step builders of both packages."""
    jc, tc, params, _, model, pre = _env(arch)
    tok = _tokens(tc.vocab_size, seed=2)
    P = tc.frontend_positions
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jfn, _ = jsteps.make_prefill_step(jc, mesh, S)
    with mesh:
        jl, js = jfn(params, {"tokens": jnp.asarray(tok),
                              "prefix_emb": jnp.asarray(pre)})
    tl, ts = steps.make_prefill_step(tc, S, device="cpu")(
        model, {"tokens": torch.from_numpy(tok),
                "prefix_emb": torch.from_numpy(pre)})
    _close(tl, jl)
    _close(ts["cache"].k, js["cache"].k)
    assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist() == [S + P] * B
    js = jlm.pad_decode_state(jc, js, S + P + 3)
    ts = tlm.pad_decode_state(tc, ts, S + P + 3)
    nxt = tok[:, -1:]
    for _ in range(3):
        jl, js = jlm.decode_step(params, jc, jnp.asarray(nxt), js)
        tl, ts = tlm.decode_step(model, tc, torch.from_numpy(nxt), ts)
        _close(tl, jl)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)


def test_train_step_with_prefix_matches_reference():
    """Three train steps of musicgen with ``prefix_emb`` in the batch: the
    loss, ce and grad norm per step within 1e-5, every parameter (the
    projection included) within 1e-6 after."""
    arch = "musicgen-medium"
    jc, tc, params, np_params, model, pre = _env(arch)
    kw = dict(total_steps=6, warmup_steps=1)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jsteps.make_train_step(jc, mesh, JTrainConfig(**kw),
                                         donate=False)
    ttc = TrainConfig(**kw)
    jp, jst = params, jopt.init(params, JTrainConfig(**kw))
    ts = topt.init(dict(model.named_parameters()), ttc)
    tstep = steps.make_train_step(tc, ttc, device="cpu")
    for s in range(3):
        b = {"tokens": _tokens(tc.vocab_size, seed=10 + s),
             "labels": _tokens(tc.vocab_size, seed=20 + s),
             "prefix_emb": pre}
        with mesh:
            jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                          for k, v in b.items()},
                                jnp.asarray(s))
        model, ts, tm = tstep(model, ts, b, s)
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) < 1e-5, (s, k)
    ref = carry._flat_lm_tree(jax.tree_util.tree_map(np.asarray, jp),
                              tc.num_layers)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert not np.allclose(ref["frontend.proj"],
                           np_params["frontend"]["proj"])
