"""PyTorch port vs the JAX reference: the training path — ``lm.loss_fn``
and its gradients, ``dist/steps.make_train_step`` (microbatches, remat),
the fault-tolerant trainer (``runtime/trainer.py``) and its launcher.

Both packages start from the same carried f32 weights (``scaled_down``
gemma-2b) and, where a state is carried, the same moments; batches come
from the deterministic pipeline. Tolerances (f32, the reference jitted):
loss within 1e-5 absolute, each gradient within 1e-5 of its leaf's
largest entry; after three train steps at the default learning rate
(3e-4) every parameter within 1e-6 and the per-step loss and grad norm
within 1e-5. The trainer's preempt and
resume is held bit for bit against an uninterrupted run of the port.
"""
import dataclasses
import os
import shutil
import signal

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
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro_torch import carry
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import TrainConfig, get_config, scaled_down
from repro_torch.data import pipeline
from repro_torch.dist import steps
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizer as topt
from repro_torch.runtime import trainer

DC = pipeline.DataConfig(vocab_size=512, seq_len=32, global_batch=4)


@pytest.fixture(scope="module")
def env():
    jc = jscaled_down(jget_config("gemma-2b"), dtype="float32")
    tc = scaled_down(get_config("gemma-2b"), dtype="float32")
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, np_params


def _flat(tree, cfg):
    return carry._flat_lm_tree(jax.tree_util.tree_map(np.asarray, tree),
                               cfg.num_layers)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("with_mask", [False, True])
def test_loss_fn_and_grads_match_reference(env, with_mask):
    jc, tc, params, np_params = env
    batch = pipeline.make_batch(DC, 0)
    if with_mask:
        batch["mask"] = (np.arange(DC.seq_len)[None] % 3 != 0).repeat(
            DC.global_batch, 0).astype(np.int32)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jc, _jbatch(batch)), has_aux=True)(params)
    model = carry.lm_params(np_params, tc, device="cpu")
    model.requires_grad_(True)
    tl, taux = tlm.loss_fn(model, tc, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    assert abs(float(taux["ce"].detach()) - float(jaux["ce"])) < 1e-5
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    ref = _flat(jg, tc)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                   atol=1e-5 * np.abs(ref[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
def test_train_step_matches_reference(env, micro, remat):
    jc, tc, params, np_params = env
    kw = dict(total_steps=6, warmup_steps=1, microbatches=micro, remat=remat)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jsteps.make_train_step(jc, mesh, JTrainConfig(**kw),
                                         donate=False)
    ttc = TrainConfig(**kw)
    jp, js = params, jopt.init(params, JTrainConfig(**kw))
    model = carry.lm_params(np_params, tc, device="cpu")
    ts = topt.init(dict(model.named_parameters()), ttc)
    tstep = steps.make_train_step(tc, ttc, device="cpu")
    for s in range(3):
        b = pipeline.make_batch(DC, s)
        with mesh:
            jp, js, jm = jstep(jp, js, _jbatch(b), jnp.asarray(s))
        model, ts, tm = tstep(model, ts, b, s)
        assert set(tm) >= {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) < 1e-5, (s, k)
    ref = _flat(jp, tc)
    for name, p in model.named_parameters():
        assert p.requires_grad and p.grad is None
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    mu = _flat(js.mu, tc)
    for name in mu:
        np.testing.assert_allclose(ts.mu[name].numpy(), mu[name], rtol=0,
                                   atol=1e-7, err_msg=name)
    assert int(ts.count) == int(js.count) == 3


@pytest.mark.parametrize("micro", [1, 2])
def test_int8_ef_train_step_matches_reference(env, micro):
    """Three steps with int8_ef gradient compression. The port's layers
    of one stacked reference leaf share its scale, so the per-step loss
    and grad norm are held as without compression. Where the two
    gradients differ by f32 summation order at a rounding tie, one int8
    code differs by one step: such entries are at most 1e-4 of all (the
    params and the residuals beyond 1e-6), and no param moves more than
    the learning rate."""
    jc, tc, params, np_params = env
    kw = dict(total_steps=6, warmup_steps=1, microbatches=micro,
              grad_compression="int8_ef")
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jsteps.make_train_step(jc, mesh, JTrainConfig(**kw),
                                         donate=False)
    ttc = TrainConfig(**kw)
    jp, js = params, jopt.init(params, JTrainConfig(**kw))
    model = carry.lm_params(np_params, tc, device="cpu")
    ts = topt.init(dict(model.named_parameters()), ttc)
    tstep = steps.make_train_step(tc, ttc, device="cpu")
    for s in range(3):
        b = pipeline.make_batch(DC, s)
        with mesh:
            jp, js, jm = jstep(jp, js, _jbatch(b), jnp.asarray(s))
        model, ts, tm = tstep(model, ts, b, s)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) < 1e-5, (s, k)
    ref, ef = _flat(jp, tc), _flat(js.ef, tc)
    n = off_p = off_ef = 0
    for name, p in model.named_parameters():
        dp = np.abs(p.detach().numpy() - ref[name])
        assert dp.max() <= ttc.learning_rate, name
        n += dp.size
        off_p += int((dp > 1e-6).sum())
        off_ef += int((np.abs(ts.ef[name].numpy() - ef[name]) > 1e-6).sum())
    assert off_p <= 1e-4 * n and off_ef <= 1e-4 * n, (off_p, off_ef, n)


def test_carried_moments_continue_like_reference(env):
    """The port resumes from the reference's AdamState (carry.adam_state)
    and takes the next step as the reference does."""
    jc, tc, params, np_params = env
    kw = dict(total_steps=6, warmup_steps=0)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jsteps.make_train_step(jc, mesh, JTrainConfig(**kw),
                                         donate=False)
    jp, js = params, jopt.init(params, JTrainConfig(**kw))
    with mesh:
        jp, js, _ = jstep(jp, js, _jbatch(pipeline.make_batch(DC, 0)),
                          jnp.asarray(0))
    model = carry.lm_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                            device="cpu")
    ts = carry.adam_state(jax.tree_util.tree_map(np.asarray, js), model,
                          device="cpu")
    b = pipeline.make_batch(DC, 1)
    with mesh:
        jp, js, jm = jstep(jp, js, _jbatch(b), jnp.asarray(1))
    model, ts, tm = steps.make_train_step(tc, TrainConfig(**kw),
                                          device="cpu")(model, ts, b, 1)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
    ref = _flat(jp, tc)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_remat_checkpoints_each_block_only_with_gradients(env, monkeypatch):
    _, tc, _, np_params = env
    model = carry.lm_params(np_params, tc, device="cpu")
    calls = []
    real = tlm.checkpoint
    monkeypatch.setattr(tlm, "checkpoint",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    tokens = torch.from_numpy(pipeline.make_batch(DC, 0)["tokens"])
    model.requires_grad_(True)
    ctx = tlm.RunCtx(remat=True)
    logits, _ = tlm.forward(model, tc, tokens, ctx=ctx)
    assert len(calls) == tc.num_layers
    assert all(kw == {"use_reentrant": False} for kw in calls)
    with torch.no_grad():
        plain, _ = tlm.forward(model, tc, tokens, ctx=ctx)
    assert len(calls) == tc.num_layers
    torch.testing.assert_close(logits.detach(), plain, rtol=0, atol=0)
    tlm.forward(model, tc, tokens, ctx=tlm.RunCtx(remat=False))
    assert len(calls) == tc.num_layers


def test_decay_follows_the_reference_leaf_ranks(env):
    _, tc, _, np_params = env
    model = carry.lm_params(np_params, tc, device="cpu")
    names = topt.decayed(dict(model.named_parameters()))
    assert "blocks.0.ln1.scale" in names and "blocks.1.attn.wq" in names
    assert "final_norm.scale" not in names and "embed.table" in names


def test_train_step_refuses_the_flash_path_under_autograd(env):
    _, tc, _, np_params = env
    model = carry.lm_params(np_params, tc, device="cpu")
    model.requires_grad_(True)
    tokens = torch.from_numpy(pipeline.make_batch(DC, 0)["tokens"])
    with pytest.raises(RuntimeError, match="forward-only"):
        tlm.forward(model, tc, tokens, ctx=tlm.RunCtx(attn_impl="flash"))
    with torch.no_grad():
        tlm.forward(model, tc, tokens, ctx=tlm.RunCtx(attn_impl="flash"))


def test_param_and_decode_state_specs_are_replicated(env):
    """``repro`` returns ``P()`` over its trees; the port ``Replicate()``
    over its own: the params keyed like ``named_parameters()``, the
    decode state's ``{"pos", "cache": KVCache}``."""
    from torch.distributed.tensor import Replicate

    from repro.dist import sharding as jsharding
    from repro_torch.dist import sharding

    _, tc, _, np_params = env
    model = carry.lm_params(np_params, tc, device="cpu")
    specs = sharding.param_specs(tc)
    assert list(specs) == [n for n, _ in model.named_parameters()]
    assert all(isinstance(v, Replicate) for v in specs.values())
    state = sharding.decode_state_specs(tc)
    ref = jsharding.decode_state_specs(env[0])
    assert set(state) == set(ref) == {"pos", "cache"}
    assert type(state["cache"]).__name__ == type(ref["cache"]).__name__
    assert state == {"pos": Replicate(), "cache": type(state["cache"])(
        k=Replicate(), v=Replicate())}
    assert sharding.replicated_like({"a": [1, None]}) == {
        "a": [Replicate(), None]}


# -- the trainer ------------------------------------------------------------

def _tc(**kw):
    base = dict(total_steps=8, warmup_steps=1, learning_rate=1e-2)
    base.update(kw)
    return TrainConfig(**base)


def _train(tc=None, **kw):
    cfg = scaled_down(get_config("gemma-2b"), dtype="float32")
    kw.setdefault("log_every", 0)
    return trainer.train(cfg, tc or _tc(), seq_len=64, global_batch=8,
                         device="cpu", **kw)


def test_trainer_loss_falls_on_the_deterministic_stream():
    losses = []
    rep = _train(_tc(total_steps=12),
                 on_metrics=lambda s, m: losses.append(float(m["loss"])))
    assert rep.steps_done == 12 and rep.resumed_from is None
    assert len(rep.step_times) == 12 and rep.final_loss == losses[-1]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.05, losses
    assert all(p.device.type == "cpu" for p in rep.model.parameters())


def test_preempt_saves_and_resume_matches_an_uninterrupted_run(tmp_path):
    full = _train()
    again = _train()            # the CPU path is deterministic run to run
    for (n, a), (_, b) in zip(again.model.named_parameters(),
                              full.model.named_parameters()):
        assert torch.equal(a, b), n
    root = str(tmp_path / "run")
    with pytest.raises(trainer.PreemptionError, match="at 5"):
        _train(ckpt_dir=root, ckpt_every=2, preempt_at=5)
    assert ckpt.latest_step(root) == 5 and ckpt.latest_step(root + "/opt") == 5
    rep = _train(ckpt_dir=root, ckpt_every=2)
    assert rep.resumed_from == 5 and rep.steps_done == 3
    assert rep.final_loss == full.final_loss
    for (n, a), (_, b) in zip(rep.model.named_parameters(),
                              full.model.named_parameters()):
        assert torch.equal(a, b), n
    assert int(rep.opt_state.count) == int(full.opt_state.count) == 8
    assert ckpt.committed_steps(root) == [5, 6, 8]      # the newest 3 kept


def test_resume_from_a_periodic_checkpoint_matches_an_uninterrupted_run(
        tmp_path):
    """The optimizer state of a periodic checkpoint is written in the
    background while the next step updates it in place; resuming from it
    gives the uninterrupted run, bit for bit."""
    tc = _tc(total_steps=5)
    full = _train(tc)
    root = str(tmp_path / "run")
    _train(tc, ckpt_dir=root, ckpt_every=2)
    for d in (root, root + "/opt"):       # drop the final save of step 5
        assert ckpt.committed_steps(d) == [2, 4, 5]
        shutil.rmtree(os.path.join(d, "step_00000005"))
    rep = _train(tc, ckpt_dir=root, ckpt_every=2)
    assert rep.resumed_from == 4 and rep.steps_done == 1
    assert rep.final_loss == full.final_loss
    for (n, a), (_, b) in zip(rep.model.named_parameters(),
                              full.model.named_parameters()):
        assert torch.equal(a, b), n
    for f in ("mu", "nu"):
        for k, v in getattr(full.opt_state, f).items():
            assert torch.equal(getattr(rep.opt_state, f)[k], v), (f, k)


def test_sigterm_checkpoints_then_raises(tmp_path):
    root = str(tmp_path / "run")

    def kill(step, _):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    with pytest.raises(trainer.PreemptionError, match="SIGTERM"):
        _train(ckpt_dir=root, on_metrics=kill)
    assert signal.getsignal(signal.SIGTERM) == old
    assert ckpt.latest_step(root) == 3
    assert _train(ckpt_dir=root).resumed_from == 3


def test_straggler_steps_are_counted(monkeypatch):
    # each step reads the clock twice; step 3 takes 10x the others
    durations = [1.0, 1.0, 1.0, 10.0, 1.0, 1.0]
    ticks = iter(np.cumsum([x for d in durations for x in (0.0, d)]))
    monkeypatch.setattr(trainer.time, "perf_counter", lambda: next(ticks))
    rep = _train(_tc(total_steps=6))
    assert rep.straggler_steps == 1
    assert rep.step_times == durations


def test_launcher_scaled_on_cpu(capsys):
    rep = tlaunch.main(["--arch", "gemma-2b", "--scaled", "--device", "cpu",
                        "--steps", "3", "--seq-len", "32"])
    assert rep.steps_done == 3 and np.isfinite(rep.final_loss)
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "gemma-2b", "--scaled", "--device", "cpu",
                      "--multi-pod"])
    assert "item 12" in capsys.readouterr().err
