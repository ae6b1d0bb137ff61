"""Shared checks of the train step of one family on one device against
``repro``'s (``test_torch_train_hybrid.py``, ``test_torch_train_rwkv6.py``,
``test_torch_train_moe.py``).

Both packages start from ``repro``'s ``init_params`` of the
``scaled_down`` f32 config, carried across (``carry.lm_params``), with
fresh moments, and take three steps on the deterministic stream with
test_torch_train.py's schedule (learning rate 3e-4, one warmup step);
``repro``'s step runs jitted on a (1, 1) mesh, as test_torch_train.py
runs it. ``GTOL`` is each family's gradient limit: each leaf's loss
gradient within ``GTOL`` of its largest entry (1e-5, as for gemma; 1e-4
for the hybrid, whose chunked scan agrees with ``repro``'s to 1e-5 of
its scale only, as ``tests/_torch_recurrent.py`` states). Every other
limit follows from it, per leaf:

* the per-step loss, ce, aux, grad norm and lr within 1e-5 of
  max(1, |value|); with int8_ef or opt_int8 within 1e-4 (read: int8_ef
  1.7e-5 MoE, 1.8e-5 RWKV6, 3.4e-5 hybrid; opt_int8 1.03e-5 RWKV6),
  since where the two gradients differ in the last bits at a rounding
  tie one int8 code differs by one step, which moves the norm by up to
  scale / |g| (int8_ef) or the next step's parameters (opt_int8);
* f32: every parameter within 1e-6, as gemma's, except entries whose
  gradient is near zero (``repro``'s root mean square gradient, the
  square root of its ``nu``, below ``NEAR_ZERO`` of its leaf's
  largest), which are within the learning rate: Adam scales an update by
  1 / that root mean square, so there an f32 difference in the gradient
  moves the update by up to the learning rate. Read: MoE 3.7e-7 at
  most; RWKV6 1.28e-6 and the hybrid 2.26e-5, each in one entry of
  ``embed.table`` at 5.0e-7 / 7.4e-7 of its leaf's root mean square, all
  others within 9.5e-7;
* f32: ``mu`` within max(1e-7, ``GTOL`` of its leaf's largest |mu|), as
  gemma's 1e-7 where its gradients are large (RWKV6's ``bonus``: 4.28e-7
  = 7.9e-6 of its leaf; MoE 1.2e-8 and the hybrid 6.0e-8 at most), and
  ``nu`` within 5 ``GTOL`` of its leaf's largest (read 2.6e-6, 1.9e-5,
  3.6e-5);
* int8_ef and opt_int8: where a value is rounded to an int8 code (the
  int8_ef gradients, the int8 moments), a difference of ``GTOL`` of the
  leaf's scale puts about ``127 * GTOL`` of the codes at a tie, each then
  one step apart. So in each leaf at most ``2 + FLIPS * GTOL * size``
  entries (``_flips``) differ beyond f32's reach: parameters beyond 1e-6
  (none beyond the learning rate), f32 moments beyond ``10 * GTOL`` of
  their leaf's largest (none beyond a tenth of it), the int8_ef residuals
  beyond ``1000 * GTOL`` of their leaf's largest (a flipped code moves a
  residual by one step, twice its leaf's largest), the int8 moments'
  codes at all (none more than one apart). Most read per leaf: 16 of
  32,768 (RWKV6), 9 of 131,072 (MoE), 50 of 32,768 (hybrid), 2 of 128.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro import compat
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.dist import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro_torch import carry
from repro_torch.configs import TrainConfig, get_config, scaled_down
from repro_torch.data import pipeline
from repro_torch.dist import steps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizer as topt

DC = pipeline.DataConfig(vocab_size=512, seq_len=32, global_batch=4)
MODES = {"f32": {}, "int8_ef": dict(grad_compression="int8_ef"),
         "opt_int8": dict(opt_int8=True)}
LR = 3e-4
N_STEPS = 3
GTOL = {"zamba2-2.7b": 1e-4, "rwkv6-1.6b": 1e-5, "kimi-k2-1t-a32b": 1e-5,
        "arctic-480b": 1e-5}
NEAR_ZERO = 1e-4
FLIPS = 200


class Env:
    """One arch's scaled f32 configs and ``repro``'s weights."""

    def __init__(self, arch: str):
        self.gtol = GTOL[arch]
        self.jc = jscaled_down(jget_config(arch), dtype="float32")
        self.tc = scaled_down(get_config(arch), dtype="float32")
        self.params = jlm.init_params(jax.random.PRNGKey(0), self.jc)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.params)

    def flat(self, tree):
        return carry._flat_lm_tree(jax.tree_util.tree_map(np.asarray, tree),
                                   self.tc.num_layers)

    def model(self):
        return carry.lm_params(self.np_params, self.tc, device="cpu")


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def check_grads(env: Env) -> None:
    batch = pipeline.make_batch(DC, 0)
    jc = env.jc
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jc, b), has_aux=True))(
            env.params, _jbatch(batch))
    model = env.model()
    model.requires_grad_(True)
    tl, taux = tlm.loss_fn(model, env.tc, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    assert abs(float(taux["aux"].detach()) - float(jaux["aux"])) < 1e-5
    ref = env.flat(jg)
    assert {n for n, _ in model.named_parameters()} == set(ref)
    for name, p in model.named_parameters():
        assert p.grad.dtype == p.dtype, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                   atol=env.gtol * np.abs(ref[name]).max(),
                                   err_msg=name)


def check_steps(env: Env, mode: str) -> None:
    kw = dict(total_steps=6, warmup_steps=1, **MODES[mode])
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jsteps.make_train_step(env.jc, mesh, JTrainConfig(**kw),
                                         donate=False)
    ttc = TrainConfig(**kw)
    jp, js = env.params, jopt.init(env.params, JTrainConfig(**kw))
    model = env.model()
    ts = topt.init(dict(model.named_parameters()), ttc)
    tstep = steps.make_train_step(env.tc, ttc, device="cpu")
    mtol = 1e-5 if mode == "f32" else 1e-4
    for s in range(N_STEPS):
        b = pipeline.make_batch(DC, s)
        with mesh:
            jp, js, jm = jstep(jp, js, _jbatch(b), jnp.asarray(s))
        model, ts, tm = tstep(model, ts, b, s)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            want = float(jm[k])
            assert abs(float(tm[k]) - want) <= mtol * max(1.0, abs(want)), (
                s, k, float(tm[k]), want)
    assert int(ts.count) == int(js.count) == N_STEPS
    ref = env.flat(jp)
    dp = {}
    for name, p in model.named_parameters():
        assert p.requires_grad and p.grad is None
        assert p.dtype == torch.float32, name
        dp[name] = np.abs(p.detach().numpy() - ref[name])
    g = env.gtol
    if mode == "opt_int8":
        _flips(dp, 1e-6, LR, g)
        for f in ("mu", "nu"):
            want = env.flat(getattr(js, f))
            _flips({k: np.abs(getattr(ts, f)[k].numpy().astype(np.int32)
                              - want[k].astype(np.int32)) for k in want},
                   0, 1, g)
        return
    mu, nu = env.flat(js.mu), env.flat(js.nu)
    if mode == "f32":
        for name, d in dp.items():
            rms = np.sqrt(nu[name])
            near_zero = rms < NEAR_ZERO * rms.max()
            assert d[~near_zero].max(initial=0) <= 1e-6, (name, d.max())
            assert d.max() <= LR, (name, d.max())
        for name, w in mu.items():
            np.testing.assert_allclose(
                ts.mu[name].numpy(), w, rtol=0,
                atol=max(1e-7, g * np.abs(w).max()), err_msg=name)
        for name, w in nu.items():
            np.testing.assert_allclose(
                ts.nu[name].numpy(), w, rtol=0,
                atol=5 * g * np.abs(w).max(), err_msg=name)
        return
    _flips(dp, 1e-6, LR, g)
    for f, want in (("mu", mu), ("nu", nu)):
        _flips({k: np.abs(getattr(ts, f)[k].numpy() - w)
                / max(np.abs(w).max(), 1e-30) for k, w in want.items()},
               10 * g, 0.1, g)
    _flips({k: np.abs(ts.ef[k].numpy() - w) / max(np.abs(w).max(), 1e-30)
            for k, w in env.flat(js.ef).items()}, 1000 * g, np.inf, g)


def _flips(diffs: dict, cut: float, most: float, gtol: float) -> None:
    """In each leaf of ``diffs`` no entry beyond ``most`` and at most
    ``2 + FLIPS * gtol * size`` of them beyond ``cut``."""
    for k, d in diffs.items():
        assert float(d.max()) <= most, (k, float(d.max()))
        off = int((d > cut).sum())
        assert off <= 2 + FLIPS * gtol * d.size, (k, off, d.size)
