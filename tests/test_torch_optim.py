"""PyTorch port vs the JAX reference: AdamW, its schedule, clipping and
int8 compression (``repro_torch.optim.optimizer``).

The reference runs jitted, as its train step runs it (XLA-CPU turns its
``/ 127.0`` into a product with the f32 reciprocal, which the port
copies). Tolerances:
* ``_q8`` / ``_dq8``: codes and scales equal, bit for bit;
* ``compress_int8``: the dequantized gradient equal; the residual within
  one f32 ulp of ``g + ef`` (XLA-CPU fuses ``gf - q * scale`` into one
  FMA, the port rounds ``q * scale`` first);
* ``schedule``, ``global_norm``, clipping: rtol 1e-6;
* ``update`` from carried params, grads and moments, 1 and 3 steps: f32
  params and moments within rtol 1e-6 + atol 1e-7 (f32 rounding of the
  elementwise chain, which XLA may contract into FMAs); int8 moments'
  codes at most one apart, in at most 0.1 % of entries; bf16 params at
  most one bf16 ulp apart.
The quadratic tests of tests/test_substrate.py run on the port as they
run on the reference.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro_torch import carry
from repro_torch.configs import TrainConfig, get_config, scaled_down
from repro_torch.optim import optimizer as topt

SHAPES = {"w": (64, 256), "b": (256,), "e": (8, 3, 384), "s": (40,),
          "r": (6, 100)}
MODES = {"f32": {}, "int8_moments": dict(opt_int8=True),
         "int8_ef": dict(grad_compression="int8_ef")}


def _tcs(**kw):
    base = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


@pytest.mark.parametrize("shape", [(64, 256), (256,), (8, 3, 384), (40,),
                                   (6, 100), (2, 128, 1)])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e3])
def test_q8_codes_and_scales_equal_reference(shape, scale):
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    jq, js = jax.jit(jopt._q8)(jnp.asarray(x))
    tq, ts = topt._q8(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        topt._dq8(tq, ts).numpy(), np.asarray(jax.jit(jopt._dq8)(jq, js)))
    assert topt._blocks(shape) == jopt._blocks(shape)


def test_compress_int8_matches_reference():
    rng = np.random.default_rng(0)
    for i in range(4):
        g = rng.standard_normal((64, 256)).astype(np.float32) * 10 ** i
        ef = (rng.standard_normal((64, 256)) * 10 ** (i - 3)).astype(
            np.float32)
        jd, je = jax.jit(jopt.compress_int8)(jnp.asarray(g), jnp.asarray(ef))
        td, te = topt.compress_int8(_t(g), _t(ef))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        ulp = np.spacing(np.abs(g + ef).astype(np.float32))
        assert np.all(np.abs(te.numpy() - np.asarray(je)) <= ulp)


def test_int8_ef_scale_is_per_layer_tensor():
    """The port holds a stacked reference leaf as one tensor a layer
    (``blocks.<i>.<rest>``); the layers of one leaf share its int8_ef
    scale, so an update equals the reference's on the stacked tree, and
    a quiet layer is quantized at the loud layer's scale."""
    rng = np.random.default_rng(4)
    shapes = {"w": (3, 16, 128), "s": (3, 40)}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    for g in grads.values():
        g[1] *= 100.0                  # one loud layer
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    head = rng.standard_normal((16, 128)).astype(np.float32)
    jtc, ttc = _tcs(weight_decay=0.1, grad_compression="int8_ef")
    jp = {"blocks": {k: jnp.asarray(v) for k, v in params.items()},
          "head": jnp.asarray(head)}
    jg = {"blocks": {k: jnp.asarray(v) for k, v in grads.items()},
          "head": jnp.asarray(head * 0.01)}
    jp, js, jm = jax.jit(lambda g, s, p: jopt.update(
        g, s, p, jtc, jnp.asarray(3)))(jg, jopt.init(jp, jtc), jp)
    per_layer = lambda t: {f"blocks.{i}.{k}": _t(v[i]) for k, v in t.items()
                           for i in range(3)}
    tp = dict(per_layer(params), head=_t(head))
    _, ts, tm = topt.update(dict(per_layer(grads), head=_t(head * 0.01)),
                            topt.init(tp, ttc), tp, ttc, 3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for k in shapes:
        for i in range(3):
            name = f"blocks.{i}.{k}"
            np.testing.assert_allclose(tp[name].numpy(),
                                       np.asarray(jp["blocks"][k][i]),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
            ulp = np.spacing(np.abs(grads[k][i]))
            assert np.all(np.abs(ts.ef[name].numpy()
                                 - np.asarray(js.ef["blocks"][k][i]))
                          <= ulp), name
        # layer 0 alone would be quantized 100x finer
        _, own = topt.compress_int8(_t(grads[k][0]),
                                    torch.zeros(shapes[k][1:]))
        assert (ts.ef[f"blocks.0.{k}"].abs().max()
                > 10 * own.abs().max()), k
    np.testing.assert_allclose(tp["head"].numpy(), np.asarray(jp["head"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=0),
                                dict(warmup_steps=1, total_steps=4),
                                dict(warmup_steps=100, total_steps=1000,
                                     learning_rate=3e-4)])
def test_schedule_matches_reference(kw):
    jtc, ttc = _tcs(**kw)
    sched = jax.jit(lambda s: jopt.schedule(jtc, s))
    for step in range(0, ttc.total_steps + 3):
        got = topt.schedule(ttc, step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(sched(jnp.asarray(step))),
                                   rtol=1e-6, atol=0)
        assert float(topt.schedule(ttc, torch.tensor(step))) == float(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    rng = np.random.default_rng(1)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    jt = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    tt = {k: carry.tensor(np.asarray(v), "cpu") for k, v in jt.items()}
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jax.jit(jopt.global_norm)(jt)),
                               rtol=1e-6)
    for max_norm in (1.0, 1e6):
        jc, jn = jax.jit(lambda t: jopt.clip_by_global_norm(t, max_norm))(jt)
        tc_, tn = topt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in tree:
            assert tc_[k].dtype == torch.float32
            assert np.asarray(jc[k]).dtype == np.float32
            np.testing.assert_allclose(tc_[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-9)


def _assert_state_close(ts, js, opt_int8):
    for f in ("mu", "nu"):
        for k in SHAPES:
            got, ref = getattr(ts, f)[k], np.asarray(getattr(js, f)[k])
            if opt_int8:
                diff = np.abs(got.numpy().astype(np.int32) - ref)
                assert diff.max() <= 1 and diff.mean() <= 1e-3, (f, k)
                np.testing.assert_allclose(
                    getattr(ts, f + "_scale")[k].numpy(),
                    np.asarray(getattr(js, f + "_scale")[k]), rtol=1e-5)
            else:
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                           atol=1e-7)
    assert int(ts.count) == int(js.count)
    if js.ef is not None:
        for k in SHAPES:
            np.testing.assert_allclose(ts.ef[k].numpy(), np.asarray(js.ef[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_steps", [1, 3])
def test_update_from_carried_state_matches_reference(mode, n_steps):
    jtc, ttc = _tcs(weight_decay=0.1, grad_clip=5.0, **MODES[mode])
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    upd = jax.jit(lambda g, s, p, st: jopt.update(g, s, p, jtc, st))
    grads = lambda: {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                     for k, s in SHAPES.items()}
    # two reference steps make the moments and the residual non-zero; the
    # port starts from those, carried over
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp, jtc)
    for step in range(2):
        jp, js, _ = upd({k: jnp.asarray(v) for k, v in grads().items()}, js,
                        jp, jnp.asarray(step))
    leaf = lambda t: None if t is None else {k: _t(np.asarray(v))
                                             for k, v in t.items()}
    ts = topt.AdamState(mu=leaf(js.mu), nu=leaf(js.nu),
                        count=_t(np.asarray(js.count)), ef=leaf(js.ef),
                        mu_scale=leaf(js.mu_scale), nu_scale=leaf(js.nu_scale))
    tp = leaf(jp)
    for step in range(2, 2 + n_steps):
        g = grads()
        jp, js, jm = upd({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                         jnp.asarray(step))
        out, ts, tm = topt.update({k: _t(v) for k, v in g.items()}, ts, tp,
                                  ttc, step)
        assert out is tp                     # in place: the same dict
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    _assert_state_close(ts, js, ttc.opt_int8)


def test_bf16_update_within_one_ulp_of_reference():
    jtc, ttc = _tcs()
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: _t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
          for k, v in jp.items()}
    js, ts = jopt.init(jp, jtc), topt.init(tp, ttc)
    upd = jax.jit(lambda g, s, p, st: jopt.update(g, s, p, jtc, st))
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, js, _ = upd({k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
                        js, jp, jnp.asarray(step))
        _, ts, _ = topt.update({k: _t(v).to(torch.bfloat16)
                                for k, v in g.items()}, ts, tp, ttc, step)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        ref = np.asarray(jp[k].astype(jnp.float32))
        ulp = np.spacing(np.abs(ref)) * 2 ** 16      # bf16: 16 fewer bits
        assert np.all(np.abs(_np(tp[k]) - ref) <= ulp), k


def test_init_matches_reference_structure():
    for mode, kw in MODES.items():
        jtc, ttc = _tcs(**kw)
        jp = {k: jnp.zeros(s) for k, s in SHAPES.items()}
        tp = {k: torch.zeros(s) for k, s in SHAPES.items()}
        js, ts = jopt.init(jp, jtc), topt.init(tp, ttc)
        for f in topt.AdamState._fields:
            a, b = getattr(js, f), getattr(ts, f)
            assert (a is None) == (b is None), (mode, f)
            if isinstance(a, dict):
                for k in SHAPES:
                    assert tuple(b[k].shape) == a[k].shape, (mode, f, k)
                    assert str(b[k].dtype) == f"torch.{a[k].dtype.name}"


@pytest.mark.parametrize("opt_int8", [False, True])
def test_adam_state_carries_like_named_parameters(opt_int8):
    jc = jscaled_down(jget_config("gemma-2b"), dtype="float32")
    cfg = scaled_down(get_config("gemma-2b"), dtype="float32")
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    jtc = JTrainConfig(opt_int8=opt_int8, grad_compression="int8_ef")
    g = jax.tree_util.tree_map(lambda p: p * 0.01 + 0.001, params)
    _, state, _ = jax.jit(lambda g, s, p: jopt.update(g, s, p, jtc, jnp.asarray(0)))(
        g, jopt.init(params, jtc), params)
    state_np = jax.tree_util.tree_map(np.asarray, state)
    model = carry.lm_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    ts = carry.adam_state(state_np, model, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sorted(ts.mu) == sorted(names) and int(ts.count) == 1
    assert (ts.ef is None) == opt_int8
    np.testing.assert_array_equal(ts.mu["blocks.1.attn.wq"].numpy(),
                                  state_np.mu["blocks"]["attn"]["wq"][1])
    np.testing.assert_array_equal(ts.nu["embed.table"].numpy(),
                                  state_np.nu["embed"]["table"])
    if opt_int8:
        np.testing.assert_array_equal(
            ts.nu_scale["blocks.0.ln2.scale"].numpy(),
            state_np.nu_scale["blocks"]["ln2"]["scale"][0])


# -- the reference's own optimizer tests (tests/test_substrate.py) --------

def test_adamw_optimizes_quadratic():
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=100,
                     weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = topt.init(params, tc)
    for step in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.update(grads, state, params, tc, step)
    assert float(params["w"].abs().max()) < 0.2


def test_int8_adam_optimizes_quadratic():
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=100,
                     weight_decay=0.0, grad_clip=10.0, opt_int8=True)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = topt.init(params, tc)
    assert state.mu["w"].dtype == torch.int8          # 4x smaller residency
    for step in range(80):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.update(grads, state, params, tc, step)
    assert float(params["w"].abs().max()) < 0.3


def test_grad_clip_bounds_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(topt.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 100


def test_int8_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(256,))
                         .astype(np.float32))
    ef = torch.zeros_like(g)
    total_deq = torch.zeros_like(g)
    # accumulated dequantized grads + residual == accumulated true grads
    for _ in range(4):
        deq, ef = topt.compress_int8(g, ef)
        total_deq = total_deq + deq
    np.testing.assert_allclose((total_deq + ef).numpy(), (4 * g).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_schedule_warmup_and_decay():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(topt.schedule(tc, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2] and lrs[4] < lrs[3]
    assert lrs[4] >= 0.1e-3 * 0.99


def test_update_is_in_place_and_decays_the_named_tensors():
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=10,
                     weight_decay=0.5)
    params = {"m": torch.ones(4, 4), "v": torch.ones(4),
              "blocks.0.v": torch.ones(4)}
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    assert topt.decayed(params) == {"m", "blocks.0.v"}
    state = topt.init(params, tc)
    zero = {k: torch.zeros_like(p) for k, p in params.items()}
    topt.update(zero, state, params, tc, 0)
    assert {k: p.data_ptr() for k, p in params.items()} == ptrs
    assert float(params["m"][0, 0]) < 1.0 and float(params["v"][0]) == 1.0
    assert float(params["blocks.0.v"][0]) == float(params["m"][0, 0])
