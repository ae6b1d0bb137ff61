"""PyTorch port vs the JAX reference: the RWKV6 block (``models/rwkv6.py``)
and the rwkv6-1.6b LM through it (``models/lm.py``).

Inputs come from a numpy seed; weights from ``repro``'s ``init_params`` on
``scaled_down(get_config("rwkv6-1.6b"), dtype="float32")`` (2 layers,
d_model 128, 4 heads of 32, decay LoRA 16), carried with
``carry.lm_params``. ``repro`` runs jitted. Tolerances: max |diff| <= 1e-5
through one block (both ``rwkv6_time_mix`` branches,
``rwkv6_channel_mix``), and of the output's scale for the raw chunked scan
(``_wkv_chunked``); <= 1e-4 on logits through the stack; greedy tokens
identical."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import rwkv6 as jr
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as tr

import _torch_recurrent as rec

ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def env():
    return rec.Env(ARCH)


def _layer(env, i=0):
    """Layer i: ``repro``'s time-mix params (jax) and the port's module."""
    jp = jax.tree_util.tree_map(lambda a: a[i], env.params["blocks"]["tm"])
    return jp, env.model.blocks[i].tm


def test_param_count_and_config_match_reference():
    rec.check_param_count(ARCH, 1_583_941_632)


def test_f32_leaves_stay_f32_in_a_bf16_model():
    from repro_torch.configs import get_config, scaled_down

    model = tlm.init_params(torch.Generator().manual_seed(0),
                            scaled_down(get_config(ARCH)), "cpu")
    tm = model.blocks[0].tm
    for name in ("mu", "decay_base", "decay_b", "bonus", "ln_scale",
                 "mu_c"):
        assert getattr(tm, name).dtype == torch.float32, name
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "decay_a", "w_k_cm",
                 "w_v_cm", "w_r_cm"):
        assert getattr(tm, name).dtype == torch.bfloat16, name


@pytest.mark.parametrize("S", [128, 45, 130])
def test_wkv_chunked(S):
    """S a multiple of the chunk (128 = 2 x 64) and not (45: one short
    chunk; 130: inert padding of the third); the output and the final
    state, to 1e-5 of their scale."""
    rng = np.random.default_rng(S)
    B, H, hd = 2, 2, 8
    r, k, v = (rng.standard_normal((B, S, H, hd), np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, hd)) - 2.0).astype(
        np.float32)
    bonus = rng.standard_normal((H, hd), np.float32) * 0.1
    ref = jax.jit(jr._wkv_chunked, static_argnums=5)(
        *map(jnp.asarray, (r, k, v, logw, bonus)), 64)
    out = tr._wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, bonus)), 64)
    for t, j in zip(out, ref):
        assert tuple(t.shape) == j.shape
        rec.assert_close_scaled(t, j)


@pytest.mark.parametrize("S", [40, 70])
def test_time_mix_both_branches_and_channel_mix(env, S):
    """From a zero state (the chunked branch) over S tokens, then the
    step-by-step branch over three more from that state; channel-mix from
    no state and from the carried shift. The chunked branch over all
    S + 3 tokens ends in the stepped state."""
    jp, mod = _layer(env, 1)
    cfg_j, cfg_t = env.jc, env.tc
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 3, cfg_j.d_model), np.float32)
    tm_j = jax.jit(lambda p, v, s: jr.rwkv6_time_mix(p, cfg_j, v, s,
                                                     return_state=True))
    cm_j = jax.jit(lambda p, v, s: jr.rwkv6_channel_mix(p, cfg_j, v, s,
                                                        return_state=True))
    xa, xb = x[:, :S], x[:, S:]
    jy, jS, jlast = tm_j(jp, jnp.asarray(xa), None)
    jc_y, jc_last = cm_j(jp, jnp.asarray(xa), None)
    with torch.no_grad():
        ty, tS, tlast = tr.rwkv6_time_mix(mod, cfg_t, torch.from_numpy(xa),
                                          None, return_state=True)
        tc_y, tc_last = tr.rwkv6_channel_mix(mod, cfg_t,
                                             torch.from_numpy(xa), None,
                                             return_state=True)
    for t, j in ((ty, jy), (tS, jS), (tc_y, jc_y)):
        rec.assert_close(t, j, rec.BLOCK_ATOL)
    assert torch.equal(tlast, torch.from_numpy(xa[:, -1]))
    assert torch.equal(tc_last, tlast)

    jst = jr.RWKVState(wkv=jS, shift_t=jlast, shift_c=jc_last)
    tst = tr.RWKVState(wkv=tS, shift_t=tlast, shift_c=tc_last)
    jy2, jS2, _ = tm_j(jp, jnp.asarray(xb), jst)
    jc2, _ = cm_j(jp, jnp.asarray(xb), jst)
    with torch.no_grad():
        ty2, tS2, _ = tr.rwkv6_time_mix(mod, cfg_t, torch.from_numpy(xb),
                                        tst, return_state=True)
        tc2, _ = tr.rwkv6_channel_mix(mod, cfg_t, torch.from_numpy(xb), tst,
                                      return_state=True)
        _, tS_full, _ = tr.rwkv6_time_mix(mod, cfg_t, torch.from_numpy(x),
                                          None, return_state=True)
    for t, j in ((ty2, jy2), (tS2, jS2), (tc2, jc2), (tS_full, jS2)):
        rec.assert_close(t, j, rec.BLOCK_ATOL)


def test_init_rwkv_state_matches_reference(env):
    rec.assert_state_close(tr.init_rwkv_state(env.tc, 3, "cpu"),
                           jr.init_rwkv_state(env.jc, 3))


@pytest.mark.parametrize("S", [33, 70])
def test_forward_logits(env, S):
    rec.check_forward(env, S)


def test_prefill_pad_and_greedy_decode(env):
    rec.check_prefill_then_decode(env)


def test_decode_step_with_active_mask_and_init_state(env):
    rec.check_decode_with_active(env)


def test_decode_state_size_does_not_grow_with_max_len(env):
    """The sub-quadratic property: apart from ``pos``, the RWKV decode
    state holds the same bytes at any capacity; padding leaves it as it
    is."""
    nbytes = lambda st: sum(a.numel() * a.element_size()
                            for a in rec.t_leaves(st["cache"]))
    small = tlm.init_decode_state(env.tc, 2, 16, device="cpu")
    big = tlm.init_decode_state(env.tc, 2, 4096, device="cpu")
    assert nbytes(small) == nbytes(big) > 0
    assert tlm.pad_decode_state(env.tc, small, 64)["cache"] is small["cache"]


def test_zero_recurrent_row_clears_only_that_row(env):
    tok = torch.from_numpy(env.tokens(3, 9, seed=4))
    with torch.no_grad():
        _, st = tlm.prefill(env.model, env.tc, tok)
    cache = tlm.zero_recurrent_row(env.tc, st["cache"], 2)
    for new, old in zip(cache, st["cache"]):
        assert not bool(new[:, 2].any()) and bool(old[:, 2].any())
        assert torch.equal(new[:, :2], old[:, :2])


def test_loss_under_autograd(env):
    rec.check_loss_under_autograd(env)


def test_decode_state_specs_match_reference(env):
    rec.check_decode_state_specs(env)
