"""PyTorch port vs the JAX reference: the Mamba2 block (``models/mamba2.py``)
and the zamba2-2.7b hybrid LM through it (``models/lm.py``).

Inputs come from a numpy seed; weights from ``repro``'s ``init_params`` on
``scaled_down(get_config("zamba2-2.7b"), dtype="float32")`` (4 Mamba2
blocks in 2 groups of 2 around one shared attention block, d_model 128,
SSM heads of 16 with state 16, chunk 32), carried with
``carry.lm_params``. ``repro`` runs jitted. Tolerances: max |diff| <= 1e-5
through one block (``mamba2_forward``, ``mamba2_step``), and of the
output's scale for the raw chunked scan (``_ssd_chunked``); <= 1e-4 on
logits through the stack; greedy tokens identical."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import mamba2 as jm
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tm

import _torch_recurrent as rec

ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module")
def env():
    return rec.Env(ARCH)


def _layer(env, g=0, i=0):
    """Group g, block i: ``repro``'s params (jax) and the port's module."""
    jp = jax.tree_util.tree_map(lambda a: a[g, i],
                                env.params["blocks"]["mamba"])
    return jp, env.model.blocks[g][i].mamba


def test_param_count_and_config_match_reference():
    rec.check_param_count(ARCH, 2_396_172_448)


def test_blocks_are_grouped_around_one_shared_attention_block(env):
    cfg = env.tc
    assert len(env.model.blocks) == cfg.num_layers // cfg.shared_attn_every
    assert all(len(g) == cfg.shared_attn_every for g in env.model.blocks)
    names = [n for n, _ in env.model.named_parameters()]
    assert sum(n.startswith("shared_attn.") for n in names) == 8
    assert "blocks.1.1.mamba.norm.scale" in names


@pytest.mark.parametrize("S", [64, 45, 100])
def test_ssd_chunked(S):
    """S a multiple of the chunk (64 = 2 x 32) and not (45, 100: inert
    padding of the last chunk); the output and the final state, to 1e-5
    of their scale (``rec.assert_close_scaled``). x, B and C are
    N(0, 1/4), about the scale the block feeds them (conv + silu
    outputs)."""
    rng = np.random.default_rng(S)
    B, H, P, N, chunk = 2, 3, 8, 6, 32
    x = rng.standard_normal((B, S, H, P), np.float32) * 0.5
    b = rng.standard_normal((B, S, N), np.float32) * 0.5
    c = rng.standard_normal((B, S, N), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    ref = jax.jit(jm._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, b, c, dt, a_log)), chunk)
    out = tm._ssd_chunked(*map(torch.from_numpy, (x, b, c, dt, a_log)),
                          chunk)
    for t, j in zip(out, ref):
        assert tuple(t.shape) == j.shape
        rec.assert_close_scaled(t, j)


def test_causal_conv_with_and_without_state():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 5), np.float32)
    w = rng.standard_normal((4, 5), np.float32)
    st = rng.standard_normal((2, 3, 5), np.float32)
    for state in (None, st):
        jy, js = jm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if state is None else jnp.asarray(state))
        ty, ts = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if state is None
                                 else torch.from_numpy(state))
        rec.assert_close(ty, jy, rec.BLOCK_ATOL)
        assert torch.equal(ts, torch.from_numpy(np.array(js)))


@pytest.mark.parametrize("S", [32, 45])
def test_mamba2_forward_then_steps(env, S):
    """One block: the full-sequence output and its state, then three
    decode steps from that state."""
    jp, mod = _layer(env, 1, 0)
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S + 3, env.jc.d_model), np.float32)
    fwd = jax.jit(lambda p, v: jm.mamba2_forward(p, env.jc, v,
                                                 return_state=True))
    step = jax.jit(lambda p, v, s: jm.mamba2_step(p, env.jc, v, s))
    jy, js = fwd(jp, jnp.asarray(x[:, :S]))
    with torch.no_grad():
        ty, ts = tm.mamba2_forward(mod, env.tc, torch.from_numpy(x[:, :S]),
                                   return_state=True)
    rec.assert_close(ty, jy, rec.BLOCK_ATOL)
    rec.assert_state_close(ts, js)
    assert isinstance(ts, tm.MambaState)
    for t in range(S, S + 3):
        jy, js = step(jp, jnp.asarray(x[:, t:t + 1]), js)
        with torch.no_grad():
            ty, ts = tm.mamba2_step(mod, env.tc,
                                    torch.from_numpy(x[:, t:t + 1]), ts)
        rec.assert_close(ty, jy, rec.BLOCK_ATOL)
        rec.assert_state_close(ts, js)
    # the chunked form over all S + 3 tokens ends in the stepped state
    with torch.no_grad():
        _, full = tm.mamba2_forward(mod, env.tc, torch.from_numpy(x),
                                    return_state=True)
    rec.assert_state_close(full, js)


def test_init_mamba_state_matches_reference(env):
    js = jm.init_mamba_state(env.jc, 3)
    ts = tm.init_mamba_state(env.tc, 3, "cpu")
    rec.assert_state_close(ts, js)


@pytest.mark.parametrize("S", [33, 64])
def test_forward_logits(env, S):
    rec.check_forward(env, S)


def test_prefill_pad_and_greedy_decode(env):
    rec.check_prefill_then_decode(env)


def test_decode_step_with_active_mask_and_init_state(env):
    rec.check_decode_with_active(env)


def test_flash_prefill_equals_blockwise(env):
    """The shared attention block through K4 (its plain version on the
    CPU) and through the blockwise path: the hybrid's prefill agrees."""
    tok = torch.from_numpy(env.tokens(2, 40, seed=2))
    with torch.no_grad():
        a, sa = tlm.prefill(env.model, env.tc, tok,
                            ctx=tlm.RunCtx(attn_impl="flash"))
        b, sb = tlm.prefill(env.model, env.tc, tok)
    torch.testing.assert_close(a, b, atol=rec.LOGITS_ATOL, rtol=0)
    for x, y in zip(rec.t_leaves(sa), rec.t_leaves(sb)):
        torch.testing.assert_close(x, y, atol=rec.LOGITS_ATOL, rtol=0)


def test_zero_recurrent_row_clears_only_that_row(env):
    """The server's slot reset: row 1 of every Mamba2 state leaf is zero,
    the other rows and the KV caches are untouched, the input unchanged."""
    tok = torch.from_numpy(env.tokens(3, 9, seed=4))
    with torch.no_grad():
        _, st = tlm.prefill(env.model, env.tc, tok)
    cache = tlm.zero_recurrent_row(env.tc, st["cache"], 1)
    assert cache["kv"] is st["cache"]["kv"]
    for new, old in zip(cache["mamba"], st["cache"]["mamba"]):
        assert not bool(new[:, :, 1].any()) and bool(old[:, :, 1].any())
        assert torch.equal(new[:, :, 0], old[:, :, 0])
        assert torch.equal(new[:, :, 2], old[:, :, 2])


def test_loss_under_autograd(env):
    rec.check_loss_under_autograd(env)


def test_decode_state_specs_match_reference(env):
    rec.check_decode_state_specs(env)
