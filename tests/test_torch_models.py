"""PyTorch port vs the JAX reference: the model layers, attention (prefill
in both impls and schedules, decode) and the LM's forward, prefill and
decode steps on the same carried weights.

Weights come from ``repro.models.lm.init_params`` and cross through
``carry.lm_params``; inputs from a numpy seed. The config is
``scaled_down(get_config("gemma-2b"))`` (2 layers, d_model 128, 4 heads,
1 KV head, hd 32, vocab 512). Tolerances: float32 atol 2e-5 / rtol 1e-5
(only the order of sums differs); bfloat16 atol 0.08 on logits, which
the two frameworks round at different places (one bf16 ulp at 8 is
0.0625)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.models import attention as jattn
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import carry
from repro_torch.configs import (BlockKind, MoEConfig, RWKVConfig,
                                  SSMConfig, TrainConfig, get_config,
                                  scaled_down)
from repro_torch.dist import steps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizer as topt

F32 = dict(atol=2e-5, rtol=1e-5)


def _cfgs(dtype="float32", **kw):
    return (jscaled_down(jget_config("gemma-2b"), dtype=dtype, **kw),
            scaled_down(get_config("gemma-2b"), dtype=dtype, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **(tol or F32))


@pytest.fixture(scope="module")
def f32_model():
    jc, tc = _cfgs()
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, params, carry.lm_params(_np(params), tc, device="cpu")


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_config_and_param_count_match_reference():
    jc, tc = jget_config("gemma-2b"), get_config("gemma-2b")
    assert tc.resolved_head_dim == jc.resolved_head_dim == 256
    assert tlm.param_count(tc) == jlm.param_count(jc) == 2_506_172_416
    j_small, t_small = _cfgs()
    assert tlm.param_count(t_small) == jlm.param_count(j_small)


def test_rmsnorm_rope_embed_unembed_and_cross_entropy():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 128), np.float32)
    scale = rng.standard_normal(128, np.float32)
    norm = tlayers.rmsnorm_init(128, "cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    _close(tlayers.rmsnorm(norm, torch.from_numpy(x), 1e-6),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6))

    h = rng.standard_normal((2, 9, 4, 32), np.float32)
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    _close(tlayers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                              10000.0),
           jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 10000.0))

    table = rng.standard_normal((50, 128), np.float32)
    emb = tlayers.Embedding(50, 128, torch.float32, "cpu")
    emb.table.copy_(torch.from_numpy(table))
    tok = rng.integers(0, 50, (2, 9)).astype(np.int32)
    _close(tlayers.embed(emb, torch.from_numpy(tok)), table[tok])
    logits_t = tlayers.unembed(emb, torch.from_numpy(x))
    logits_j = jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))
    _close(logits_t, logits_j)
    mask = rng.integers(0, 2, (2, 9)).astype(np.float32)
    for m in (None, mask):
        _close(tlayers.cross_entropy(
                   logits_t, torch.from_numpy(tok),
                   None if m is None else torch.from_numpy(m)),
               jlayers.cross_entropy(logits_j, jnp.asarray(tok),
                                     None if m is None else jnp.asarray(m)))


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "relu_sq"])
def test_mlp_activations(activation):
    p = _np(jlayers.mlp_init(jax.random.PRNGKey(3), 128, 256, activation,
                             jnp.float32))
    m = tlayers.MLP(128, 256, activation, torch.float32, "cpu")
    assert set(dict(m.named_parameters())) == set(p)
    for name, w in p.items():
        getattr(m, name).copy_(torch.from_numpy(w.copy()))
    x = np.random.default_rng(4).standard_normal((2, 5, 128), np.float32)
    _close(tlayers.mlp(m, torch.from_numpy(x), activation),
           jlayers.mlp(p, jnp.asarray(x), activation))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn(f32_model, layer=0):
    _, _, params, model = f32_model
    jp = jax.tree_util.tree_map(lambda a: a[layer], params["blocks"]["attn"])
    return jp, model.blocks[layer].attn


@pytest.mark.parametrize("impl,causal_skip",
                         [("xla", False), ("xla", True), ("flash", False)])
def test_attention_prefill(f32_model, impl, causal_skip):
    jp, tp = _attn(f32_model)
    x = np.random.default_rng(5).standard_normal((2, 70, 128), np.float32)
    pos = np.broadcast_to(np.arange(70, dtype=np.int32), (2, 70))
    kw = dict(chunk=32, causal_skip=causal_skip, impl=impl,
              return_cache=True)
    jy, jcache = jattn.attention_prefill(jp, jnp.asarray(x), jnp.asarray(pos),
                                         10000.0, **kw)
    ty, tcache = tattn.attention_prefill(tp, torch.from_numpy(x),
                                         torch.from_numpy(pos.copy()),
                                         10000.0, **kw)
    _close(ty, jy)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)


def test_blockwise_bf16_probabilities():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 50, n, 32), np.float32)
               for n in (4, 1, 1))
    for skip in (False, True):
        ref = jattn.blockwise_causal_attention(
            *map(jnp.asarray, (q, k, v)), chunk=16, causal_skip=skip,
            p_bf16=True)
        out = tattn.blockwise_causal_attention(
            *map(torch.from_numpy, (q, k, v)), chunk=16, causal_skip=skip,
            p_bf16=True)
        _close(out, ref, atol=1e-2)


def test_attention_decode_per_row_pos_and_active(f32_model):
    jp, tp = _attn(f32_model)
    rng = np.random.default_rng(7)
    B, S_max = 3, 12
    x = rng.standard_normal((B, 1, 128), np.float32)
    ck = rng.standard_normal((B, S_max, 1, 32), np.float32)
    cv = rng.standard_normal((B, S_max, 1, 32), np.float32)
    pos = np.array([0, 5, 11], np.int32)
    active = np.array([True, False, True])
    jy, jc = jattn.attention_decode(jp, jnp.asarray(x),
                                    jattn.KVCache(jnp.asarray(ck),
                                                  jnp.asarray(cv)),
                                    jnp.asarray(pos), 10000.0,
                                    active=jnp.asarray(active))
    cache = tattn.KVCache(torch.from_numpy(ck), torch.from_numpy(cv))
    ty, tc = tattn.attention_decode(tp, torch.from_numpy(x), cache,
                                    torch.from_numpy(pos), 10000.0,
                                    active=torch.from_numpy(active))
    _close(ty, jy)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert np.array_equal(cache.k.numpy(), ck)       # the input is kept
    assert np.array_equal(tc.k[1].numpy(), ck[1])    # inactive row untouched


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_and_hidden(f32_model, impl):
    jc, tc, params, model = f32_model
    tok = _tokens(2, 40, tc.vocab_size)
    jl, jaux, jh = jlm.forward(params, jc, jnp.asarray(tok),
                               ctx=jlm.RunCtx(attn_impl=impl, attn_chunk=16),
                               return_hidden=True)
    tl, taux, th = tlm.forward(model, tc, torch.from_numpy(tok),
                               ctx=tlm.RunCtx(attn_impl=impl, attn_chunk=16),
                               return_hidden=True)
    _close(tl, jl)
    _close(th, jh)
    assert float(taux) == float(jaux) == 0.0


def test_forward_bf16():
    jc, tc = _cfgs("bfloat16")
    params = jlm.init_params(jax.random.PRNGKey(1), jc)
    model = carry.lm_params(_np(params), tc, device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    assert np.array_equal(
        model.blocks[1].attn.wq.view(torch.uint16).numpy(),
        np.asarray(params["blocks"]["attn"]["wq"][1]).view(np.uint16))
    tok = _tokens(2, 24, tc.vocab_size, seed=1)
    for impl in ("xla", "flash"):
        jl, _ = jlm.forward(params, jc, jnp.asarray(tok),
                            ctx=jlm.RunCtx(attn_impl=impl))
        tl, _ = tlm.forward(model, tc, torch.from_numpy(tok),
                            ctx=tlm.RunCtx(attn_impl=impl))
        assert tl.dtype == torch.bfloat16
        _close(tl, jl, atol=0.08, rtol=0)


def test_prefill_logits_and_cache(f32_model):
    jc, tc, params, model = f32_model
    tok = _tokens(2, 33, tc.vocab_size, seed=2)
    ctx = dict(attn_impl="flash", attn_chunk=16)
    jl, js = jlm.prefill(params, jc, jnp.asarray(tok), ctx=jlm.RunCtx(**ctx))
    tl, ts = tlm.prefill(model, tc, torch.from_numpy(tok),
                         ctx=tlm.RunCtx(**ctx))
    _close(tl, jl)
    _close(ts["cache"].k, js["cache"].k)
    _close(ts["cache"].v, js["cache"].v)
    assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist() == [33, 33]


def test_decode_chain_after_prefill(f32_model):
    """prefill -> pad the cache -> decode steps with per-row positions and
    an inactive row: logits, hidden states and caches track the
    reference's at every step."""
    jc, tc, params, model = f32_model
    tok = _tokens(3, 10, tc.vocab_size, seed=3)
    _, js = jlm.prefill(params, jc, jnp.asarray(tok))
    _, ts = tlm.prefill(model, tc, torch.from_numpy(tok))
    js = jlm.pad_decode_state(jc, js, 16)
    ts = tlm.pad_decode_state(tc, ts, 16)
    js = dict(js, pos=jnp.asarray([10, 4, 7], jnp.int32))
    ts = dict(ts, pos=torch.tensor([10, 4, 7], dtype=torch.int32))
    active = np.array([True, True, False])
    nxt = tok[:, -1:]
    for _ in range(4):
        jl, js, jh = jlm.decode_step(params, jc, jnp.asarray(nxt), js,
                                     active=jnp.asarray(active),
                                     return_hidden=True)
        tl, ts, th = tlm.decode_step(model, tc, torch.from_numpy(nxt), ts,
                                     active=torch.from_numpy(active),
                                     return_hidden=True)
        _close(tl, jl)
        _close(th, jh)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist() == [14, 8, 7]
    _close(ts["cache"].k, js["cache"].k)
    _close(ts["cache"].v, js["cache"].v)


def test_decode_from_zero_state_matches_forward(f32_model):
    """Token-by-token decode from ``init_decode_state`` reproduces the
    full-sequence logits (the server's prompt replay relies on it)."""
    jc, tc, params, model = f32_model
    tok = _tokens(2, 6, tc.vocab_size, seed=4)
    state = tlm.init_decode_state(tc, 2, 8, device="cpu")
    jstate = jlm.init_decode_state(jc, 2, 8)
    assert state["cache"].k.shape == jstate["cache"].k.shape
    steps = []
    for t in range(6):
        logits, state = tlm.decode_step(model, tc,
                                        torch.from_numpy(tok[:, t:t + 1]),
                                        state)
        steps.append(logits)
    full, _ = tlm.forward(model, tc, torch.from_numpy(tok))
    torch.testing.assert_close(torch.cat(steps, 1), full, **F32)
    _close(full, jlm.forward(params, jc, jnp.asarray(tok))[0])


# ---------------------------------------------------------------------------
# every registered arch of the dense, frontend and MoE families
# ---------------------------------------------------------------------------

NEW_ARCHS = ("granite-20b", "internlm2-20b", "deepseek-67b",
             "llava-next-mistral-7b", "musicgen-medium", "arctic-480b",
             "kimi-k2-1t-a32b")
LOGITS = dict(atol=1e-4, rtol=1e-4)
_ARCH_ENVS = {}


def _arch_env(arch):
    """(repro cfg, port cfg, repro params, the port's model, the prefix
    as numpy or None) of the scaled f32 config."""
    if arch not in _ARCH_ENVS:
        jc = jscaled_down(jget_config(arch), dtype="float32")
        tc = scaled_down(get_config(arch), dtype="float32")
        params = jlm.init_params(jax.random.PRNGKey(2), jc)
        pre = jfrontends.synthetic_prefix(jc, 2)
        _ARCH_ENVS[arch] = (jc, tc, params,
                            carry.lm_params(_np(params), tc, device="cpu"),
                            None if pre is None else np.array(pre))
    return _ARCH_ENVS[arch]


def test_registry_matches_reference():
    """The port registers repro's ten archs with the same fields."""
    from repro.configs import ALL_ARCHS as JALL
    from repro_torch.configs import ALL_ARCHS

    def plain(cfg):
        d = dataclasses.asdict(cfg)
        d["block_pattern"] = [k.value for k in cfg.block_pattern]
        return d

    assert ALL_ARCHS == JALL and len(ALL_ARCHS) == 10
    for arch in ALL_ARCHS:
        assert plain(get_config(arch)) == plain(jget_config(arch)), arch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registered_arch_param_count(arch):
    """Full and active counts at the registered width, and the scaled
    config's, equal repro's."""
    jc, tc = jget_config(arch), get_config(arch)
    for active in (False, True):
        assert (tlm.param_count(tc, active_only=active)
                == jlm.param_count(jc, active_only=active))
    assert (tlm.param_count(tc, active_only=True) < tlm.param_count(tc)) \
        == (tc.moe is not None)
    j_small, t_small = _arch_env(arch)[:2]
    assert tlm.param_count(t_small, True) == jlm.param_count(j_small, True)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registered_arch_forward_and_loss(arch):
    """forward's logits and aux, and loss_fn (the router aux weighted in
    for MoE; the prefix dropped from the loss for a frontend)."""
    jc, tc, params, model, pre = _arch_env(arch)
    tok = _tokens(2, 12, tc.vocab_size, seed=5)
    jpre = None if pre is None else jnp.asarray(pre)
    tpre = None if pre is None else torch.from_numpy(pre)
    jl, jaux = jlm.forward(params, jc, jnp.asarray(tok), jpre)
    tl, taux = tlm.forward(model, tc, torch.from_numpy(tok), tpre)
    _close(tl, jl, **LOGITS)
    _close(taux, jaux)
    assert (float(taux) > 0) == (tc.moe is not None)
    labels = _tokens(2, 12, tc.vocab_size, seed=6)
    jloss, jm = jlm.loss_fn(params, jc, {"tokens": jnp.asarray(tok),
                                         "labels": jnp.asarray(labels),
                                         "prefix_emb": jpre})
    tloss, tm = tlm.loss_fn(model, tc, {"tokens": torch.from_numpy(tok),
                                        "labels": torch.from_numpy(labels),
                                        "prefix_emb": tpre})
    for t, j in ((tloss, jloss), (tm["ce"], jm["ce"]), (tm["aux"],
                                                         jm["aux"])):
        assert abs(float(t) - float(j)) < 1e-5


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registered_arch_prefill_and_decode(arch):
    """prefill (with the prefix where the config has one) -> pad -> decode
    steps with per-row positions and an inactive row."""
    jc, tc, params, model, pre = _arch_env(arch)
    tok = _tokens(2, 9, tc.vocab_size, seed=7)
    jl, js = jlm.prefill(params, jc, jnp.asarray(tok),
                         None if pre is None else jnp.asarray(pre))
    tl, ts = tlm.prefill(model, tc, torch.from_numpy(tok),
                         None if pre is None else torch.from_numpy(pre))
    _close(tl, jl, **LOGITS)
    n = 9 + tc.frontend_positions
    assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist() == [n, n]
    js, ts = jlm.pad_decode_state(jc, js, n + 4), tlm.pad_decode_state(
        tc, ts, n + 4)
    assert ts["cache"].k.shape == js["cache"].k.shape
    active = np.array([True, False])
    nxt = tok[:, -1:]
    for _ in range(3):
        jl, js = jlm.decode_step(params, jc, jnp.asarray(nxt), js,
                                 active=jnp.asarray(active))
        tl, ts = tlm.decode_step(model, tc, torch.from_numpy(nxt), ts,
                                 active=torch.from_numpy(active))
        _close(tl, jl, **LOGITS)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist() == [n + 3, n]
    _close(ts["cache"].k, js["cache"].k)
    empty = tlm.init_decode_state(tc, 2, 8, device="cpu")
    assert empty["cache"].k.shape == jlm.init_decode_state(jc, 2, 8)[
        "cache"].k.shape


_SSM = SSMConfig(state_dim=16, head_dim=16, chunk_size=32)


@pytest.mark.parametrize("change", [
    dict(block_pattern=(BlockKind.MOE,),
         moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=64)),
    dict(block_pattern=(BlockKind.MAMBA2,), ssm=_SSM),
    dict(block_pattern=(BlockKind.RWKV6,),
         rwkv=RWKVConfig(head_dim=32, decay_lora=16, gate_lora=16)),
    dict(block_pattern=(BlockKind.MAMBA2,), shared_attn_every=2, ssm=_SSM),
    dict(frontend="vision_patches", frontend_positions=4),
], ids=["moe", "mamba2", "rwkv6", "hybrid", "frontend"])
def test_unported_families_raise(change):
    """Every family builds, runs forward and takes a finite train step
    (the train step once raised for the recurrent and MoE families; the
    name is kept). MoE and the hybrid and RWKV6 decode; a pure Mamba2
    stack has no decode step, as in ``repro``. A frontend config's
    forward raises without the prefix."""
    cfg = dataclasses.replace(scaled_down(get_config("gemma-2b")), **change)
    model = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tlm.param_count(cfg) == sum(p.numel() for p in model.parameters())
    tok = torch.zeros((1, 3), dtype=torch.int64)
    tc = TrainConfig(warmup_steps=0)
    step = steps.make_train_step(cfg, tc, device="cpu")
    opt = topt.init(dict(model.named_parameters()), tc)
    batch = {"tokens": tok, "labels": tok}
    if "frontend" in change:
        with pytest.raises(ValueError, match="frontend embeddings"):
            tlm.forward(model, cfg, tok)
        batch["prefix_emb"] = torch.randn(
            (1, 4, 1024), generator=torch.Generator().manual_seed(1)).to(
                torch.bfloat16)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, opt, m = step(model, opt, batch, 0)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert (float(m["aux"]) > 0) == ("moe" in change)
    assert int(opt.count) == 1
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    if "frontend" in change:
        return
    with torch.no_grad():
        logits, aux = tlm.forward(model, cfg, tok)
    assert logits.shape == (1, 3, cfg.vocab_size)
    assert (float(aux) > 0) == ("moe" in change)
    state = tlm.init_decode_state(cfg, 1, 4, device="cpu")
    step = lambda: tlm.decode_step(model, cfg, tok[:, :1], state)
    if cfg.block_pattern == (BlockKind.MAMBA2,) and not cfg.shared_attn_every:
        with pytest.raises(ValueError):
            step()
    else:
        assert step()[0].shape == (1, 1, cfg.vocab_size)


def test_keep_active_selects_rows_as_the_reference():
    rng = np.random.default_rng(8)
    new = [rng.standard_normal((3, 2, 4)).astype(np.float32) for _ in range(2)]
    old = [rng.standard_normal((3, 2, 4)).astype(np.float32) for _ in range(2)]
    active = np.array([True, False, True])
    ref = jlm._keep_active(jnp.asarray(active),
                           jattn.KVCache(*map(jnp.asarray, new)),
                           jattn.KVCache(*map(jnp.asarray, old)))
    out = tlm._keep_active(torch.from_numpy(active),
                           tattn.KVCache(*map(torch.from_numpy, new)),
                           tattn.KVCache(*map(torch.from_numpy, old)))
    assert isinstance(out, tattn.KVCache)
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tlm._keep_active(None, out, None) is out
