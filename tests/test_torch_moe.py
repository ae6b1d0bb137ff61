"""PyTorch port vs the JAX reference: the MoE layer (``models/moe.py``) on
one device and with expert parallelism on ``torch.distributed``.

Weights come from ``repro.models.moe.moe_init`` as numpy; inputs from a
numpy seed. Configs are ``scaled_down`` kimi-k2 (8 experts, top 2, one
shared expert) and arctic-480b (top 2, a dense residual MLP), in f32.
Integer outputs (route ids, capacity ranks, kept entries) are compared
exactly; the layer's output and aux within 1e-5.

The expert-parallel cases run the port on a world of 4 gloo ranks on the
CPU (``_torch_world.World``; rank tasks in ``_torch_moe_tasks.py``),
each rank holding its own experts and its own slice of the tokens, and
``repro``'s ``moe_forward`` under ``shard_map`` once, jitted, in a
subprocess with 4 host devices, on the same numpy weights and tokens:
meshes (2, 2) ("data", "model") and (1, 4). At capacity_factor 1.0 some
entries drop, and the port must keep exactly the entries ``repro``
keeps. The int8 dispatch is held to the same 1e-5: its scale is
``max|x|`` times the f32 reciprocal of 127, as jitted XLA computes
``/ 127.0``, so both packages round the same quotients.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_moe_tasks as tasks
from _torch_world import World
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import carry
from repro_torch.configs import get_config, scaled_down
from repro_torch.models import moe as tmoe

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("kimi-k2-1t-a32b", "arctic-480b")
B, S = 4, 16


def _cfgs(arch, cf=None):
    jc = jscaled_down(jget_config(arch), dtype="float32")
    tc = scaled_down(get_config(arch), dtype="float32")
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=cf))
    return jc, tc


def _flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


_WEIGHTS = {}


def _weights(arch):
    """repro's moe_init of the scaled f32 config, flattened, and the port's
    layer from it."""
    if arch not in _WEIGHTS:
        jc, tc = _cfgs(arch)
        tree = jmoe.moe_init(jax.random.PRNGKey(3), jc, jnp.float32)
        _WEIGHTS[arch] = (tree, _flat(tree))
    tree, flat = _WEIGHTS[arch]
    return tree, flat, tasks.layer(_cfgs(arch)[1], flat)


def _x(T=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, S, 128) if T is None else (T, 128)
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_structure(arch):
    """Leaf names, shapes and dtypes of moe_init in a bf16 model: the
    router stays f32."""
    jc = jscaled_down(jget_config(arch))
    tc = scaled_down(get_config(arch))
    jtree = _flat(jax.eval_shape(lambda: jmoe.moe_init(
        jax.random.PRNGKey(0), jc, jnp.bfloat16)), leaf=lambda a: a)
    m = tmoe.moe_init(torch.Generator().manual_seed(0), tc, torch.bfloat16,
                      "cpu")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for n, p in m.named_parameters()}
    want = {n: (tuple(a.shape), str(a.dtype)) for n, a in jtree.items()}
    assert got == want
    assert m.router.dtype == torch.float32
    assert float(m.w_out.float().std()) == pytest.approx(128 ** -0.5,
                                                         rel=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_aux(arch):
    tree, _, m = _weights(arch)
    jc, tc = _cfgs(arch)
    x = _x(T=64)
    K = tc.moe.experts_per_token
    jw, ji, jp = jmoe._route(tree["router"], jnp.asarray(x), K)
    tw, ti, tp = tmoe._route(m.router, torch.from_numpy(x), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _close(tp, jp)
    _close(tmoe._aux_loss(tp, ti, tc.moe.num_experts),
           jmoe._aux_loss(jp, ji, jc.moe.num_experts))


def test_route_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..K-1 in that order, with equal weights."""
    _, tc = _cfgs("kimi-k2-1t-a32b")
    x = _x(T=8)
    router = np.zeros((128, tc.moe.num_experts), np.float32)
    jw, ji, _ = jmoe._route(jnp.asarray(router), jnp.asarray(x), 2)
    tw, ti, _ = tmoe._route(torch.from_numpy(router), torch.from_numpy(x), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [[0, 1]] * 8
    _close(tw, jw)


def test_rank_in_group():
    g = np.random.default_rng(1).integers(0, 5, 200).astype(np.int32)
    want = np.asarray(jmoe._rank_in_group(jnp.asarray(g), 5))
    np.testing.assert_array_equal(tasks.rank_in_group(g, 5), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_ffn(arch):
    tree, _, m = _weights(arch)
    xbuf = np.random.default_rng(2).standard_normal((8, 6, 128)).astype(
        np.float32)
    _close(tmoe._expert_ffn(m.w_gate, m.w_up, m.w_out,
                            torch.from_numpy(xbuf)),
           jmoe._expert_ffn(tree["w_gate"], tree["w_up"], tree["w_out"],
                            jnp.asarray(xbuf)))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_reference_and_forward(arch):
    """The capacity-free expert loop and moe_forward without a mesh (the
    shared expert or the dense residual added)."""
    tree, _, m = _weights(arch)
    jc, tc = _cfgs(arch)
    x = _x(seed=3)
    jy, jaux = jmoe.moe_reference(tree, jc, jnp.asarray(x.reshape(-1, 128)))
    ty, taux = tmoe.moe_reference(m, tc, torch.from_numpy(x.reshape(-1,
                                                                    128)))
    _close(ty, jy)
    _close(taux, jaux)
    jy, jaux = jmoe.moe_forward(tree, jc, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(m, tc, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)


def _kept(mod, router, xs, cfg, n):
    """Route ids, dispatch ranks and kept flags of every rank's slice, and
    the expert-stage ranks and kept flags of every destination, through
    ``mod``'s own helpers (``_route``, ``_rank_in_group``); the all-to-all
    emulated in numpy (chunk i of rank r arrives at rank i, row r)."""
    moe = cfg.moe
    K, E = moe.experts_per_token, moe.num_experts
    E_loc = E // n
    conv = ((lambda a: np.asarray(a)) if mod is jmoe
            else (lambda a: a.numpy()))
    arr = jnp.asarray if mod is jmoe else torch.from_numpy
    out, sends = {}, []
    for r, x in enumerate(xs):
        T = x.shape[0]
        _, idx, _ = mod._route(arr(router), arr(x), K)
        flat_e = conv(idx).reshape(-1)
        dest = flat_e // E_loc
        c_send = jmoe._round_up(max(1, int(moe.capacity_factor * T * K / n)),
                                8)
        rank = conv(mod._rank_in_group(arr(dest.astype(np.int32)), n))
        keep = rank < c_send
        out[f"idx{r}"], out[f"rank{r}"], out[f"keep{r}"] = flat_e, rank, keep
        eid = np.full((n, c_send), -1, np.int64)
        eid[dest[keep], rank[keep]] = flat_e[keep]
        sends.append(eid)
    for i in range(n):
        re = np.stack([sends[r][i] for r in range(n)]).reshape(-1)
        valid = re >= 0
        eloc = np.where(valid, re % E_loc, 0)
        c_exp = jmoe._round_up(max(1, int(moe.capacity_factor * re.shape[0]
                                          / E_loc)), 8)
        erank = conv(mod._rank_in_group(
            arr(np.where(valid, eloc, E_loc).astype(np.int32)), E_loc + 1))
        out[f"erank{i}"] = erank
        out[f"ekeep{i}"] = valid & (erank < c_exp)
    return out


def test_capacity_drops_keep_the_reference_entries():
    """At capacity_factor 1.0 over 4 expert shards entries drop at both
    stages; route ids, capacity ranks and kept flags are repro's
    exactly."""
    jc, tc = _cfgs("kimi-k2-1t-a32b", cf=1.0)
    tree, _, _ = _weights("kimi-k2-1t-a32b")
    x = _x(T=B * S, seed=4)
    xs = np.split(x, 4)
    want = _kept(jmoe, np.asarray(tree["router"]), xs, jc, 4)
    got = _kept(tmoe, np.asarray(tree["router"]), xs, tc, 4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert sum(int((~want[f"keep{r}"]).sum()) for r in range(4)) > 0


def test_strategy_resolution_reads_the_global_length():
    assert tmoe.resolve_strategy("auto", 16, 4) == "a2a"
    assert tmoe.resolve_strategy("auto", 1, 4) == "allgather"
    assert tmoe.resolve_strategy("auto", 6, 4) == "allgather"
    assert tmoe.resolve_strategy("allgather", 16, 4) == "allgather"
    assert tmoe.ep_size(None, "model") == 1


# ---------------------------------------------------------------------------
# expert parallelism: repro under shard_map, the port on 4 gloo ranks
# ---------------------------------------------------------------------------

_REPRO_SCRIPT = """
import dataclasses, warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config, scaled_down
from repro.models import lm, moe
warnings.simplefilter("ignore")
inp = np.load({inp!r})
def tree_of(prefix):
    t = {{}}
    for key in inp.files:
        if not key.startswith(prefix):
            continue
        node, parts = t, key[len(prefix):].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = jnp.asarray(inp[key])
    return t
def cfg_at(cf):
    c = scaled_down(get_config({arch!r}), dtype="float32")
    return dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                          capacity_factor=cf))
devs = np.array(jax.devices())
meshes = {{"2x2": Mesh(devs.reshape(2, 2), ("data", "model")),
          "1x4": Mesh(devs.reshape(1, 4), ("data", "model"))}}
params, x = tree_of("w."), jnp.asarray(inp["x"])
out = {{}}
for name, mesh_key, strategy, int8, cf in {cases!r}:
    cfg = cfg_at(cf)
    f = jax.jit(lambda p, xx: moe.moe_forward(
        p, cfg, xx, mesh=meshes[mesh_key], strategy=strategy, a2a_int8=int8))
    with meshes[mesh_key]:
        y, aux = f(params, x)
    out[name + ".y"], out[name + ".aux"] = np.asarray(y), np.asarray(aux)
lp, tok = tree_of("lm."), jnp.asarray(inp["tokens"])
cfg = scaled_down(get_config({arch!r}), dtype="float32")
for strategy in ("a2a", "allgather"):
    ctx = lm.RunCtx(mesh=meshes["2x2"], moe_strategy=strategy)
    f = jax.jit(lambda p, t: lm.forward(p, cfg, t, ctx=ctx))
    with meshes["2x2"]:
        logits, aux = f(lp, tok)
    out["lm_" + strategy + ".y"] = np.asarray(logits)
    out["lm_" + strategy + ".aux"] = np.asarray(aux)
np.savez({out_path!r}, **out)
print("OK")
"""

EP_ARCH = "kimi-k2-1t-a32b"
# name, mesh, strategy, int8, capacity_factor
EP_CASES = [("a2a", "2x2", "a2a", False, 1.25),
            ("allgather", "2x2", "allgather", False, 1.25),
            ("a2a_int8", "2x2", "a2a", True, 1.25),
            ("a2a_drop", "1x4", "a2a", False, 1.0),
            ("allgather_drop", "1x4", "allgather", False, 1.0),
            ("a2a_roomy", "1x4", "a2a", False, 8.0)]
MESH_SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
NAMES = ("data", "model")


@pytest.fixture(scope="module")
def ep_inputs():
    jc, _ = _cfgs(EP_ARCH)
    tree, flat, _ = _weights(EP_ARCH)
    lm_tree = jlm.init_params(jax.random.PRNGKey(5), jc)
    lm_flat = _flat(lm_tree)
    tokens = np.random.default_rng(6).integers(0, jc.vocab_size, (B, S)
                                               ).astype(np.int32)
    return dict(x=_x(seed=5), flat=flat, lm_tree=jax.tree_util.tree_map(
        np.asarray, lm_tree), lm_flat=lm_flat, tokens=tokens)


@pytest.fixture(scope="module")
def repro_ep(multidevice, tmp_path_factory, ep_inputs):
    tmp = tmp_path_factory.mktemp("repro_ep")
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    arrays = {f"w.{k}": v for k, v in ep_inputs["flat"].items()}
    arrays.update({f"lm.{k}": v for k, v in ep_inputs["lm_flat"].items()})
    np.savez(inp, x=ep_inputs["x"], tokens=ep_inputs["tokens"], **arrays)
    multidevice(_REPRO_SCRIPT.format(inp=inp, out_path=out, arch=EP_ARCH,
                                     cases=EP_CASES), n_devices=4)
    res = np.load(out)
    return {k: res[k] for k in res.files}


@pytest.fixture(scope="module")
def world():
    with World(4) as w:
        yield w


def _assemble(outs, shape, strategy):
    """The ranks' (y slice, aux, coords, transport) -> the global y: the
    batch over the data axis, the sequence over the model axis for a2a
    (allgather's replicas must agree)."""
    dn, en = shape
    rows = []
    for di in range(dn):
        parts = {o[2][1]: o[0] for o in outs if o[2][0] == di}
        if strategy == "a2a":
            rows.append(np.concatenate([parts[e] for e in range(en)], 1))
        else:
            for e in range(1, en):
                np.testing.assert_array_equal(parts[e], parts[0])
            rows.append(parts[0])
    auxes = {o[1] for o in outs}
    assert len(auxes) == 1, auxes
    return np.concatenate(rows, 0), auxes.pop()


@pytest.mark.parametrize("case", EP_CASES, ids=[c[0] for c in EP_CASES])
def test_expert_parallel_matches_repro(world, repro_ep, ep_inputs, case):
    name, mesh_key, strategy, int8, cf = case
    _, tc = _cfgs(EP_ARCH, cf=cf)
    shape = MESH_SHAPES[mesh_key]
    outs = world.run(tasks.ep_forward, shape, NAMES, tc, ep_inputs["flat"],
                     ep_inputs["x"], strategy, int8)
    assert {o[3] for o in outs} == {"all_to_all_single"}
    y, aux = _assemble(outs, shape, strategy)
    want = repro_ep[name + ".y"]
    _close(aux, repro_ep[name + ".aux"])
    _close(y, want)
    if int8:      # the payload really went through int8
        step = np.abs(ep_inputs["x"]).max() / 127
        assert np.abs(y - repro_ep["a2a.y"]).max() > step / 10


def test_capacity_one_drops_entries(repro_ep, ep_inputs):
    """The dropping cases really drop: they differ from the capacity-free
    reference, and the roomy case equals it."""
    _, tc = _cfgs(EP_ARCH)
    _, _, m = _weights(EP_ARCH)
    ref, _ = tmoe.moe_forward(m, tc, torch.from_numpy(ep_inputs["x"]))
    ref = ref.numpy()
    assert np.abs(repro_ep["a2a_drop.y"] - ref).max() > 1e-2
    _close(repro_ep["a2a_roomy.y"], ref)


def test_transports_carry_the_same_bits(world):
    """The all_reduce transport (gloo with CUDA tensors) and
    all_to_all_single give the same bits, f32 and int8, equal to chunk i
    of rank r arriving at rank i in row r."""
    outs = world.run(tasks.all_to_all_both, (2, 2), NAMES, 3)
    for f_a, f_b, q_a, q_b in outs:
        np.testing.assert_array_equal(f_a, f_b)
        np.testing.assert_array_equal(q_a, q_b)
    base = np.arange(2 * 3 * 3).reshape(2, 3, 3) % 50
    for r, (f_a, _, _, _) in enumerate(outs):
        di, ei = divmod(r, 2)
        want = np.stack([base[ei] + src + 10 * di for src in range(2)])
        np.testing.assert_array_equal(f_a, want.astype(np.float32))


@pytest.mark.parametrize("strategy", ["a2a", "allgather"])
def test_lm_forward_on_a_mesh(world, repro_ep, ep_inputs, strategy):
    """``lm.forward`` with ``RunCtx.mesh``: each rank holds its experts and
    its batch slice; the logits and the aux are repro's under its mesh."""
    _, tc = _cfgs(EP_ARCH)
    outs = world.run(tasks.ep_lm_forward, (2, 2), NAMES, tc,
                     ep_inputs["lm_tree"], ep_inputs["tokens"], strategy)
    logits, aux = _assemble([(o[0], o[1], o[2], None) for o in outs],
                            (2, 2), "allgather")
    _close(logits, repro_ep[f"lm_{strategy}.y"], atol=1e-4, rtol=1e-4)
    _close(aux, repro_ep[f"lm_{strategy}.aux"])


def test_bf16_model_carries_the_f32_router():
    """``carry.lm_params`` of a bf16 MoE model: the router stays f32, the
    experts are (E, d, ff) bf16, every leaf keeps its bits."""
    jc = jscaled_down(jget_config("arctic-480b"))
    tc = scaled_down(get_config("arctic-480b"))
    params = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(4), jc))
    model = carry.lm_params(params, tc, device="cpu")
    blk = model.blocks[1].moe
    assert blk.router.dtype == torch.float32
    assert blk.w_gate.dtype == torch.bfloat16
    assert tuple(blk.w_gate.shape) == (8, 128, 128)
    assert np.array_equal(blk.router.numpy(),
                          params["blocks"]["moe"]["router"][1])
    assert np.array_equal(blk.dense.w_up.view(torch.uint16).numpy(),
                          params["blocks"]["moe"]["dense"]["w_up"][1]
                          .view(np.uint16))
