"""Shared parts of the port's mesh training tests
(``test_torch_train_ep.py``, ``test_torch_train_dp.py``): ``repro``'s
side, run jitted once per case in a subprocess with 4 host devices on a
(2, 2) ("data", "model") mesh, and the comparison of the ranks' results
with it. Both packages start from ``repro``'s ``init_params`` of the
``scaled_down`` f32 kimi-k2 (8 experts, top 2, one shared expert) and
use the deterministic stream; ``repro``'s "auto" strategy takes ``a2a``
at S = 16 and ``allgather`` at S = 15 (S not a multiple of the expert
axis), and so does the port's.
"""
import numpy as np
import jax

from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.models import lm as jlm
from repro_torch import carry
from repro_torch.configs import get_config, scaled_down
from repro_torch.data import pipeline
from repro_torch.optim.optimizer import is_expert

ARCH = "kimi-k2-1t-a32b"
NAMES = ("data", "model")
SHAPE = (2, 2)
B, STEPS = 4, 2
BASE = dict(total_steps=6, warmup_steps=0)
LR = 3e-4                      # TrainConfig's default learning rate
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")

_SCRIPT = """
import warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import TrainConfig, get_config, scaled_down
from repro.dist import steps
from repro.models import lm, moe
from repro.optim import optimizer
warnings.simplefilter("ignore")
inp = np.load({inp!r})
params = {{}}
for key in inp.files:
    if key.startswith("p."):
        node, parts = params, key[2:].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = jnp.asarray(inp[key])
mesh = compat.make_mesh((2, 2), ("data", "model"))
cfg = scaled_down(get_config({arch!r}), dtype="float32")
out = {{}}
def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + ".")
        else:
            out[prefix + k] = np.asarray(v)
def batch(name, s):
    return {{k: jnp.asarray(inp[name + ".b%d." % s + k])
            for k in ("tokens", "labels")}}
for name, seq, pure, int8, over in {steps_cases!r}:
    kw = dict({base!r}); kw.update(over)
    tc = TrainConfig(**kw)
    step, _, _ = steps.make_train_step(cfg, mesh, tc, pure_dp=pure,
                                       moe_a2a_int8=int8, donate=False)
    p, o = params, optimizer.init(params, tc)
    for s in range({n_steps}):
        with mesh:
            p, o, m = step(p, o, batch(name, s), jnp.asarray(s))
        for k in {metrics!r}:
            out[name + ".m%d.%s" % (s, k)] = np.asarray(m[k])
    flat(p, name + ".p.")
for name, seq, pure, int8 in {grad_cases!r}:
    ctx = lm.RunCtx(mesh=None if pure else mesh, dp_axes=("data",),
                    moe_a2a_int8=int8)
    f = jax.jit(jax.value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b, ctx),
                                   has_aux=True))
    with mesh:
        (l, aux), g = f(params, batch(name, 0))
    out[name + ".loss"] = np.asarray(l)
    flat(g, name + ".g.")
if {with_dispatch!r}:
    # the int8 dispatch's gradient: each device's (n, C, d) send buffer
    x, ct = jnp.asarray(inp["q.x"]), jnp.asarray(inp["q.ct"])
    def dispatch(xx):
        return compat.shard_map(
            lambda v: moe._a2a_quantized(v[0], "model", True)[None],
            mesh=mesh, in_specs=P(("data", "model")),
            out_specs=P(("data", "model")))(xx)
    y, vjp = jax.vjp(jax.jit(dispatch), x)
    out["q.y"], out["q.grad"] = np.asarray(y), np.asarray(vjp(ct)[0])
np.savez({out_path!r}, **out)
print("OK")
"""


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(res, prefix):
    tree = {}
    for key, v in res.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def batches(seq_len):
    dc = pipeline.DataConfig(vocab_size=512, seq_len=seq_len, global_batch=B)
    return [pipeline.make_batch(dc, s) for s in range(STEPS)]


def env():
    """(port config, ``repro``'s params as numpy)."""
    jc = jscaled_down(jget_config(ARCH), dtype="float32")
    tc = scaled_down(get_config(ARCH), dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(7), jc))
    return tc, tree


def run_repro(multidevice, tmp, tree, steps_cases, grad_cases,
              dispatch=None):
    """``repro``'s train steps (``steps_cases``: name, seq_len, pure_dp,
    a2a_int8, TrainConfig overrides) and loss gradients on the first
    batch (``grad_cases``: name, seq_len, pure_dp, a2a_int8), and with
    ``dispatch`` = (x, ct) the int8 dispatch's output and gradient."""
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    arrays = {f"p.{k}": v for k, v in flat(tree).items()}
    for name, seq, *_ in list(steps_cases) + list(grad_cases):
        for s, b in enumerate(batches(seq)):
            arrays.update({f"{name}.b{s}.{k}": v for k, v in b.items()})
    if dispatch is not None:
        arrays["q.x"], arrays["q.ct"] = dispatch
    np.savez(inp, **arrays)
    multidevice(_SCRIPT.format(
        inp=inp, out_path=out, arch=ARCH, steps_cases=list(steps_cases),
        grad_cases=list(grad_cases), base=BASE, n_steps=STEPS,
        metrics=METRICS, with_dispatch=dispatch is not None), n_devices=4)
    res = np.load(out)
    return {k: res[k] for k in res.files}


def whole(outs, split_experts: bool):
    """The ranks' (tree, coords) -> the whole model's tree: the experts
    concatenated in expert-rank order (equal over the data axis) when
    they were split, every other leaf equal on every rank."""
    by = {coords: tree for tree, coords in outs}
    merged = {}
    for name in by[(0, 0)]:
        if is_expert(name) and split_experts:
            parts = [np.concatenate([by[(d, e)][name] for e in range(2)])
                     for d in range(2)]
        else:
            parts = [by[c][name] for c in sorted(by)]
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0], err_msg=name)
        merged[name] = parts[0]
    return merged


def reference(res, prefix, cfg):
    """``repro``'s tree under ``prefix`` keyed like the port's model."""
    return carry._flat_lm_tree(unflat(res, prefix), cfg.num_layers)


def check_steps(outs, repro_run, name, cfg, split, int8=False, ef=False):
    """The ranks' (params, metrics, coords) of ``STEPS`` steps against
    ``repro``'s (``test_torch_train_ep.py``'s docstring states the
    tolerances)."""
    mtol = 1e-4 if int8 else 1e-5
    for s in range(STEPS):
        for k in METRICS:
            got = {o[1][s][k] for o in outs}
            assert len(got) == 1, (s, k, got)
            want = float(repro_run[f"{name}.m{s}.{k}"])
            assert abs(got.pop() - want) <= mtol * max(1.0, abs(want)), (
                s, k, want)
    params = whole([(o[0], o[2]) for o in outs], split)
    ref = reference(repro_run, f"{name}.p.", cfg)
    assert set(params) == set(ref)
    diffs = {k: np.abs(v - ref[k]) for k, v in params.items()}
    if int8 or ef:
        n = sum(d.size for d in diffs.values())
        cut, share = (2e-5, 1e-3) if int8 else (1e-6, 1e-4)
        off = sum(int((d > cut).sum()) for d in diffs.values())
        assert max(float(d.max()) for d in diffs.values()) <= LR
        assert off <= share * n, (off, n)
        return
    worst = max((float(d.max()), k) for k, d in diffs.items())
    assert worst[0] <= 2e-5, worst


def check_grads(outs, repro_run, name, cfg, split):
    losses = {o[1] for o in outs}
    assert len(losses) == 1
    assert abs(losses.pop() - float(repro_run[f"{name}.loss"])) < 1e-5
    grads = whole([(o[0], o[2]) for o in outs], split)
    ref = reference(repro_run, f"{name}.g.", cfg)
    assert set(grads) == set(ref)
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref[k], rtol=0,
                                   atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)
