"""PyTorch port vs the JAX reference: training an MoE model with expert
parallelism — ``dist/steps.make_train_step(cfg, tc, mesh=...)`` under
the ``a2a`` and ``allgather`` strategies and the int8 dispatch, its
gradients (``steps.make_grad_fn``) and the int8 dispatch's backward.

``repro`` runs once, jitted, in a subprocess with 4 host devices
(``_torch_train_mesh.py`` says what runs there); the port on a world of
4 gloo ranks on the CPU (``_torch_world.World``; rank tasks in
``_torch_train_tasks.py``), each rank with its experts
(``carry.expert_shard``) and its slice of each global batch
(``steps.shard_batch``), on a (2, 2) ("data", "model") mesh.

Tolerances:
* the loss gradients: each leaf within 1e-5 of its largest entry, the
  loss within 1e-5;
* two train steps: the per-step loss, ce, aux and lr within 1e-5 and the
  grad norm within 1e-5 of itself, equal on every rank; every parameter
  within 2e-5. Adam moves an entry by about the learning rate (3e-4)
  whatever the size of its gradient, so where a gradient is near zero
  an f32 difference in it shows at that scale (the gradients themselves
  are held above);
* the int8 dispatch: ``x / scale`` is rounded to codes, and where the
  two packages' activations differ in the last f32 bit at a rounding tie
  one code differs by one step: the metrics within 1e-4, no parameter
  further than the learning rate, at most 1e-3 of them beyond 2e-5;
* the dispatch's own output within 1e-6, its gradient within 1e-5.
"""
import numpy as np
import pytest

import _torch_train_mesh as tm
import _torch_train_tasks as tasks
from _torch_world import World

# name, seq_len, pure_dp, a2a_int8, TrainConfig overrides
STEP_CASES = [("a2a", 16, False, False, {}),
              ("allgather", 15, False, False, {}),
              ("a2a_int8", 16, False, True, {})]
GRAD_CASES = [("g_a2a", 16, False, False),
              ("g_allgather", 15, False, False)]


@pytest.fixture(scope="module")
def env():
    tc, tree = tm.env()
    rng = np.random.default_rng(8)
    q = tuple(rng.standard_normal((4, 2, 8, 128)).astype(np.float32)
              for _ in range(2))
    return tc, tree, q


@pytest.fixture(scope="module")
def repro_run(multidevice, tmp_path_factory, env):
    _, tree, q = env
    return tm.run_repro(multidevice, tmp_path_factory.mktemp("train_ep"),
                        tree, STEP_CASES, GRAD_CASES, dispatch=q)


@pytest.fixture(scope="module")
def world():
    with World(4) as w:
        yield w


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_train_steps_match_repro(world, repro_run, env, case):
    name, seq, pure_dp, int8, over = case
    tc, tree, _ = env
    outs = world.run(tasks.ep_train, tm.SHAPE, tm.NAMES, tc, tree,
                     dict(tm.BASE, **over), tm.batches(seq), pure_dp, int8)
    tm.check_steps(outs, repro_run, name, tc, split=True, int8=int8)


@pytest.mark.parametrize("int8", [False, True])
def test_all_reduce_transport_trains_alike(world, env, int8):
    """The transport gloo takes with CUDA tensors (an ``all_reduce`` of a
    zeroed buffer, forced here on CPU tensors) carries the forward and
    the backward exchanges with the same bits as ``all_to_all_single``:
    the two steps end on the same weights."""
    tc, tree, _ = env
    args = (tm.SHAPE, tm.NAMES, tc, tree, dict(tm.BASE), tm.batches(16),
            False, int8)
    a = world.run(tasks.ep_train, *args)
    b = world.run(tasks.ep_train, *args, "all_reduce")
    for (pa, ma, ca), (pb, mb, cb) in zip(a, b):
        assert ca == cb and ma == mb
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_repro(world, repro_run, env, case):
    """The transposes of the collectives: the router's and the shared
    expert's gradients sum over the expert axis, the experts' stay on
    their rank, the replicated layers' agree on every rank."""
    name, seq, pure_dp, int8 = case
    tc, tree, _ = env
    outs = world.run(tasks.ep_grads, tm.SHAPE, tm.NAMES, tc, tree,
                     tm.batches(seq)[0], pure_dp, int8)
    tm.check_grads(outs, repro_run, name, tc, split=True)


def test_int8_dispatch_gradient_is_repros(world, repro_run, env):
    """``jax.vjp`` through ``repro``'s int8 dispatch under ``shard_map``:
    the int8 codes carry no gradient, so it reaches x through the
    per-slot scale alone, at each slot's max |x|. The port's backward
    gives the same, not a straight-through estimate."""
    q_x, q_ct = env[2]
    outs = world.run(tasks.int8_dispatch_grad, tm.SHAPE, tm.NAMES, q_x, q_ct)
    assert sorted(o[2] for o in outs) == [0, 1, 2, 3]
    for y, grad, f in outs:
        np.testing.assert_allclose(y, repro_run["q.y"][f], rtol=0, atol=1e-6)
        want = repro_run["q.grad"][f]
        np.testing.assert_allclose(grad, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        # one nonzero entry per slot: the argmax of |x| over d
        assert ((grad != 0).sum(-1) == 1).all()
        assert (np.abs(grad).argmax(-1) == np.abs(q_x[f]).argmax(-1)).all()
