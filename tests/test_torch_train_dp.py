"""PyTorch port vs the JAX reference: training an MoE model on a mesh
without expert parallelism (``pure_dp``: every rank holds the whole
model, runs ``moe_reference`` and a slice of the batch over every axis,
and the router's load-balancing statistics are summed over the mesh, as
``repro``'s ``RunCtx(mesh=None)`` computes them on its global arrays),
and int8_ef compression with microbatches over split experts (each
expert leaf's scale the max over the whole leaf).

Set-up and tolerances as in ``test_torch_train_ep.py``
(``_torch_train_mesh.check_steps`` / ``check_grads``); int8_ef is held
as on one device (``test_torch_train.py``): no parameter further than
the learning rate, at most 1e-4 of them beyond 1e-6.
"""
import pytest

import _torch_train_mesh as tm
import _torch_train_tasks as tasks
from _torch_world import World

# name, seq_len, pure_dp, a2a_int8, TrainConfig overrides
STEP_CASES = [("pure_dp", 16, True, False, {}),
              ("a2a_ef_micro", 16, False, False,
               dict(grad_compression="int8_ef", microbatches=2))]
GRAD_CASES = [("g_pure_dp", 16, True, False)]


@pytest.fixture(scope="module")
def env():
    return tm.env()


@pytest.fixture(scope="module")
def repro_run(multidevice, tmp_path_factory, env):
    return tm.run_repro(multidevice, tmp_path_factory.mktemp("train_dp"),
                        env[1], STEP_CASES, GRAD_CASES)


@pytest.fixture(scope="module")
def world():
    with World(4) as w:
        yield w


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_train_steps_match_repro(world, repro_run, env, case):
    name, seq, pure_dp, int8, over = case
    tc, tree = env
    outs = world.run(tasks.ep_train, tm.SHAPE, tm.NAMES, tc, tree,
                     dict(tm.BASE, **over), tm.batches(seq), pure_dp, int8)
    tm.check_steps(outs, repro_run, name, tc, split=not pure_dp,
                ef="grad_compression" in over)


def test_expert_axis_of_one_trains_as_pure_dp(world, repro_run, env):
    """On a (4, 1) mesh the experts stay whole (an expert axis of one
    splits nothing): every rank holds its own slice of the batch and the
    aux is the global batch's, as ``repro`` computes on that mesh and on
    ``pure_dp``'s (2, 2)."""
    tc, tree = env
    outs = world.run(tasks.ep_train, (4, 1), tm.NAMES, tc, tree,
                     dict(tm.BASE), tm.batches(16), False, False)
    assert sorted(o[2] for o in outs) == [(d, 0) for d in range(4)]
    tm.check_steps(outs, repro_run, "pure_dp", tc, split=False)


def test_pure_dp_gradients_match_repro(world, repro_run, env):
    """Every rank's gradients are the global batch's, the aux loss's
    through the summed router statistics among them."""
    tc, tree = env
    outs = world.run(tasks.ep_grads, tm.SHAPE, tm.NAMES, tc, tree,
                     tm.batches(16)[0], True, False)
    tm.check_grads(outs, repro_run, "g_pure_dp", tc, split=False)


def test_batch_axes_and_shards():
    """Under expert parallelism the ranks of the expert axis share a batch
    slice; with ``pure_dp`` (or a family without experts) every rank
    has its own. A microbatch holds on each rank the rows ``repro``'s
    sharded step gives that device."""
    import numpy as np
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.configs import TrainConfig
    from repro_torch.dist import steps

    class Mesh:          # the two calls shard_batch makes of a DeviceMesh
        mesh_dim_names = tm.NAMES

        def __init__(self, coords):
            self.coords = dict(zip(tm.NAMES, coords))

        def size(self, dim=None):
            return 2

        def get_local_rank(self, a):
            return self.coords[a]

    moe_cfg = scaled_down(get_config(tm.ARCH))
    dense = scaled_down(get_config("gemma-2b"))
    m = Mesh((1, 0))
    assert steps.batch_axes(moe_cfg, m) == ("data",)
    assert steps.batch_axes(moe_cfg, m, pure_dp=True) == tm.NAMES
    assert steps.batch_axes(dense, m) == tm.NAMES
    rows = np.arange(8)[:, None]
    tc = TrainConfig(microbatches=2)
    got = steps.shard_batch({"tokens": rows}, moe_cfg, tc, m)["tokens"]
    assert got[:, 0].tolist() == [2, 3, 6, 7]
    got = steps.shard_batch({"tokens": rows}, moe_cfg, tc, Mesh((1, 1)),
                            pure_dp=True)["tokens"]
    assert got[:, 0].tolist() == [3, 7]
    with pytest.raises(ValueError, match="does not split"):
        steps.shard_batch({"tokens": rows[:6]}, moe_cfg, tc, m)
