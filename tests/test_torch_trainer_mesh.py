"""The fault-tolerant trainer on a mesh (``runtime/trainer.train(...,
mesh=)``): 4 gloo ranks on the CPU (``_torch_world.World``) training the
``scaled_down`` f32 kimi-k2 with expert parallelism on a (2, 2)
("data", "model") mesh. A checkpoint holds the single-device tree (the
experts gathered in rank order), so it resumes on one device and the
reverse, bit for bit; a preempted mesh run resumes on the mesh to the
uninterrupted run's weights, bit for bit (gloo's sums on the CPU are
the same run to run).
"""
import numpy as np
import pytest

import _torch_train_mesh as tm
import _torch_train_tasks as tasks
from _torch_world import World
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import TrainConfig
from repro_torch.runtime import trainer

TC = dict(total_steps=4, warmup_steps=0, learning_rate=1e-2)


@pytest.fixture(scope="module")
def world():
    with World(4) as w:
        yield w


@pytest.fixture(scope="module")
def cfg():
    return tm.env()[0]


def _whole(outs, i):
    return tm.whole([(o[0][i], o[1]) for o in outs], split_experts=True)


def _one_device(cfg, root, total):
    return trainer.train(cfg, TrainConfig(**dict(TC, total_steps=total)),
                         seq_len=16, global_batch=4, device="cpu",
                         ckpt_dir=root, ckpt_every=2, log_every=0)


def test_mesh_checkpoint_resumes_on_one_device(world, cfg, tmp_path):
    root = str(tmp_path / "run")
    kw = dict(TC, total_steps=2)
    outs = world.run(tasks.mesh_trainer, tm.SHAPE, tm.NAMES, cfg, kw, root)
    assert {o[3] for o in outs} == {2}
    assert ckpt.committed_steps(root) == [2]
    params, mu = _whole(outs, 0), _whole(outs, 1)
    # resumed with nothing left to do: the restored trees, bit for bit
    rep = _one_device(cfg, root, total=2)
    assert rep.resumed_from == 2 and rep.steps_done == 0
    for n, p in rep.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[n], n)
        np.testing.assert_array_equal(rep.opt_state.mu[n].numpy(), mu[n], n)
    assert int(rep.opt_state.count) == 2
    rep = _one_device(cfg, root, total=3)
    assert rep.resumed_from == 2 and rep.steps_done == 1
    assert np.isfinite(rep.final_loss)


def test_one_device_checkpoint_resumes_on_the_mesh(world, cfg, tmp_path):
    root = str(tmp_path / "run")
    full = _one_device(cfg, root, total=2)
    outs = world.run(tasks.mesh_trainer, tm.SHAPE, tm.NAMES, cfg, TC, root,
                     None)
    assert {o[2] for o in outs} == {2} and {o[3] for o in outs} == {2}
    assert len({o[4] for o in outs}) == 1
    # the restored shards are the one-device tree's, bit for bit
    root2 = str(tmp_path / "again")
    _one_device(cfg, root2, total=2)
    outs = world.run(tasks.mesh_trainer, tm.SHAPE, tm.NAMES, cfg,
                     dict(TC, total_steps=2), root2, None)
    params = _whole(outs, 0)
    for n, p in full.model.named_parameters():
        np.testing.assert_array_equal(params[n], p.detach().numpy(), n)


def test_preempted_mesh_run_resumes_to_the_uninterrupted_weights(
        world, cfg, tmp_path):
    full = world.run(tasks.mesh_trainer, tm.SHAPE, tm.NAMES, cfg, TC,
                     str(tmp_path / "full"), None)
    root = str(tmp_path / "run")
    cut = world.run(tasks.mesh_trainer, tm.SHAPE, tm.NAMES, cfg, TC, root, 3)
    assert {o[0] for o in cut} == {"preempted"}
    assert ckpt.latest_step(root) == 3
    again = world.run(tasks.mesh_trainer, tm.SHAPE, tm.NAMES, cfg, TC, root,
                      None)
    assert {o[2] for o in again} == {3} and {o[3] for o in again} == {1}
    assert [o[4] for o in again] == [o[4] for o in full]
    a, b = _whole(again, 0), _whole(full, 0)
    for n in b:
        np.testing.assert_array_equal(a[n], b[n], n)
