"""PyTorch port vs the JAX reference: the checkpoint manager
(``repro_torch.checkpoint.manager``).

The on-disk layout is ``repro``'s (``step_*/proc_<i>.npz``,
``meta.json``, ``COMMITTED``, ``.tmp*`` dirs), and trees flatten in JAX's
order for the same structure, so a checkpoint written by either package
restores in the other: a ``DataStore`` saved by ``repro`` comes back as
the port's (uint32 codes into int32 tensors, same bits) and back. Atomic
commit, async-save failures, verification and garbage collection behave
as the reference's tests pin them."""
import json
import os

import numpy as np
import jax
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.core import layout as jlay
from repro.core import retrieval as jret
from repro_torch import carry
from repro_torch.checkpoint import manager as tman


@pytest.fixture(scope="module")
def stores():
    jc = jscaled_down(jget_config("gemma-2b"))
    js = jret.synthetic_datastore(jc, n=300)
    js = js._replace(layout=jlay.build_layout(js.codes,
                                              jc.retrieval.code_bits,
                                              n_buckets=8))
    ts = carry.datastore(jax.tree_util.tree_map(np.asarray, js),
                         device="cpu")
    return js, ts


def _same(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl, _ = tman.tree_flatten(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_flatten_order_is_jax_order():
    tree = {"z": (np.zeros(1), None, [np.ones(2), {"b": np.full(1, 3),
                                                   "a": np.full(1, 4)}]),
            "a": None, "m": np.arange(3)}
    jl, _ = jax.tree_util.tree_flatten(tree)
    tl, st = tman.tree_flatten(tree)
    assert [np.asarray(x).tolist() for x in jl] == [x.tolist() for x in tl]
    back = tman.tree_unflatten(st, tl)
    assert back["a"] is None and back["z"][1] is None
    assert back["z"][2][1]["a"].tolist() == [4]
    assert tman.describe(tree) == (
        "{'a': None, 'm': *, 'z': (*, None, [*, {'a': *, 'b': *}])}")


def test_datastore_saved_by_repro_restores_in_the_port_and_back(tmp_path,
                                                                stores):
    js, ts = stores
    root = str(tmp_path)
    jman.save(root, 3, js)
    step, back = tman.restore_latest(root, ts)
    assert step == 3
    _same(js, back)
    assert back.codes.dtype == torch.int32
    assert back.layout.perm.dtype == torch.int32
    tman.save(root, 5, ts)
    meta = json.load(open(os.path.join(root, "step_00000005", "meta.json")))
    assert meta["treedef"].startswith("DataStore(*, *, ITQParams(")
    assert meta["n_leaves"] == 9
    step, jback = jman.restore_latest(root, js)
    assert step == 5
    _same(jback, ts)
    assert np.asarray(jback.codes).dtype == np.uint32


def test_bfloat16_leaves_round_trip_across_packages(tmp_path):
    import ml_dtypes

    a = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    jtree = {"w": a.astype(ml_dtypes.bfloat16), "n": np.int32(7)}
    ttree = {"w": torch.from_numpy(a).to(torch.bfloat16),
             "n": torch.tensor(7, dtype=torch.int32)}
    jman.save(str(tmp_path / "j"), 1, jtree)
    tman.save(str(tmp_path / "t"), 1, ttree)
    _, got = tman.restore_latest(str(tmp_path / "j"), ttree)
    assert torch.equal(got["w"], ttree["w"]) and int(got["n"]) == 7
    _, jgot = jman.restore_latest(str(tmp_path / "t"), jtree)
    assert np.array_equal(np.asarray(jgot["w"]).view(np.uint16),
                          jtree["w"].view(np.uint16))


def test_kill_mid_write_and_async_failure(tmp_path, stores):
    _, ts = stores
    root = str(tmp_path)
    tman.save(root, 1, ts)

    def boom():
        raise RuntimeError("killed")

    with pytest.raises(RuntimeError):
        tman.save(root, 2, ts, fault_hook=boom)
    assert tman.committed_steps(root) == jman.committed_steps(root) == [1]
    assert any(".tmp" in n for n in os.listdir(root))
    h = tman.save(root, 3, ts, blocking=False, fault_hook=boom)
    with pytest.raises(RuntimeError, match="killed"):
        h.result()
    h = tman.save(root, 4, ts, blocking=False)
    h.join()
    assert h.done() and tman.latest_step(root) == 4
    tman.garbage_collect(root, keep=1)
    assert sorted(os.listdir(root)) == ["step_00000004"]


def test_corrupt_steps_fall_back_like_the_reference(tmp_path, stores):
    js, ts = stores
    root = str(tmp_path)
    tman.save(root, 1, ts)
    jman.save(root, 2, js)
    npz = os.path.join(root, "step_00000002", "proc_0.npz")
    with open(npz, "r+b") as f:
        f.truncate(100)
    with pytest.raises(tman.CheckpointCorrupt):
        tman.restore(root, 2, ts)
    step, back = tman.restore_latest(root, ts)
    assert step == 1 == jman.restore_latest(root, js)[0]
    _same(js, back)
    tman.save(root, 3, ts)
    with open(os.path.join(root, "step_00000003", "meta.json"), "w") as f:
        f.write("{")
    step, leaves = tman.restore_latest_arrays(root)
    jstep, jleaves = jman.restore_latest_arrays(root)
    assert step == jstep == 1
    assert all(np.array_equal(a, b) for a, b in zip(leaves, jleaves))
    with pytest.raises(tman.CheckpointCorrupt, match="leaves saved"):
        tman.restore(root, 1, {"only": ts.codes})
    with pytest.raises(FileNotFoundError):
        tman.restore(root, 9, ts)
