"""Guards of the PyTorch port: it stands alone, it never runs on the CPU
unless asked to, and its kernel wrappers take the plain path only for CPU
tensors — without counting a launch."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import carry, device
from repro_torch.configs import get_config, scaled_down
from repro_torch.core import engine, layout
from repro_torch.dist import steps
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import hamming as tham
from repro_torch.kernels import ops
from repro_torch.kernels import topk_select as tsel
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.runtime import server

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_k4_tiles.py",
    REPO / "chip_topk_routes.py", REPO / "chip_decode_search.py",
    REPO / "chip_op_dispatch.py", REPO / "chip_step_turns.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_scan_covers_every_module_of_the_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("configs/base.py", "kernels/flash_attention.py",
                "models/lm.py", "models/mamba2.py", "models/rwkv6.py",
                "core/retrieval.py", "runtime/server.py",
                "runtime/faults.py", "dist/steps.py", "launch/serve.py",
                "kernels/hamming.py", "core/index.py",
                "kernels/approx_select.py", "checkpoint/wal.py",
                "checkpoint/manager.py", "core/mutable.py",
                "core/tenant.py", "core/hierarchy.py", "dist/health.py",
                "dist/sharding.py", "dist/search.py", "configs/shapes.py",
                "data/pipeline.py", "optim/optimizer.py",
                "runtime/trainer.py", "launch/train.py", "launch/mesh.py",
                "launch/specs.py", "launch/op_analysis.py",
                "launch/collectives.py", "launch/roofline.py",
                "launch/dryrun.py"):
        assert f"src/repro_torch/{mod}" in names


def test_entry_points_default_to_cuda_and_raise_without_it():
    codes = np.zeros((10, 2), np.uint32)
    if torch.cuda.is_available():
        assert device.resolve().type == "cuda"
        return
    for call in (device.resolve,
                 lambda: carry.codes(codes),
                 lambda: carry.engine(codes, 64),
                 lambda: carry.layout(codes, np.arange(10), np.arange(10),
                                      np.array([0, 10])),
                 lambda: carry.kmeans_index(np.zeros((2, 4)),
                                            np.zeros((2, 5)), codes, None,
                                            64),
                 lambda: carry.lsh_index(np.zeros((2, 3)),
                                         np.zeros((2, 8, 5)), codes, None,
                                         64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert device.resolve("cpu").type == "cpu"
    assert device.default_backend() == "cpu"


def test_serving_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    cfg = scaled_down(get_config("gemma-2b"))
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tree = {"embed": {"table": np.zeros((512, 128), np.float32)}}
    for call in (lambda: carry.lm_params(tree, cfg),
                 lambda: lm.init_params(torch.Generator(), cfg),
                 lambda: lm.init_decode_state(cfg, 1, 8),
                 lambda: server.Server(cfg, model, max_batch=1, max_len=8),
                 lambda: serve.main(["--arch", "gemma-2b", "--scaled"]),
                 lambda: steps.make_prefill_step(cfg, 16,
                                                 attn_impl="flash")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_recurrent_entry_points_raise_without_a_device(arch):
    """The recurrent families' model, decode state, server, launcher and
    prefill step put their tensors on CUDA unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    cfg = scaled_down(get_config(arch))
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = lm.init_decode_state(cfg, 1, 8, device="cpu")

    def as_np(t):
        if isinstance(t, dict):
            return {k: as_np(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return type(t)(*map(as_np, t))
        return t.numpy() if t.dtype != torch.bfloat16 else t.float().numpy()

    for call in (lambda: lm.init_params(torch.Generator(), cfg),
                 lambda: lm.init_decode_state(cfg, 1, 8),
                 lambda: carry.decode_state(as_np(state)),
                 lambda: server.Server(cfg, model, max_batch=1, max_len=8),
                 lambda: serve.main(["--arch", arch, "--scaled"]),
                 lambda: steps.make_prefill_step(cfg, 16,
                                                 attn_impl="flash")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert carry.decode_state(as_np(state), device="cpu")["pos"].device == (
        torch.device("cpu"))


def test_store_entry_points_raise_without_a_device(tmp_path):
    """The mutable store, its recovery and the tenant arena put their
    epochs on CUDA unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    from repro_torch.core import mutable, tenant

    codes = np.zeros((4, 2), np.uint32)
    mutable.MutableStore.create(codes, 64, root=str(tmp_path), device="cpu")
    for call in (lambda: mutable.MutableStore.create(codes, 64),
                 lambda: mutable.MutableStore.recover(str(tmp_path)),
                 lambda: tenant.TenantArena(64),
                 lambda: tenant.TenantArena.recover(64, str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sharded_entry_points_raise_without_a_device():
    """The sharded search, its placement, the fault-tolerant search and its
    oracle, and a server shadowed by one, put their tensors on CUDA unless
    given device="cpu"; the device is resolved before the mesh is read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    from repro_torch.dist import search

    codes = np.zeros((16, 2), np.uint32)
    cfg = scaled_down(get_config("gemma-2b"))
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    fts = search.FaultTolerantSearch(codes, 64, device="cpu")
    for call in (lambda: engine.search_sharded(codes, codes[:2], 4, 64,
                                               object(), ("data",)),
                 lambda: engine.shard_datastore(codes, object(), ("data",)),
                 lambda: search.FaultTolerantSearch(codes, 64),
                 lambda: search.reference_over_covered(codes, codes[:2], 4,
                                                       64, np.arange(16)),
                 lambda: server.Server(cfg, model, max_batch=1, max_len=8,
                                       shard_search=fts)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert fts.device.type == "cpu"
    assert fts._data["unit0"][0].device.type == "cpu"


def test_training_entry_points_raise_without_a_device():
    """The trainer, its launcher and the train step put the model and the
    batches on CUDA unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import train
    from repro_torch.runtime import trainer

    cfg = scaled_down(get_config("gemma-2b"))
    tc = TrainConfig(total_steps=1, warmup_steps=0)
    steps.make_train_step(cfg, tc, device="cpu")
    for call in (lambda: trainer.train(cfg, tc, seq_len=8, global_batch=2),
                 lambda: train.main(["--arch", "gemma-2b", "--scaled",
                                     "--steps", "1"]),
                 lambda: steps.make_train_step(cfg, tc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("entry", ["kernel", "ops"])
def test_flash_attention_refuses_inputs_that_need_gradients(entry):
    """K4 is forward-only: with gradients on, an input that requires them
    raises instead of giving an output without a graph."""
    if entry == "kernel":
        shape_q, shape_kv = (1, 2, 40, 32), (1, 1, 40, 32)
        call = lambda q, k, v: tfa.flash_attention_kernel(q, k, v, bq=8,
                                                          bk=8)
    else:
        shape_q, shape_kv = (1, 40, 2, 32), (1, 40, 1, 32)
        call = lambda q, k, v: ops.flash_attention(q, k, v, bq=8, bk=8)
    q, kv = torch.randn(shape_q), torch.randn(shape_kv)
    for grads in ((q.clone().requires_grad_(), kv, kv),
                  (q, kv, kv.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="forward-only"):
            call(*grads)
        with torch.no_grad():
            assert torch.equal(call(*grads), call(q, kv, kv))
    assert not call(q, kv, kv).requires_grad
    assert tfa.flash_attention_kernel.launches == 0


def test_flash_attention_on_cpu_tensors_takes_the_plain_path():
    tfa.reset_launch_counts()
    cfg = scaled_down(get_config("gemma-2b"), dtype="float32")
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prefill = steps.make_prefill_step(cfg, 24, attn_impl="flash",
                                      device="cpu")
    logits, state = prefill(model, {"tokens": np.zeros((2, 24), np.int32)})
    q = torch.randn((1, 2, 40, 32))
    kv = torch.randn((1, 1, 40, 32))
    out = tfa.flash_attention_kernel(q, kv, kv, bq=8, bk=8)
    assert torch.equal(out, tfa.flash_attention_plain(q, kv, kv, 8, 8))
    assert logits.shape == (2, 24, 512) and state["pos"].tolist() == [24, 24]
    assert tfa.flash_attention_kernel.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_kernel(q.to("meta"), kv.to("meta"),
                                   kv.to("meta"))


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = (tsel.hamming_hist_kernel.launches,
              tsel.hamming_emit_kernel.launches,
              tham.hamming_distance_kernel.launches)
    rng = np.random.default_rng(0)
    x = carry.codes(rng.integers(0, 1 << 32, (600, 2), dtype=np.uint32), "cpu")
    q = carry.codes(rng.integers(0, 1 << 32, (8, 2), dtype=np.uint32), "cpu")
    hist, bmin = tsel.hamming_hist_kernel(q, x, 65, bq=8, bn=200)
    out = tsel.hamming_emit_kernel(q, x, torch.full((8,), 30), torch.zeros(8),
                                   65, 4, bq=8, bn=200)
    dist = tham.hamming_distance_kernel(q, x, bq=8, bn=200)
    assert torch.equal(dist, tham.hamming_distance_plain(q, x))
    eng = engine.KNNEngine(codes=x, d=64).with_layout()
    dd, ii = eng.search(q, 5)
    assert torch.equal(eng.search(q, 5, method="pallas",
                                  select="counting")[0], dd)
    assert int(hist.sum()) == 8 * 600 and bmin.shape == (1, 3)
    assert out[0].shape == (8, 4) and dd.shape == (8, 5)
    assert eng.query_plan(q, 5).select.path == "fused"
    assert (tsel.hamming_hist_kernel.launches,
            tsel.hamming_emit_kernel.launches,
            tham.hamming_distance_kernel.launches) == before == (0, 0, 0)
    assert device.backend_of(x) == "cpu"


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    q = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    x = torch.zeros((64, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsel.hamming_hist_kernel(q, x, 65, bq=8, bn=64)
    with pytest.raises(ValueError, match="tensors on"):
        tsel.hamming_hist_kernel(torch.zeros((8, 2), dtype=torch.int32), x,
                                 65, bq=8, bn=64)
    with pytest.raises(ValueError, match="unsupported device"):
        tham.hamming_distance_kernel(q, x, bq=8, bn=64)
    with pytest.raises(ValueError, match="tensors on"):
        tham.hamming_distance_kernel(torch.zeros((8, 2), dtype=torch.int32),
                                     x, bq=8, bn=64)


def test_layout_runs_on_the_codes_device():
    x = torch.zeros((300, 2), dtype=torch.int32)
    lay = layout.build_layout(x, 64)
    assert lay.codes.device == lay.perm.device == x.device
    assert ops.topk_geometry(4, 300, 2, 65, backend="gpu")[0] == 8


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path, where):
    """No CUDA card here, and a copy alone in an empty directory has no
    port to import: either way a non-zero exit and no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    elif torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the checkout run would pass")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
