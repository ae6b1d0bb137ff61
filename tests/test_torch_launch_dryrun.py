"""The port's dry run in fake worlds (no card, no peers): the meshes and
their refusals, ``run_cell`` on a (2, 2, 2) world for ``repro``'s three
smoke cells (``tests/test_dryrun_smoke.py``) at ``scaled_down`` widths,
the collectives an expert-parallel MoE train step issues against what
``steps._mean_over`` and the all-to-all exchanges send (computed from the
model's leaves), and ``launch/train.py``'s ``--multi-pod`` mesh."""
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (ShapeConfig, StepKind, get_config,
                                 scaled_down)
from repro_torch.launch import dryrun, mesh as tmesh, op_analysis
from repro_torch.launch import train as tlaunch

SMOKE = [("gemma-2b", "train_4k"), ("rwkv6-1.6b", "long_500k"),
         ("musicgen-medium", "decode_32k")]


def test_fake_world_refuses_a_second_group_and_leaves_none():
    with tmesh.fake_world(8, rank=3):
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
        with pytest.raises(RuntimeError, match="already initialized"):
            with tmesh.fake_world(4):
                pass
        with pytest.raises(ValueError, match="world has 8"):
            tmesh.make_production_mesh()
        mesh = tmesh.make_host_mesh((2, 2, 2))
        assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_meshes_and_the_launchers_mesh(multi_pod, shape, axes):
    n = 512 if multi_pod else 256
    with tmesh.fake_world(n):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
        got = tlaunch.launch_mesh(multi_pod)
        assert tuple(got.shape) == shape
    other = 256 if multi_pod else 512
    with tmesh.fake_world(other):
        with pytest.raises(ValueError, match=f"world has {other}"):
            tlaunch.launch_mesh(multi_pod)
    assert tlaunch.launch_mesh(False) is None        # one process, one card
    with pytest.raises(ValueError, match="world of 1"):
        tlaunch.launch_mesh(True)


@pytest.mark.parametrize("arch,shape", SMOKE, ids=lambda c: str(c))
def test_run_cell_on_a_host_mesh(arch, shape):
    with tmesh.fake_world(8):
        mesh = tmesh.make_host_mesh((2, 2, 2))
        rec = dryrun.run_cell(arch, shape, mesh=mesh,
                              cfg=scaled_down(get_config(arch)))
    assert rec["flops_per_device"] > 0 and rec["chips"] == 8
    assert rec["dominant"] in ("compute", "memory", "collective")
    terms = {k: rec[k + "_s"] for k in ("compute", "memory", "collective")}
    assert rec["step_time_bound_s"] == max(terms.values())
    assert rec["dominant"] == max(terms, key=terms.get)
    mem = rec["memory_stats"]
    assert mem["per_device_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0 and mem["fits_hbm"] is True
    if shape == "train_4k":
        # 256 rows over all 8 ranks, gradients averaged over them
        assert (rec["rows_per_rank"], rec["batch_axes"]) == (
            32, ["pod", "data", "model"])
        assert rec["collective_counts"]["all_reduce"] > 0
        # below 1 by the remat recompute and the rectangular attention
        # schedule's masked half, not by repeated rows
        assert 0.25 < rec["useful_ratio"] < 1
    elif shape == "long_500k":
        # one row: every rank runs it, 1/8 of their work useful
        assert (rec["rows_per_rank"], rec["batch_axes"]) == (1, [])
        assert rec["collective_bytes_per_device"] == 0
    else:
        assert (rec["rows_per_rank"], rec["batch_axes"]) == (
            32, ["pod", "data"])


def test_moe_train_step_issues_mean_over_and_the_a2a_exchanges():
    """arctic's MoE, experts split over "model" (2 ranks) and the batch
    over ("pod", "data"): per layer the a2a dispatch (tokens and their
    expert ids), the return, their recomputation under remat and the two
    backward exchanges; ``_mean_over``'s one all_reduce per dtype and
    data axis of the gradients, and the loss pair's."""
    cfg = scaled_down(get_config("arctic-480b"))
    B, S = 8, 64
    shape = ShapeConfig("cell", seq_len=S, global_batch=B,
                        step=StepKind.TRAIN)
    with tmesh.fake_world(8):
        mesh = tmesh.make_host_mesh((2, 2, 2))
        fn, args, rows, used = dryrun.build_step(cfg, shape, mesh,
                                                 device="meta")
        _, counts = op_analysis.trace_step(fn, args)
    model = args[0]
    n, axes = 2, ("pod", "data")
    assert (rows, used) == (B // 4, axes)
    moe, d, L = cfg.moe, cfg.d_model, cfg.num_layers
    t_loc = rows * S // n                         # a rank's a2a chunk
    c_send = -(-max(1, int(moe.capacity_factor * t_loc
                           * moe.experts_per_token / n)) // 8) * 8
    x_bytes = n * c_send * d * 2                  # bf16 tokens
    eid_bytes = n * c_send * 4                    # int32 expert ids
    want_a2a = L * (6 * x_bytes + 2 * eid_bytes)
    by_dtype = {}
    for p in model.parameters():
        by_dtype[p.dtype] = by_dtype.get(p.dtype, 0) + p.numel() * p.element_size()
    router = model.blocks[0].moe.router
    mean_over = len(axes) * (sum(by_dtype.values()) + 2 * 4)
    per_layer = (3 * rows * S * d * 2             # ep_gather fwd, recompute,
                 + 9 * 4                          # ep_chunk bwd; aux psums
                 + router.numel() * 4)            # the router's gradient
    got_b, got_c = counts.coll.coll_bytes(), counts.coll.coll_counts()
    assert got_c["all_to_all"] == 8 * L and got_b["all_to_all"] == want_a2a
    assert got_b["all_reduce"] == L * per_layer + mean_over + 4
    assert got_c["all_reduce"] == (L * 13 + len(axes) * (len(by_dtype) + 1)
                                   + 1)
    assert got_b["total"] == want_a2a + got_b["all_reduce"]


def test_decode_cells_count_no_collective_and_flash_needs_cuda():
    cfg = scaled_down(get_config("gemma-2b"))
    with tmesh.fake_world(8):
        mesh = tmesh.make_host_mesh((2, 2, 2))
        rec = dryrun.run_cell("gemma-2b", "decode_32k", mesh=mesh, cfg=cfg)
        assert rec["collective_counts"] == {}
        if not torch.backends.cuda.is_built():
            with pytest.raises(RuntimeError, match="torch has CUDA"):
                dryrun.run_cell("gemma-2b", "prefill_32k", mesh=mesh,
                                cfg=cfg, attn_impl="flash")
