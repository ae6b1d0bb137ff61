"""Multi-pod dry run: trace every (arch x shape x mesh) cell as one rank of
the production mesh, with no card, and derive per-device memory, FLOPs,
HBM and collective bytes and the roofline terms (port of
``repro.launch.dryrun``).

``repro`` lowers and compiles each cell for 256 / 512 placeholder TPU
devices. The port runs in a fake world of the mesh's size as rank 0
(``mesh.fake_world``: collectives move nothing) and runs the rank's step
once under ``FakeTensorMode`` (no memory, no kernel) with three counters
on it: ``op_analysis`` (FLOPs and bytes under ``repro``'s cost model),
``collectives`` (the c10d operators the rank issues) and ``PeakMemory``
(the peak of live tensor storage, arguments included).

What a rank runs:
  * train — ``steps.make_train_step(cfg, tc, mesh=)`` on its rows of the
    global batch over ``steps.batch_axes`` (its experts,
    ``carry.expert_shard``, under expert parallelism);
  * prefill / decode — ``make_prefill_step`` / ``make_serve_step`` (which
    take no mesh) on its rows over the data axes (every axis but
    "model"), with the whole model, as ``repro``'s replicated
    ``param_specs`` hold it.
A batch of B rows takes the longest leading run of those axes whose size
n divides B (times the microbatches, for train): a rank runs B / n rows,
and the ranks of the axes left over repeat its work. ``repro``'s jitted
steps take their batch replicated and its analysis divides the global
count by the chip count; the port traces what a rank runs, so
``useful_ratio`` shows the repeated work (the "model" axis of a dense
prefill, prefill_32k's 32 rows over 32 data ranks of the multi-pod
mesh, long_500k's one row everywhere).

Fake CUDA tensors stand for the card's. A torch built without CUDA can
make them but not index them or take their gradients (both ask for the
CUDA device guard), so there the dry run traces ``meta`` tensors (no
memory either, and the same operators, with less overhead than fake
ones). The kernel wrappers take CPU and CUDA tensors only; the default
cells run no kernel (blockwise attention, the composite retrieval
select), and ``--attn-impl flash`` (K4) is refused without CUDA.

Usage (no card needed; ``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import carry
from repro_torch.configs import (ALL_ARCHS, SHAPES, StepKind, TrainConfig,
                                 get_config, get_shape, runnable_cells)
from repro_torch.dist import steps as steps_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch.specs import input_specs
from repro_torch.optim import optimizer


class PeakMemory(TorchDispatchMode):
    """The peak bytes of live tensor storage while a step runs, the
    storages of its arguments counted from the start; each storage once,
    however many views share it, and gone when its last tensor is."""

    def __init__(self, tensors=()):
        super().__init__()
        self.now = self.peak = 0
        self._live: dict = {}
        for t in tensors:
            self._add(t)
        self.argument_bytes = self.now

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = n = st.nbytes()
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self.now -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def tensors_of(obj) -> list:
    """Every tensor an argument holds (a module's parameters and buffers,
    NamedTuples, dicts, lists)."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    return []


def rank_rows(batch: int, mesh, axes, micro: int = 1):
    """(rows a rank runs, the axes its batch splits over): the longest
    leading run of ``axes`` whose size divides ``batch / micro``; the
    whole batch without a mesh."""
    n, used = 1, ()
    for a in (axes if mesh is not None else ()):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        if batch % (micro * n * size):
            break
        n, used = n * size, used + (a,)
    return batch // n, used


def trace_device(attn_impl: str = "xla") -> str:
    """Fake CUDA tensors where torch has CUDA, else meta tensors, which
    the kernel wrappers refuse (module docstring)."""
    if torch.backends.cuda.is_built():
        return "cuda"
    if attn_impl == "flash":
        raise RuntimeError("attn_impl='flash' traces K4's operator on fake "
                           "CUDA tensors, which a torch built without CUDA "
                           "cannot index; run it where torch has CUDA")
    return "meta"


def stand_ins(device: str):
    """The context the step's stand-ins are made and run under: a
    ``FakeTensorMode`` for fake CUDA tensors; meta tensors need none."""
    if device == "meta":
        return contextlib.nullcontext()
    return FakeTensorMode(allow_non_fake_inputs=True)


def _cell_cfg(cfg, exact_retrieval: bool, datastore_scale: float):
    if exact_retrieval and cfg.retrieval.enabled:
        cfg = dataclasses.replace(cfg, retrieval=dataclasses.replace(
            cfg.retrieval, local_k=cfg.retrieval.k))
    if datastore_scale != 1.0 and cfg.retrieval.enabled:
        cfg = dataclasses.replace(cfg, retrieval=dataclasses.replace(
            cfg.retrieval,
            datastore_size=int(cfg.retrieval.datastore_size * datastore_scale)))
    return cfg


def build_step(cfg, shape, mesh, *, causal_skip=False, zero1=True,
               grad_compression="none", attn_chunk=1024, attn_p_bf16=False,
               microbatches=1, opt_int8=False, exact_retrieval=False,
               pure_dp=False, a2a_int8=False, datastore_scale=1.0,
               attn_impl="xla", device="cuda"):
    """Returns (step fn, its args for this rank, rows, batch axes used)
    for this cell on ``mesh`` (None: one card); call it inside a
    ``FakeTensorMode`` for fake CUDA tensors (the args are
    ``specs.input_specs`` on ``device``, allocated nowhere)."""
    cfg = _cell_cfg(cfg, exact_retrieval, datastore_scale)
    tc = TrainConfig(zero1=zero1, grad_compression=grad_compression,
                     microbatches=microbatches, opt_int8=opt_int8)
    if shape.step == StepKind.TRAIN:
        axes = (steps_mod.batch_axes(cfg, mesh, pure_dp) if mesh is not None
                else ())
        rows, used = rank_rows(shape.global_batch, mesh, axes,
                               max(int(microbatches), 1))
        model, _, batch, step = input_specs(cfg, shape, tc, device, rows)
        if steps_mod.expert_parallel(cfg, mesh, pure_dp):
            n = mesh.size(mesh.mesh_dim_names.index("model"))
            carry.expert_shard(model, cfg, mesh.get_local_rank("model"), n)
        opt = optimizer.init(dict(model.named_parameters()), tc)
        step_fn = steps_mod.make_train_step(
            cfg, tc, mesh=mesh, causal_skip=causal_skip,
            attn_p_bf16=attn_p_bf16, pure_dp=pure_dp, moe_a2a_int8=a2a_int8,
            device=device)
        return step_fn, (model, opt, batch, step), rows, used
    rows, used = rank_rows(shape.global_batch, mesh,
                           steps_mod.dp_axes(mesh) if mesh is not None else ())
    args = input_specs(cfg, shape, tc, device, rows)
    if shape.step == StepKind.PREFILL:
        step_fn = steps_mod.make_prefill_step(
            cfg, shape.seq_len, causal_skip=causal_skip,
            attn_p_bf16=attn_p_bf16, attn_chunk=attn_chunk,
            attn_impl=attn_impl, device=device)
    else:
        step_fn = steps_mod.make_serve_step(cfg, shape.seq_len)
    return step_fn, args, rows, used


def trace_cell(step_fn, args) -> tuple:
    """Run the step once under the op counter and the memory tracker;
    returns (``op_analysis.StepCounts``, memory_stats)."""
    mem = PeakMemory(tensors_of(args))
    with mem:
        _, counts = op_analysis.trace_step(step_fn, args)
    stats = {"argument_bytes": float(mem.argument_bytes),
             "temp_bytes": float(mem.peak - mem.argument_bytes),
             "per_device_bytes": float(mem.peak)}
    stats["fits_hbm"] = stats["per_device_bytes"] < mesh_mod.HBM_BYTES
    return counts, stats


def stats_of(counts: op_analysis.StepCounts) -> dict:
    """``roofline.build_report``'s stats of a traced step."""
    return {"flops": counts.flops, "io_bytes": counts.io_bytes,
            "coll_bytes": counts.coll.coll_bytes(),
            "coll_counts": counts.coll.coll_counts()}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             causal_skip: bool = False, zero1: bool = True,
             grad_compression: str = "none", attn_chunk: int = 1024,
             attn_p_bf16: bool = False, microbatches: int = 1,
             opt_int8: bool = False, exact_retrieval: bool = False,
             pure_dp: bool = False, a2a_int8: bool = False,
             datastore_scale: float = 1.0, attn_impl: str = "xla",
             mesh=None, cfg=None) -> dict:
    """One cell's record (``roofline.RooflineReport`` keys, the run's
    options, ``rows_per_rank``, ``batch_axes``, ``kernel_calls``,
    ``trace_s``) as this process's rank of ``mesh`` (default: the
    production mesh over the initialized — fake — world). ``cfg``
    replaces the registered config (a scaled one in tests)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = get_shape(shape_name)
    mesh = mesh if mesh is not None else mesh_mod.make_production_mesh(
        multi_pod=multi_pod)
    chips = mesh.size()
    mesh_name = "x".join(str(s) for s in mesh.shape)

    t0 = time.time()
    device = trace_device(attn_impl)
    with stand_ins(device):
        step_fn, args, rows, used = build_step(
            cfg, shape, mesh, causal_skip=causal_skip, zero1=zero1,
            grad_compression=grad_compression, attn_chunk=attn_chunk,
            attn_p_bf16=attn_p_bf16, microbatches=microbatches,
            opt_int8=opt_int8, exact_retrieval=exact_retrieval,
            pure_dp=pure_dp, a2a_int8=a2a_int8,
            datastore_scale=datastore_scale, attn_impl=attn_impl,
            device=device)
        counts, mem_stats = trace_cell(step_fn, args)
    t_trace = time.time() - t0
    rec = roofline.build_report(cfg, shape, mesh_name, chips,
                                stats_of(counts),
                                memory_stats=mem_stats).as_dict()
    rec.update(trace_s=t_trace, rows_per_rank=rows, batch_axes=list(used),
               kernel_calls=dict(counts.kernel_calls),
               causal_skip=causal_skip, zero1=zero1,
               grad_compression=grad_compression, attn_chunk=attn_chunk,
               attn_p_bf16=attn_p_bf16, microbatches=microbatches,
               opt_int8=opt_int8, exact_retrieval=exact_retrieval,
               pure_dp=pure_dp, a2a_int8=a2a_int8,
               datastore_scale=datastore_scale, attn_impl=attn_impl,
               multi_pod=multi_pod)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--attn-p-bf16", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-int8", action="store_true")
    ap.add_argument("--exact-retrieval", action="store_true")
    ap.add_argument("--pure-dp", action="store_true")
    ap.add_argument("--a2a-int8", action="store_true")
    ap.add_argument("--datastore-scale", type=float, default=1.0)
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "flash"])
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--out", default="dryrun_torch_out")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells, skipped = runnable_cells([get_config(a) for a in ALL_ARCHS])
        for a, s, why in skipped:
            print(f"SKIP {a} x {s}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    shape, _ = mesh_mod.PRODUCTION[bool(args.multi_pod)]
    mesh_tag = "x".join(map(str, shape))
    failures = []
    with mesh_mod.fake_world(math.prod(shape)):
        mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod)
        for arch, shape_name in cells:
            tag = f"{arch}__{shape_name}__{mesh_tag}" + (
                f"__{args.tag}" if args.tag else "")
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"== {tag}: exists, skipping")
                continue
            print(f"== {tag}", flush=True)
            try:
                rec = run_cell(arch, shape_name, multi_pod=args.multi_pod,
                               causal_skip=args.causal_skip,
                               zero1=not args.no_zero1,
                               grad_compression=args.grad_compression,
                               attn_chunk=args.attn_chunk,
                               attn_p_bf16=args.attn_p_bf16,
                               microbatches=args.microbatches,
                               opt_int8=args.opt_int8,
                               exact_retrieval=args.exact_retrieval,
                               pure_dp=args.pure_dp, a2a_int8=args.a2a_int8,
                               datastore_scale=args.datastore_scale,
                               attn_impl=args.attn_impl, mesh=mesh)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                ms = rec["memory_stats"]
                print(f"   dominant={rec['dominant']} "
                      f"bound={rec['step_time_bound_s']:.4f}s "
                      f"roofline_frac={rec['roofline_frac']:.3f} "
                      f"useful={rec['useful_ratio']:.3f} "
                      f"per_dev={ms['per_device_bytes'] / 1e9:.2f}GB "
                      f"fits={ms['fits_hbm']} trace={rec['trace_s']:.1f}s",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — record, go on with the sweep
                failures.append((tag, repr(e)))
                traceback.print_exc()
                with open(path + ".failed", "w") as f:
                    f.write(traceback.format_exc())
    if failures:
        print(f"{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
