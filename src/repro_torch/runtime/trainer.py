"""Fault-tolerant training loop (port of ``repro.runtime.trainer``), on one
device or on every rank of a ``DeviceMesh``.

* auto-resume from the latest committed checkpoint (params, optimizer
  state, step);
* periodic checkpoints (params blocking, optimizer state in the
  background) and a final checkpoint on ``PreemptionError`` or SIGTERM;
* deterministic-by-step data (``data.pipeline.make_batch``: any restart
  replays the exact stream; a frontend config's prefix embeddings are
  ``frontends.synthetic_prefix`` seeded by the seed and the step);
* straggler monitor: EWMA of step time, flags steps > ``straggler_factor``
  x the running mean (logged and counted);
* preemption simulation hook for tests (``preempt_at``).

Checkpoints are the port's trees: the params as a dict keyed by the
model's ``named_parameters()`` names and the ``AdamState`` over the same
keys (``repro`` saves its stacked-block pytrees).

On a mesh (``train(..., mesh=)``) every rank runs this loop: it builds
the model from the same seed, keeps its experts under expert parallelism
(``carry.expert_shard``) and passes its slice of each global batch
(``steps.shard_batch``). A checkpoint is the single-device tree: the
experts (params and their moments) are gathered over the expert axis in
rank order and rank 0 writes them; each rank restores the whole tree and
keeps its share. So a checkpoint written on a mesh resumes on one device
and the reverse. A SIGTERM must reach every rank (a rank that stops
alone leaves the others waiting in a collective).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import carry
from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.dist import steps as steps_mod
from repro_torch.kernels import ops
from repro_torch.models import frontends, lm
from repro_torch.models import moe as moe_mod
from repro_torch.optim import optimizer


@dataclasses.dataclass
class TrainerReport:
    steps_done: int
    final_loss: float
    resumed_from: Optional[int]
    straggler_steps: int
    step_times: list
    # the port's addition (one process): the trained model and its state
    model: Optional[lm.LM] = None
    opt_state: Optional[optimizer.AdamState] = None


class PreemptionError(RuntimeError):
    pass


def _gathered(tree: dict, mesh, rank: int, n: int) -> dict:
    """A rank's tree with its expert entries gathered over the mesh's
    ``"model"`` axis in rank order (every rank calls it)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if optimizer.is_expert(k):
            v = ops._all_gather(v, mesh, ("model",), n, rank).reshape(
                (n * v.shape[0],) + tuple(v.shape[1:]))
        out[k] = v
    return out


def _whole_like(tree: dict, n: int) -> dict:
    """Meta tensors of the whole tree's shapes and dtypes, for a rank's
    tree whose expert entries hold 1 / n of the experts."""
    return {k: torch.empty(((v.shape[0] * n,) + tuple(v.shape[1:])
                            if optimizer.is_expert(k) else v.shape),
                           dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def train(cfg: ModelConfig, tc: TrainConfig, *, seq_len: int,
          global_batch: int, device=None, mesh=None,
          ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10,
          straggler_factor: float = 3.0,
          preempt_at: Optional[int] = None,
          on_metrics: Optional[Callable] = None) -> TrainerReport:
    """Train ``cfg`` for ``tc.total_steps`` steps on ``device`` — CUDA
    unless ``device="cpu"``; weights from a ``torch.Generator`` on that
    device seeded by ``tc.seed``. ``on_metrics(step, metrics)`` sees every
    step's metrics (0-d tensors). With ``mesh`` every rank calls this
    (module docstring); the report's model and state are this rank's."""
    dev = device_mod.resolve(device)
    step_fn = steps_mod.make_train_step(cfg, tc, mesh=mesh, device=dev)
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    model = lm.init_params(gen, cfg, device=dev)
    ep = steps_mod.expert_parallel(cfg, mesh)
    n_ep = moe_mod.ep_size(mesh, "model") if ep else 1
    ep_rank = int(mesh.get_local_rank("model")) if ep else 0
    if ep:
        carry.expert_shard(model, cfg, ep_rank, n_ep)
    params = dict(model.named_parameters())
    opt_state = optimizer.init(params, tc)
    writer = mesh is None or dist.get_rank() == 0

    def whole(tree):
        return _gathered(tree, mesh, ep_rank, n_ep) if ep else tree

    def save(step, blocking_opt):
        p, o = whole(params), optimizer.map_moments(opt_state, whole)
        if writer:
            ckpt.save(ckpt_dir, step, p, blocking=True)
            return ckpt.save(ckpt_dir + "/opt", step, o,
                             blocking=blocking_opt)
        return None

    start_step, resumed_from = 0, None
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            like = _whole_like(params, n_ep)
            saved = ckpt.restore(ckpt_dir, latest, like, device=dev)
            if ep:
                saved = carry.expert_shard(saved, cfg, ep_rank, n_ep)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved[name])
            del saved
            like = optimizer.map_moments(opt_state,
                                         lambda t: _whole_like(t, n_ep))
            opt_state = ckpt.restore(ckpt_dir + "/opt", latest, like,
                                     device=dev)
            if ep:
                opt_state = carry.expert_shard(opt_state, cfg, ep_rank, n_ep)
            start_step, resumed_from = latest, latest

    dc = pipeline.data_config_for(cfg, seq_len, global_batch, tc.seed)
    ewma, stragglers, times = None, 0, []
    save_thread = None
    final_loss = float("nan")
    interrupted = {"flag": False}

    def _sigterm(*_):
        interrupted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _sigterm)
    step = start_step
    try:
        while step < tc.total_steps:
            if preempt_at is not None and step == preempt_at:
                raise PreemptionError(f"simulated preemption at {step}")
            batch = pipeline.make_batch(dc, step)
            if cfg.frontend != "none":
                # the port's addition (``repro``'s trainer feeds no
                # frontend input): seeded stand-in prefix embeddings
                batch["prefix_emb"] = frontends.synthetic_prefix(
                    cfg, global_batch, torch.Generator(dev).manual_seed(
                        tc.seed * 1_000_003 + step), device=dev)
            if mesh is not None:
                batch = steps_mod.shard_batch(batch, cfg, tc, mesh)
            t0 = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, batch,
                                                step)
            final_loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            times.append(dt)
            if ewma is not None and dt > straggler_factor * ewma:
                stragglers += 1
                print(f"[straggler] step {step}: {dt:.3f}s vs EWMA "
                      f"{ewma:.3f}s")
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if on_metrics is not None:
                on_metrics(step, metrics)
            if writer and log_every and step % log_every == 0:
                print(f"step {step}: loss={final_loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms")
            step += 1
            if ckpt_dir is not None and step % ckpt_every == 0:
                if save_thread is not None:
                    save_thread.join()
                save_thread = save(step, blocking_opt=False)
            if interrupted["flag"]:
                raise PreemptionError("SIGTERM")
    except PreemptionError:
        if ckpt_dir is not None:
            if save_thread is not None:
                save_thread.join()
            save(step, blocking_opt=True)
            _barrier(mesh)
        raise
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if save_thread is not None:
            save_thread.join()

    if ckpt_dir is not None:
        save(step, blocking_opt=True)
        if writer:
            ckpt.garbage_collect(ckpt_dir)
        _barrier(mesh)
    return TrainerReport(steps_done=step - start_step, final_loss=final_loss,
                         resumed_from=resumed_from, straggler_steps=stragglers,
                         step_times=times, model=model, opt_state=opt_state)


def _barrier(mesh) -> None:
    """Every rank waits until rank 0's checkpoint is committed."""
    if mesh is not None:
        dist.barrier()
