"""Fault-tolerant training loop (port of ``repro.runtime.trainer``, one
device, no mesh).

* auto-resume from the latest committed checkpoint (params, optimizer
  state, step);
* periodic checkpoints (params blocking, optimizer state in the
  background) and a final checkpoint on ``PreemptionError`` or SIGTERM;
* deterministic-by-step data (``data.pipeline.make_batch``: any restart
  replays the exact stream);
* straggler monitor: EWMA of step time, flags steps > ``straggler_factor``
  x the running mean (logged and counted);
* preemption simulation hook for tests (``preempt_at``).

Checkpoints are the port's trees: the params as a dict keyed by the
model's ``named_parameters()`` names and the ``AdamState`` over the same
keys (``repro`` saves its stacked-block pytrees).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.dist import steps as steps_mod
from repro_torch.models import lm
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


def train(cfg: ModelConfig, tc: TrainConfig, *, seq_len: int,
          global_batch: int, device=None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10,
          straggler_factor: float = 3.0,
          preempt_at: Optional[int] = None,
          on_metrics: Optional[Callable] = None) -> TrainerReport:
    """Train ``cfg`` for ``tc.total_steps`` steps on ``device`` — CUDA
    unless ``device="cpu"``; weights from a ``torch.Generator`` on that
    device seeded by ``tc.seed``. ``on_metrics(step, metrics)`` sees every
    step's metrics (0-d tensors)."""
    dev = device_mod.resolve(device)
    step_fn = steps_mod.make_train_step(cfg, tc, device=dev)
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    model = lm.init_params(gen, cfg, device=dev)
    params = dict(model.named_parameters())
    opt_state = optimizer.init(params, tc)

    start_step, resumed_from = 0, None
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            saved = ckpt.restore(ckpt_dir, latest, params)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved[name])
            del saved
            opt_state = ckpt.restore(ckpt_dir + "/opt", latest, opt_state)
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
            if log_every and step % log_every == 0:
                print(f"step {step}: loss={final_loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms")
            step += 1
            if ckpt_dir is not None and step % ckpt_every == 0:
                if save_thread is not None:
                    save_thread.join()
                ckpt.save(ckpt_dir, step, params, blocking=True)
                save_thread = ckpt.save(ckpt_dir + "/opt", step, opt_state,
                                        blocking=False)
            if interrupted["flag"]:
                raise PreemptionError("SIGTERM")
    except PreemptionError:
        if ckpt_dir is not None:
            if save_thread is not None:
                save_thread.join()
            ckpt.save(ckpt_dir, step, params, blocking=True)
            ckpt.save(ckpt_dir + "/opt", step, opt_state, blocking=True)
        raise
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if save_thread is not None:
            save_thread.join()

    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, step, params, blocking=True)
        ckpt.save(ckpt_dir + "/opt", step, opt_state, blocking=True)
        ckpt.garbage_collect(ckpt_dir)
    return TrainerReport(steps_done=step - start_step, final_loss=final_loss,
                         resumed_from=resumed_from, straggler_steps=stragglers,
                         step_times=times, model=model, opt_state=opt_state)
