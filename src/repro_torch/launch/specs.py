"""Stand-ins for every step input, allocated nowhere (port of
``repro.launch.specs``).

``repro`` hands its dry run ``ShapeDtypeStruct`` trees. The port's
stand-ins are real objects of the port's types — the ``lm.LM`` module,
an ``AdamState``, the batch dict, the decode state, a ``DataStore`` —
whose tensors live on the ``meta`` device, or, built inside a
``FakeTensorMode``, are fake tensors on any device (the dry run's fake
CUDA tensors). Nothing is drawn from a generator: the model is
``lm._build`` without one (empty parameters, ``repro``'s names, shapes
and dtypes), the datastore's codes and values are empty. The tuples
mirror ``repro``'s, with the module where ``repro`` has a params tree:

  train    (model, opt_state, batch, step)
  prefill  (model, batch)
  decode   (model, token, state, active[, store])
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, StepKind,
                                      TrainConfig)
from repro_torch.core import binary, quantize
from repro_torch.core import retrieval as retrieval_mod
from repro_torch.models import frontends, lm
from repro_torch.models.layers import _dtype
from repro_torch.optim import optimizer


def param_specs_sds(cfg: ModelConfig, device="meta") -> lm.LM:
    """The model with empty parameters on ``device``."""
    return lm._build(cfg, device)


def batch_sds(cfg: ModelConfig, shape: ShapeConfig, device="meta",
              rows: Optional[int] = None) -> dict:
    """{'tokens', 'labels'} (rows, S) int32, and a frontend config's
    ``prefix_emb`` (rows, P, frontend_dim); ``rows`` defaults to the
    shape's global batch."""
    B = shape.global_batch if rows is None else rows
    tok = lambda: torch.empty((B, shape.seq_len), dtype=torch.int32,
                              device=device)
    b = {"tokens": tok(), "labels": tok()}
    if cfg.frontend != "none":
        b["prefix_emb"] = torch.empty(
            (B, cfg.frontend_positions, frontends.frontend_dim(cfg)),
            dtype=_dtype(cfg), device=device)
    return b


def datastore_sds(cfg: ModelConfig, device="meta") -> retrieval_mod.DataStore:
    """The config's datastore (``retrieval.synthetic_datastore``'s shapes
    and ITQ, no layout: no registered config asks for one)."""
    r = cfg.retrieval
    n, W = r.datastore_size, binary.padded_words(r.code_bits)
    itq = quantize.ITQParams(
        mean=torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        proj=torch.eye(cfg.d_model, r.code_bits, dtype=torch.float32,
                       device=device),
        rot=torch.eye(r.code_bits, dtype=torch.float32, device=device))
    return retrieval_mod.DataStore(
        codes=torch.empty((n, W), dtype=torch.int32, device=device),
        values=torch.empty((n,), dtype=torch.int32, device=device), itq=itq)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                tc: TrainConfig = TrainConfig(), device="meta",
                rows: Optional[int] = None) -> tuple:
    """The argument tuple of the step this shape runs (train_step /
    prefill_step / serve_step); ``rows`` replaces the global batch (a
    rank's slice in the dry run)."""
    model = param_specs_sds(cfg, device)
    B = shape.global_batch if rows is None else rows
    if shape.step == StepKind.TRAIN:
        opt = optimizer.init(dict(model.named_parameters()), tc)
        step = torch.zeros((), dtype=torch.int32, device=device)
        return model, opt, batch_sds(cfg, shape, device, B), step
    if shape.step == StepKind.PREFILL:
        return model, batch_sds(cfg, shape, device, B)
    # decode: one new token against a KV cache of seq_len
    state = lm.init_decode_state(cfg, B, shape.seq_len, device=device)
    token = torch.empty((B, 1), dtype=torch.int32, device=device)
    active = torch.empty((B,), dtype=torch.bool, device=device)
    args = (model, token, state, active)
    if cfg.retrieval.enabled:
        args = args + (datastore_sds(cfg, device),)
    return args
