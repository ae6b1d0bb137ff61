"""Assigned input-shape cells, identical for every LM-family arch (port of
``repro.configs.shapes``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig, StepKind

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, step=StepKind.TRAIN)
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, step=StepKind.PREFILL)
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, step=StepKind.DECODE)
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, step=StepKind.DECODE)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k runs only for sub-quadratic (SSM/hybrid) archs per spec."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True


def runnable_cells(cfgs):
    """All (arch, shape) cells that are runnable, plus the skip list."""
    run, skipped = [], []
    for cfg in cfgs:
        for shape in SHAPES.values():
            if shape_applicable(cfg, shape):
                run.append((cfg.name, shape.name))
            else:
                skipped.append((cfg.name, shape.name, "full-attention arch; long_500k requires sub-quadratic attention"))
    return run, skipped
