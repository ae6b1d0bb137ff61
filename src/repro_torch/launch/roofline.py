"""Roofline terms of one traced step on the H100 (port of
``repro.launch.roofline``).

All inputs are PER RANK: ``launch/op_analysis.py`` traces the rank's own
program (FLOPs and HBM bytes under ``repro``'s cost model) and
``launch/collectives.py`` tallies the collectives it issues.

  compute    = flops_per_device / 989 TFLOP/s      (dense bf16)
  memory     = hbm_bytes_per_device / 3.35 TB/s
  collective = collective_bytes_per_device / NIC_BW (50 GB/s) when the mesh
               spans more than one 8-card NVLink node, else / NVLINK_BW
               (450 GB/s each way) — the counterpart of ``repro``'s one ICI
               link charged

MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (forward-only) + the causal
attention term — the useful-compute yardstick; useful_ratio compares it with
chips * flops_per_device (below 1 where ranks repeat each other's work).
``repro``'s ``cost_analysis_flops`` (XLA's compiled cost analysis) has no
counterpart: eager PyTorch compiles no module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig, StepKind
from repro_torch.launch.mesh import (HBM_BW, NIC_BW, NODE_CARDS, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.models import lm


def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs for one step of this (arch, shape) cell (whole fleet)."""
    n_active = lm.param_count(cfg, active_only=True)
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    layers = (cfg.num_layers // cfg.shared_attn_every
              if cfg.shared_attn_every else cfg.num_layers)

    if shape.step == StepKind.TRAIN:
        dense = 2.0 * n_active * B * S
        attn = 4.0 * B * S * S * cfg.num_heads * hd * layers * 0.5 \
            if cfg.num_heads else 0.0
        return 3.0 * (dense + attn)        # fwd + 2x bwd
    if shape.step == StepKind.PREFILL:
        dense = 2.0 * n_active * B * S
        attn = 4.0 * B * S * S * cfg.num_heads * hd * layers * 0.5 \
            if cfg.num_heads else 0.0
        return dense + attn
    # decode: one token per sequence; attention reads the full cache
    dense = 2.0 * n_active * B
    attn = 4.0 * B * S * cfg.num_heads * hd * layers if cfg.num_heads else 0.0
    return dense + attn


def collective_rate(chips: int) -> float:
    """Bytes/s a rank's collectives are charged at: NVLink inside one
    node, the node's NIC share across nodes."""
    return NVLINK_BW if chips <= NODE_CARDS else NIC_BW


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float            # MODEL_FLOPS / (chips * flops_per_device)
    roofline_frac: float           # useful work at peak / dominant-term time
    step_time_bound_s: float       # max of the three terms
    collective_detail: Optional[Dict[str, float]] = None
    collective_counts: Optional[Dict[str, float]] = None
    memory_stats: Optional[Dict[str, float]] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def build_report(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
                 chips: int, stats: Dict, memory_stats=None) -> RooflineReport:
    flops = float(stats["flops"])
    byts = float(stats["io_bytes"])
    coll = stats["coll_bytes"]
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = byts / HBM_BW
    collective_s = float(coll.get("total", 0.0)) / collective_rate(chips)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model_flops = analytic_model_flops(cfg, shape)
    useful = model_flops / (chips * flops) if flops else 0.0
    # fraction of roofline: time the useful work needs at peak vs the bound
    ideal_s = model_flops / (chips * PEAK_FLOPS_BF16)
    frac = ideal_s / bound if bound > 0 else 0.0
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, hbm_bytes_per_device=byts,
        collective_bytes_per_device=float(coll.get("total", 0.0)),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        roofline_frac=frac, step_time_bound_s=bound,
        collective_detail={k: v for k, v in coll.items() if k != "total"},
        collective_counts=stats.get("coll_counts"),
        memory_stats=memory_stats,
    )
