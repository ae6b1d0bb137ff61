"""Config dataclasses + registry (port of ``repro.configs.base``).

A ModelConfig fully describes one architecture. Configs are plain frozen
dataclasses so they hash, print, and diff cleanly and can key the step
caches (``dist/steps.py``). The fields, defaults and ``scaled_down`` are
``repro``'s, so a config built by either package describes the same model.
The workload-cell and training configs (``ShapeConfig``, ``StepKind``,
``TrainConfig``) wait with the trainer (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Tuple


class BlockKind(str, enum.Enum):
    """Kind of a single residual block in the layer stack."""

    ATTENTION = "attention"        # full (GQA/MQA) causal attention + MLP
    MAMBA2 = "mamba2"              # Mamba2 SSD block
    RWKV6 = "rwkv6"                # RWKV6 time-mix + channel-mix
    MOE = "moe"                    # attention + MoE FFN (optional dense residual)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    # d_ff of each expert (may differ from the dense d_ff)
    expert_d_ff: int
    # dense residual MLP run in parallel with the experts (arctic-style)
    dense_residual_d_ff: int = 0
    # shared expert always active (deepseek/kimi-style)
    num_shared_experts: int = 0
    router_aux_loss: float = 0.01
    # capacity factor for dense one-hot dispatch accounting
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD parameters."""

    state_dim: int = 64            # N: per-head SSM state size
    head_dim: int = 64             # P: channels per SSM head
    expand: int = 2                # d_inner = expand * d_model
    chunk_size: int = 128          # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    # decay LoRA rank for data-dependent decay (Finch)
    decay_lora: int = 64
    gate_lora: int = 64


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """kNN-LM / retrieval integration (the paper's technique at serve time)."""

    enabled: bool = False
    code_bits: int = 256           # binary code width d (Hamming space)
    datastore_size: int = 1 << 20  # number of entries in the datastore
    k: int = 16                    # neighbors
    local_k: int = 4               # k' for hierarchical (statistical) reduction
    interpolation: float = 0.25    # lambda for kNN-LM mixing
    # per-device scan chunk ("board capacity") for the MATERIALIZING selects
    # and "fused_scan" only — the single-shot "fused" path streams the whole
    # datastore in one invocation and tiles via kernels/tuning.py, so this
    # is a no-op for it
    chunk_size: int = 1 << 16
    # top-k select path: "auto" | "counting" | "bisect" | "fused" |
    # "fused_scan" (see the generated decision table in DESIGN.md);
    # orthogonal to the distance method. Legacy twin of ``plan`` below —
    # both route through core/plan.py's planner ("auto" lets it resolve)
    select: str = "auto"
    # physical datastore layout (core/layout.py): "none" keeps insertion
    # order; "hamming_prefix" bucket-clusters the packed codes at build
    # time so the fused select's block-min pruning bites even on uniform
    # data (single-device: a prebuilt layout on the DataStore; sharded:
    # each shard re-sorts its local slice per call). Only the "fused"
    # select consumes it — with any other select the prebuilt copy is
    # idle memory, so pair layout != "none" with select="fused" (or a
    # per-call select override)
    layout: str = "none"
    # bucket count for the layout ("hamming_prefix" rounds up to a power
    # of two); 0 -> heuristic (~256 rows per bucket, layout.default_bits)
    layout_buckets: int = 0
    # query planning (core/plan.py): "auto" lets the planner resolve the
    # select/layout/merge stages from datastore stats; any concrete select
    # path name ("composite" | "counting" | "bisect" | "fused" |
    # "fused_scan") forces that stage through the same planner. Takes
    # precedence over the legacy ``select`` field when not "auto".
    plan: str = "auto"
    # fine-grained forced-plan overrides applied after planning, e.g.
    # "select=fused_scan,chunk=4096,layout=off" (see plan.parse_force);
    # "" applies none. The escape hatch that replaces ad-hoc knobs.
    force_plan: str = ""
    # approx tier only (select/plan = "approx"): expected recall@k floor
    # the analytical bound sizes the per-block candidate count L for;
    # 1.0 keeps the full block — exact, bit-identical to "fused". Exact
    # selects ignore it.
    recall_target: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # activation: "swiglu" | "geglu" | "gelu"
    mlp_activation: str = "swiglu"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # layer layout: function idx -> BlockKind, via pattern list repeated
    block_pattern: Tuple[BlockKind, ...] = (BlockKind.ATTENTION,)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    retrieval: RetrievalConfig = RetrievalConfig()
    # modality frontend stub: "none" | "audio_frames" | "vision_patches"
    frontend: str = "none"
    # frontend embedding slots prepended to the token sequence (stub provides
    # precomputed embeddings of this many positions)
    frontend_positions: int = 0
    dtype: str = "bfloat16"
    # zamba2-style shared attention block applied every N blocks (0 = off)
    shared_attn_every: int = 0

    def block_kind(self, layer_idx: int) -> BlockKind:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def attention_free(self) -> bool:
        return all(k in (BlockKind.MAMBA2, BlockKind.RWKV6) for k in self.block_pattern) and (
            self.shared_attn_every == 0
        )

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (SSM/hybrid)."""
        return any(k in (BlockKind.MAMBA2, BlockKind.RWKV6) for k in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (matches the constructed pytree)."""
        from repro_torch.models import lm  # local import to avoid cycles

        return lm.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import lm

        return lm.param_count(self, active_only=True)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    reduced = dict(
        num_layers=min(cfg.num_layers, 2 if cfg.shared_attn_every == 0 else 4),
        d_model=128,
        num_heads=min(cfg.num_heads, 4) if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=256,
        vocab_size=512,
        head_dim=32 if cfg.head_dim else 0,
        shared_attn_every=min(cfg.shared_attn_every, 2) if cfg.shared_attn_every else 0,
    )
    if cfg.num_kv_heads == 1:       # preserve MQA structure
        reduced["num_kv_heads"] = 1
    if cfg.moe is not None:
        reduced["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            expert_d_ff=128,
            dense_residual_d_ff=128 if cfg.moe.dense_residual_d_ff else 0,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
        )
    if cfg.ssm is not None:
        reduced["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=32)
    if cfg.rwkv is not None:
        reduced["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_dim=32, decay_lora=16, gate_lora=16)
    if cfg.retrieval.enabled:
        reduced["retrieval"] = dataclasses.replace(
            cfg.retrieval, code_bits=64, datastore_size=2048, chunk_size=512)
    reduced.update(overrides)
    return dataclasses.replace(cfg, **reduced)
