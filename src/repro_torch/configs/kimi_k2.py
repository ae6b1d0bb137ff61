"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified, paper-table config].

All layers MoE with one always-on shared expert (DeepSeek-V3-style); spec
fields per assignment: 61L, d_model=7168, 64H GQA kv=8, per-expert d_ff=2048,
vocab=163840. Expert weights are FSDP-sharded over the data axes (the only
way 2 TB of bf16 expert weights fit 512x16GB chips).
"""
from repro_torch.configs.base import (BlockKind, ModelConfig, MoEConfig,
                                      RetrievalConfig, register)


@register("kimi-k2-1t-a32b")
def kimi_k2() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,               # per-expert hidden dim
        vocab_size=163840,
        head_dim=112,
        mlp_activation="swiglu",
        block_pattern=(BlockKind.MOE,),
        moe=MoEConfig(
            num_experts=384,
            experts_per_token=8,
            expert_d_ff=2048,
            num_shared_experts=1,
            router_aux_loss=0.001,
            capacity_factor=1.25,
        ),
        retrieval=RetrievalConfig(enabled=True),
    )
