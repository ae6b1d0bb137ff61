"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import (BlockKind, ModelConfig, MoEConfig,
                                      RetrievalConfig, register)


@register("arctic-480b")
def arctic_480b() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,               # per-expert hidden dim
        vocab_size=32000,
        head_dim=128,
        mlp_activation="swiglu",
        block_pattern=(BlockKind.MOE,),
        moe=MoEConfig(
            num_experts=128,
            experts_per_token=2,
            expert_d_ff=4864,
            dense_residual_d_ff=4864,   # arctic's dense-MoE hybrid residual
            router_aux_loss=0.001,
            capacity_factor=1.25,
        ),
        retrieval=RetrievalConfig(enabled=True),
    )
