"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54 Mamba2 blocks; a single weight-shared (attention + MLP) block is applied
every `shared_attn_every` Mamba2 blocks (Zamba2's shared transformer block).
"""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                SSMConfig, register)


@register("zamba2-2.7b")
def zamba2_2p7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        head_dim=80,
        mlp_activation="gelu",
        block_pattern=(BlockKind.MAMBA2,),
        shared_attn_every=6,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=128),
        retrieval=RetrievalConfig(enabled=True),
    )
