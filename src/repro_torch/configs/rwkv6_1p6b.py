"""rwkv6-1.6b (Finch) — attention-free RNN with data-dependent decay
[arXiv:2404.05892; unverified]."""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                RWKVConfig, register)


@register("rwkv6-1.6b")
def rwkv6_1p6b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=0,             # attention-free
        num_kv_heads=0,
        d_ff=7168,
        vocab_size=65536,
        mlp_activation="relu_sq",  # rwkv channel-mix uses squared relu
        block_pattern=(BlockKind.RWKV6,),
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
        retrieval=RetrievalConfig(enabled=True),
    )
