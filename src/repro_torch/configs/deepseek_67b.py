"""deepseek-67b — dense llama-arch GQA transformer [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                      register)


@register("deepseek-67b")
def deepseek_67b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        head_dim=128,
        mlp_activation="swiglu",
        rope_theta=10000.0,
        block_pattern=(BlockKind.ATTENTION,),
        retrieval=RetrievalConfig(enabled=True),
    )
