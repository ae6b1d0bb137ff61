"""internlm2-20b — dense GQA transformer [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                      register)


@register("internlm2-20b")
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        head_dim=128,
        mlp_activation="swiglu",
        rope_theta=1_000_000.0,
        block_pattern=(BlockKind.ATTENTION,),
        retrieval=RetrievalConfig(enabled=True),
    )
