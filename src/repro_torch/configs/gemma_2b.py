"""gemma-2b — dense MQA transformer, GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                      register)


@register("gemma-2b")
def gemma_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,          # MQA on the 2b variant
        d_ff=16384,
        vocab_size=256000,
        head_dim=256,
        mlp_activation="geglu",
        tie_embeddings=True,
        block_pattern=(BlockKind.ATTENTION,),
        retrieval=RetrievalConfig(enabled=True),
    )
