"""granite-20b — dense llama-arch MQA code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                      register)


@register("granite-20b")
def granite_20b() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,          # MQA
        d_ff=24576,
        vocab_size=49152,
        head_dim=128,
        # GPT-BigCode-style 2-matrix MLP (a swiglu MLP at this d_ff would be
        # 28B, off the 20B nameplate)
        mlp_activation="gelu",
        block_pattern=(BlockKind.ATTENTION,),
        retrieval=RetrievalConfig(enabled=True),
    )
