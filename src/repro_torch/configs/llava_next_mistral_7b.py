"""llava-next-mistral-7b — mistral-7b backbone with anyres vision tiles
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only per task spec: the CLIP/anyres frontend is a stub;
``input_specs()`` supplies 576 precomputed patch embeddings (one 24x24 tile)
prepended to the token sequence.
"""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                      register)


@register("llava-next-mistral-7b")
def llava_next_mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        head_dim=128,
        mlp_activation="swiglu",
        rope_theta=1_000_000.0,
        block_pattern=(BlockKind.ATTENTION,),
        frontend="vision_patches",
        frontend_positions=576,
        retrieval=RetrievalConfig(enabled=True),
    )
