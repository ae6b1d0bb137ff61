"""musicgen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf].

Backbone only per task spec: the EnCodec/text-conditioning frontend is a stub;
``input_specs()`` supplies 64 precomputed conditioning-frame embeddings that
are prepended to the audio-token sequence.
"""
from repro_torch.configs.base import (BlockKind, ModelConfig, RetrievalConfig,
                                      register)


@register("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,         # full MHA
        d_ff=6144,
        vocab_size=2048,         # EnCodec codebook
        head_dim=64,
        mlp_activation="gelu",
        block_pattern=(BlockKind.ATTENTION,),
        frontend="audio_frames",
        frontend_positions=64,
        retrieval=RetrievalConfig(enabled=True),
    )
