"""Config registry (port of ``repro.configs``): importing this package
registers every arch ``repro`` registers: the dense attention stacks
(gemma-2b, granite-20b, internlm2-20b, deepseek-67b), the frontend
configs (llava-next-mistral-7b, musicgen-medium), the MoE stacks
(arctic-480b, kimi-k2-1t-a32b), the Mamba2 hybrid (zamba2-2.7b) and
RWKV6 (rwkv6-1.6b)."""
from repro_torch.configs.base import (BlockKind, ModelConfig, MoEConfig,
                                      RetrievalConfig, RWKVConfig,
                                      ShapeConfig, SSMConfig, StepKind,
                                      TrainConfig, get_config, list_archs,
                                      register, scaled_down)
from repro_torch.configs.shapes import (SHAPES, get_shape, runnable_cells,
                                        shape_applicable)

# arch registrations (import side effects)
from repro_torch.configs import (arctic_480b, deepseek_67b,  # noqa: F401
                                 gemma_2b, granite_20b, internlm2_20b,
                                 kimi_k2, llava_next_mistral_7b,
                                 musicgen_medium, rwkv6_1p6b, zamba2_2p7b)

ALL_ARCHS = list_archs()

__all__ = [
    "ALL_ARCHS", "BlockKind", "ModelConfig", "MoEConfig", "RetrievalConfig",
    "RWKVConfig", "SHAPES", "ShapeConfig", "SSMConfig", "StepKind",
    "TrainConfig", "get_config", "get_shape", "list_archs", "register",
    "runnable_cells", "scaled_down", "shape_applicable",
]
