"""Config registry (port of ``repro.configs``): importing this package
registers the archs the port serves: gemma-2b (attention), zamba2-2.7b
(the Mamba2 hybrid) and rwkv6-1.6b (RWKV6). ``repro``'s MoE, frontend and
other dense archs wait with their families (ROADMAP queue 1 item 11)."""
from repro_torch.configs.base import (BlockKind, ModelConfig, MoEConfig,
                                      RetrievalConfig, RWKVConfig,
                                      ShapeConfig, SSMConfig, StepKind,
                                      TrainConfig, get_config, list_archs,
                                      register, scaled_down)
from repro_torch.configs.shapes import (SHAPES, get_shape, runnable_cells,
                                        shape_applicable)

# arch registrations (import side effects)
from repro_torch.configs import (gemma_2b, rwkv6_1p6b,  # noqa: F401
                                 zamba2_2p7b)

ALL_ARCHS = list_archs()

__all__ = [
    "ALL_ARCHS", "BlockKind", "ModelConfig", "MoEConfig", "RetrievalConfig",
    "RWKVConfig", "SHAPES", "ShapeConfig", "SSMConfig", "StepKind",
    "TrainConfig", "get_config", "get_shape", "list_archs", "register",
    "runnable_cells", "scaled_down", "shape_applicable",
]
