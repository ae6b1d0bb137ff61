"""Config registry (port of ``repro.configs``): importing this package
registers the archs the port serves. Only gemma-2b so far; the other
archs of ``repro`` wait with their block families (ROADMAP queue 1
item 11)."""
from repro_torch.configs.base import (BlockKind, ModelConfig, MoEConfig,
                                      RetrievalConfig, RWKVConfig, SSMConfig,
                                      get_config, list_archs, register,
                                      scaled_down)

# arch registrations (import side effects)
from repro_torch.configs import gemma_2b  # noqa: F401

ALL_ARCHS = list_archs()

__all__ = [
    "ALL_ARCHS", "BlockKind", "ModelConfig", "MoEConfig", "RetrievalConfig",
    "RWKVConfig", "SSMConfig", "get_config", "list_archs", "register",
    "scaled_down",
]
