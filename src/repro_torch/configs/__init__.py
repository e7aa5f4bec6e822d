"""Architecture registry of the port.  Importing this package registers
the architectures the port serves and trains: tinyllama-1.1b (paged and
dense serving, training), zamba2-2.7b and rwkv6-7b (dense serving)."""

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs)
from repro_torch.configs import rwkv6_7b  # noqa: F401
from repro_torch.configs import tinyllama_1_1b  # noqa: F401
from repro_torch.configs import zamba2_2_7b  # noqa: F401

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_archs"]
