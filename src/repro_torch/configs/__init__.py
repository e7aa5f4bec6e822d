"""Architecture registry of the port.  Importing this package registers
the architectures the port serves and trains: tinyllama-1.1b (paged and
dense serving, training), gemma3-12b (paged serving with sliding-window
ring pages, dense serving with a ring cache), mistral-nemo-12b and
command-r-35b (paged and dense serving), zamba2-2.7b and rwkv6-7b (dense
serving)."""

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs)
from repro_torch.configs import command_r_35b  # noqa: F401
from repro_torch.configs import gemma3_12b  # noqa: F401
from repro_torch.configs import mistral_nemo_12b  # noqa: F401
from repro_torch.configs import rwkv6_7b  # noqa: F401
from repro_torch.configs import tinyllama_1_1b  # noqa: F401
from repro_torch.configs import zamba2_2_7b  # noqa: F401

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_archs"]
