"""Architecture registry of the port.  Importing this package registers
the architectures the port serves (tinyllama-1.1b in this slice)."""

from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs import tinyllama_1_1b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "list_archs"]
