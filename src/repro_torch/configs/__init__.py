"""Architecture registry of the port.  Importing this package registers
the reference's ten architectures: tinyllama-1.1b (paged and dense
serving, training), gemma3-12b (paged serving with sliding-window ring
pages, dense serving with a ring cache), mistral-nemo-12b and
command-r-35b (paged and dense serving), zamba2-2.7b and rwkv6-7b (dense
serving, training), qwen2-moe-a2.7b, dbrx-132b and phi-3-vision-4.2b
(dense serving; phi-3's image tokens through ``Model.prefill``) and
whisper-base (``Model.prefill`` / ``Model.decode_step`` with its frame
features)."""

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs)
from repro_torch.configs import command_r_35b  # noqa: F401
from repro_torch.configs import dbrx_132b  # noqa: F401
from repro_torch.configs import gemma3_12b  # noqa: F401
from repro_torch.configs import mistral_nemo_12b  # noqa: F401
from repro_torch.configs import phi3_vision_4_2b  # noqa: F401
from repro_torch.configs import qwen2_moe_a2_7b  # noqa: F401
from repro_torch.configs import rwkv6_7b  # noqa: F401
from repro_torch.configs import tinyllama_1_1b  # noqa: F401
from repro_torch.configs import whisper_base  # noqa: F401
from repro_torch.configs import zamba2_2_7b  # noqa: F401

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_archs"]
