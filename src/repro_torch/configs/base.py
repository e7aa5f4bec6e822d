"""Architecture configuration: a copy of ``repro/configs/base.py``.

The port keeps its own copy (it imports nothing of the JAX package).
What it carries is what the serving and training paths read:
``ModelConfig``, the block-kind constants, the ``register``/``get_config``
registry, and the invocation shapes (``ShapeConfig``, ``SHAPES``).  The
analytic parameter counts live in ``core/profiles.py``; the cell
enumeration of the reference stays there until a later slice needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# Block kinds: the repeating-pattern units a model is built from.
ATTN_GLOBAL = "attn_global"        # full causal self attention
ATTN_LOCAL = "attn_local"          # sliding-window self attention
ATTN_SHARED = "attn_shared"        # weight-shared attention block (zamba2)
RWKV6 = "rwkv6"                    # RWKV-6 "Finch" time-mix + channel-mix
MAMBA2 = "mamba2"                  # Mamba-2 SSD block
MOE = "moe"                        # MoE FFN block (attention + routed experts)
ENC_ATTN = "enc_attn"              # bidirectional encoder self attention
DEC_ATTN = "dec_attn"              # decoder self attention + cross attention


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared_experts: int = 0
    d_shared_expert: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    sliding_window: int = 0            # >0 for ATTN_LOCAL entries
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    use_qk_norm: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # gemma scales token embeddings by sqrt(d_model); the reference decides
    # that by the config's name, the port by this field (gemma configs set it)
    scale_embed: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0
    num_image_tokens: int = 0
    max_context: int = 131_072
    dtype: str = "bfloat16"
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible "
                f"by pattern length {len(self.pattern)}")

    @property
    def num_blocks(self) -> int:
        """Number of repeating pattern blocks."""
        return self.num_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.family in ("encdec", "audio") and self.num_encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return all(k in (RWKV6, MAMBA2) for k in self.pattern)

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced copy (smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (triggers registration)
        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; the port knows "
                           f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
