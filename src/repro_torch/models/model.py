"""Parameter tree, init and embedding of the RoPE attention-only
families: the counterpart of the parts of ``repro/models/model.py`` and
``repro/models/transformer.py`` that paged serving reads.

The tree keeps the reference's layout -- ``params["blocks"]
[f"p{i}_{kind}"]`` with a leading stacked-blocks dim, ``params["embed"]``
and ``params["ln_f"]`` -- so bridged reference weights drop in as they
are.  The families with other block kinds (MoE, RWKV-6, Mamba-2, the
encoder-decoder and vision prefixes) come with later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

Params = Dict[str, Any]
SUPPORTED_KINDS = (ATTN_GLOBAL, ATTN_LOCAL)


def check_family(cfg: ModelConfig) -> None:
    if (any(k not in SUPPORTED_KINDS for k in cfg.pattern)
            or cfg.is_encdec or cfg.family in ("vlm", "audio")):
        raise ValueError(
            f"the port's model covers RoPE global/sliding-window attention "
            f"stacks; {cfg.name} has pattern={cfg.pattern} "
            f"family={cfg.family}")


def _stack(specs, nb: int):
    return {k: (_stack(v, nb) if isinstance(v, dict)
                else L.Spec((nb,) + v.shape, v.std))
            for k, v in specs.items()}


def param_specs(cfg: ModelConfig) -> Params:
    """Full parameter spec tree (the reference's ``model_specs``)."""
    check_family(cfg)
    block = {"ln1": {"g": L.rms_norm_spec(cfg.d_model)},
             "attn": attn.attn_specs(cfg),
             "ln2": {"g": L.rms_norm_spec(cfg.d_model)},
             "mlp": L.gated_mlp_specs(cfg.d_model, cfg.d_ff)}
    return {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model,
                               cfg.tie_embeddings),
        "blocks": {f"p{i}_{kind}": _stack(block, cfg.num_blocks)
                   for i, kind in enumerate(cfg.pattern)},
        "ln_f": {"g": L.rms_norm_spec(cfg.d_model)},
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights from ``seed`` with a ``torch.Generator`` on the
    target device.  They are not the reference's ``jax.random`` weights:
    parity runs bridge those in (``repro_torch.bridge``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return L.init_from_specs(param_specs(cfg), gen, dev)


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-layer views of the stacked block tree, in stack order."""
    def take(tree, j):
        return {k: take(v, j) if isinstance(v, dict) else v[j]
                for k, v in tree.items()}
    out = []
    for layer in range(cfg.num_layers):
        j, i = divmod(layer, len(cfg.pattern))
        out.append(take(params["blocks"][f"p{i}_{cfg.pattern[i]}"], j))
    return out


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding, times ``sqrt(d_model)`` where the config asks for
    gemma's scale."""
    scale = math.sqrt(cfg.d_model) if cfg.scale_embed else 1.0
    return L.embed(params["embed"], tokens, scale)
