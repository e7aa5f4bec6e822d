"""Reduced same-family configs: a copy of ``repro/configs/reduced.py``.

Tests and the CPU/CUDA parity check shrink an architecture through this
one function, so the port and the reference run the same small shapes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduced_config(cfg: ModelConfig, **extra) -> ModelConfig:
    """Reduced same-family config for CPU smoke runs."""
    kw = dict(
        num_layers=len(cfg.pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=(max(1, min(cfg.num_kv_heads, 4))
                      if cfg.num_kv_heads < cfg.num_heads else 4),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        encoder_seq_len=16 if cfg.is_encdec else 0,
        num_encoder_layers=2 if cfg.is_encdec else 0,
        num_image_tokens=8 if cfg.family == "vlm" else 0,
        max_context=1 << 30,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=32,
            d_shared_expert=64 if cfg.moe.num_shared_experts else 0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8, head_dim=8,
                                        chunk_size=4)
    kw.update(extra)
    return cfg.scaled(**kw)
