"""Block application for training: the counterpart of the training part
of ``repro/models/transformer.py``.

``ImplConfig`` carries the execution-strategy fields the train step
reads.  ``attn_impl`` and ``attn_chunk`` are kept so a plan moves across
unchanged, but the port's attention is always the flash-attention
kernels on CUDA (the plain forward on CPU), whatever they say: the
reference's ``naive``/``chunked``/``pallas`` choice is one of memory and
XLA program size, and the kernels need neither the full score matrix nor
a chunk loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      DEC_ATTN, ENC_ATTN, MAMBA2, MOE, RWKV6,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

Params = Dict[str, Any]

# block kinds the port does not train yet, and the slice that brings each
_LATER = {
    MOE: "the MoE family's slice",
    RWKV6: "the RWKV-6 slice (kernel K6, rwkv6_wkv)",
    MAMBA2: "the Mamba-2/zamba2 slice (kernel K7, ssd_scan)",
    ATTN_SHARED: "the Mamba-2/zamba2 slice (kernel K7, ssd_scan)",
    ENC_ATTN: "the encoder-decoder (whisper) slice",
    DEC_ATTN: "the encoder-decoder (whisper) slice",
}


@dataclasses.dataclass(frozen=True)
class ImplConfig:
    """Execution-strategy knobs of one invocation (the reference's
    defaults)."""
    attn_impl: str = "naive"          # kept for parity; see module doc
    attn_chunk: int = 1024
    remat: str = "full"               # none | full  ("dots": later slice)
    # stream the unembed+CE over sequence chunks (0 = monolithic logits)
    loss_chunk: int = 0


def _remat(fn: Callable, policy: str) -> Callable:
    """``"none"`` runs ``fn`` as is; ``"full"`` keeps only its inputs and
    recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant)."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        raise ValueError("remat='dots' (save the matmul outputs, recompute "
                         "the rest) comes with a later slice of the port; "
                         "use 'none' or 'full'")
    raise ValueError(f"unknown remat policy {policy!r}")


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(x, p["g"], cfg.norm_eps)


def _attn_mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attn.self_attention_train(p["attn"], h, cfg, causal=True,
                                      window=window)
    h = apply_norm(cfg, p["ln2"], x)
    return x + L.gated_mlp(p["mlp"], h)


def apply_block_train(cfg: ModelConfig, kind: str, p: Params,
                      x: torch.Tensor) -> torch.Tensor:
    """One block of kind ``kind``.  (The reference also returns an aux
    loss, which only MoE blocks make.)"""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        return _attn_mlp_block(cfg, p, x, window=window)
    raise ValueError(f"training a {kind!r} block comes with "
                     f"{_LATER.get(kind, 'a later slice')} of the port")
