"""Parameter tree, init, embedding, the training loss and the dense
serving entry points: the counterpart of ``repro/models/model.py`` (and
of the parts of ``repro/models/transformer.py`` that build the tree).

The tree keeps the reference's layout -- ``params["blocks"]
[f"p{i}_{kind}"]`` with a leading stacked-blocks dim, ``params["embed"]``,
``params["ln_f"]`` and, for zamba2, the unstacked ``params["shared_attn"]``
-- so bridged reference weights drop in as they are.  The port trains the
RoPE attention stacks and serves those, Mamba-2, RWKV-6 and zamba2's
hybrid stack; the MoE, encoder-decoder and vision families come with
later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      MAMBA2, RWKV6, ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ImplConfig

Params = Dict[str, Any]
SUPPORTED_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, MAMBA2, RWKV6, ATTN_SHARED)


def check_family(cfg: ModelConfig) -> None:
    if (any(k not in SUPPORTED_KINDS for k in cfg.pattern)
            or cfg.is_encdec or cfg.family in ("vlm", "audio")):
        raise ValueError(
            f"the port's model covers global/sliding-window attention, "
            f"Mamba-2, RWKV-6 and shared-attention stacks; {cfg.name} has "
            f"pattern={cfg.pattern} family={cfg.family}")


def _stack(specs, nb: int):
    return {k: (_stack(v, nb) if isinstance(v, dict)
                else L.Spec((nb,) + v.shape, v.std))
            for k, v in specs.items()}


def param_specs(cfg: ModelConfig) -> Params:
    """Full parameter spec tree (the reference's ``model_specs``)."""
    check_family(cfg)
    out = {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model,
                               cfg.tie_embeddings),
        "blocks": {f"p{i}_{kind}": _stack(T.block_specs(cfg, kind),
                                          cfg.num_blocks)
                   for i, kind in enumerate(cfg.pattern)},
        "ln_f": T.norm_specs(cfg),
    }
    out.update(T.shared_specs(cfg))
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights from ``seed`` with a ``torch.Generator`` on the
    target device.  They are not the reference's ``jax.random`` weights:
    parity runs bridge those in (``repro_torch.bridge``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return L.init_from_specs(param_specs(cfg), gen, dev)


def _unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` slices of a tree of stacked leaves, as views.  One
    ``unbind`` per leaf, so the gradient of the stacked leaf is one
    ``stack`` and not ``n`` scatters into full-size zeros."""
    out: List[Params] = [{} for _ in range(n)]
    for key, leaf in tree.items():
        parts = _unstack(leaf, n) if isinstance(leaf, dict) \
            else leaf.unbind(0)
        for j in range(n):
            out[j][key] = parts[j]
    return out


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-layer views of the stacked block tree, in stack order."""
    blocks = {key: _unstack(tree, cfg.num_blocks)
              for key, tree in params["blocks"].items()}
    out = []
    for layer in range(cfg.num_layers):
        j, i = divmod(layer, len(cfg.pattern))
        out.append(blocks[f"p{i}_{cfg.pattern[i]}"][j])
    return out


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding, times ``sqrt(d_model)`` where the config asks for
    gemma's scale."""
    scale = math.sqrt(cfg.d_model) if cfg.scale_embed else 1.0
    return L.embed(params["embed"], tokens, scale)


def _shared(params: Params) -> Params:
    return {k: params[k] for k in ("shared_attn",) if k in params}


class Model:
    """The reference's ``Model``: the training loss and the dense serving
    entry points (``prefill``, ``decode_step``), functions over a
    parameter tree with the execution strategy of an :class:`ImplConfig`.
    The serving entry points write into a dense cache tree in place."""

    def __init__(self, cfg: ModelConfig, impl: Optional[ImplConfig] = None):
        check_family(cfg)
        self.cfg = cfg
        self.impl = impl or ImplConfig()

    # -- positions (non-RoPE stacks: rwkv6) ----------------------------------
    def _add_positional(self, x: torch.Tensor, offset: int = 0
                        ) -> torch.Tensor:
        """Sinusoidal positions for stacks without RoPE."""
        if self.cfg.rope_theta > 0:
            return x
        pos = L.sinusoidal_positions(x.shape[1] + offset, self.cfg.d_model,
                                     x.device)[offset:]
        return (x.float() + pos).to(x.dtype)

    def _add_positional_decode(self, x: torch.Tensor, pos: int
                               ) -> torch.Tensor:
        if self.cfg.rope_theta > 0:
            return x
        d = self.cfg.d_model
        i = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
        ang = float(pos) * torch.pow(10_000.0, -i / d)
        pe = torch.zeros(d, dtype=torch.float32, device=x.device)
        pe[0::2] = torch.sin(ang)
        pe[1::2] = torch.cos(ang)
        return (x.float() + pe).to(x.dtype)

    # -- dense cache ---------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   device: DeviceLike = None) -> Params:
        return T.init_cache(self.cfg, batch, cache_len,
                            resolve_device(device))

    # -- entry point: prefill ------------------------------------------------
    def prefill(self, params: Params, tokens: torch.Tensor, cache_len: int,
                cache: Optional[Params] = None, slot: int = 0
                ) -> Tuple[torch.Tensor, Params]:
        """Forward over the prompt ``tokens`` (B, S) -> (last-token logits
        (B, 1, V) fp32, cache).  The decode state after the prompt (KV
        rows past S zeroed) is written in place into ``cache`` at batch
        rows ``slot .. slot + B`` (a new cache of B rows and ``cache_len``
        positions when none is given)."""
        cfg = self.cfg
        if cache is None:
            cache = self.init_cache(tokens.shape[0], cache_len, tokens.device)
        rows = slice(slot, slot + tokens.shape[0])
        x = self._add_positional(embed_tokens(cfg, params, tokens))
        shared = _shared(params)
        for j, bp in enumerate(_unstack(params["blocks"], cfg.num_blocks)):
            for i, kind in enumerate(cfg.pattern):
                key = f"p{i}_{kind}"
                bc = {leaf: t[j, rows] for leaf, t in cache[key].items()}
                x, _ = T.apply_block_prefill(cfg, kind, bp[key], x, shared,
                                             bc)
        x = T.apply_norm(cfg, params["ln_f"], x[:, -1:])
        return L.unembed(params["embed"], x, cfg.logit_softcap), cache

    # -- entry point: decode (one token) -------------------------------------
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, pos: int) -> Tuple[torch.Tensor, Params]:
        """tokens (B, 1) at the shared position ``pos`` -> (logits (B, 1,
        V) fp32, cache updated in place)."""
        cfg = self.cfg
        x = self._add_positional_decode(embed_tokens(cfg, params, tokens),
                                        pos)
        shared = _shared(params)
        for j, bp in enumerate(_unstack(params["blocks"], cfg.num_blocks)):
            for i, kind in enumerate(cfg.pattern):
                key = f"p{i}_{kind}"
                bc = {leaf: t[j] for leaf, t in cache[key].items()}
                x, _ = T.apply_block_decode(cfg, kind, bp[key], x, bc, pos,
                                            shared)
        x = T.apply_norm(cfg, params["ln_f"], x)
        return L.unembed(params["embed"], x, cfg.logit_softcap), cache

    def _run_blocks_train(self, params: Params,
                          x: torch.Tensor) -> torch.Tensor:
        """The stack as a Python loop over pattern blocks; under
        ``remat="full"`` each pattern block keeps only its input and is
        recomputed in the backward."""
        cfg = self.cfg

        def block_body(x, bp):
            for i, kind in enumerate(cfg.pattern):
                x = T.apply_block_train(cfg, kind, bp[f"p{i}_{kind}"], x)
            return x

        body = T._remat(block_body, self.impl.remat)
        for bp in _unstack(params["blocks"], cfg.num_blocks):
            x = body(x, bp)
        return x

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``batch`` ({"tokens", "labels"[, "mask"]},
        (B, S) each) -> (loss, {"ce", "aux"}).  ``aux`` is the MoE balance
        loss, 0 for the families the port trains."""
        cfg = self.cfg
        x = embed_tokens(cfg, params, batch["tokens"])
        x = self._run_blocks_train(params, x)
        x = T.apply_norm(cfg, params["ln_f"], x)
        ce = self._cross_entropy(params, x, batch["labels"],
                                 batch.get("mask"))
        return ce, {"ce": ce, "aux": torch.zeros_like(ce)}

    def _cross_entropy(self, params: Params, x: torch.Tensor,
                       labels: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
        """CE over the vocab head.  With ``impl.loss_chunk`` > 0 dividing
        the sequence, the unembed and CE run over sequence chunks, each
        recomputed in the backward, so the fp32 logits (B, S, V) never
        exist at once."""
        cfg = self.cfg
        c = self.impl.loss_chunk
        s = x.shape[1]
        if c <= 0 or s <= c or s % c:
            logits = L.unembed(params["embed"], x, cfg.logit_softcap)
            return L.softmax_cross_entropy(logits, labels, mask)
        m = (mask.float() if mask is not None
             else torch.ones(labels.shape, device=x.device))

        def chunk(xi, li, mi):
            logits = L.unembed(params["embed"], xi, cfg.logit_softcap)
            return (L.token_nll(logits, li) * mi).sum()

        tot = sum(checkpoint(chunk, x[:, i:i + c], labels[:, i:i + c],
                             m[:, i:i + c], use_reentrant=False)
                  for i in range(0, s, c))
        return tot / m.sum().clamp(min=1.0)
