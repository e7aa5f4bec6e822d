"""Parameter tree, init, embedding, the training loss and the dense
serving entry points: the counterpart of ``repro/models/model.py`` (and
of the parts of ``repro/models/transformer.py`` that build the tree).

The tree keeps the reference's layout -- ``params["blocks"]
[f"p{i}_{kind}"]`` with a leading stacked-blocks dim, ``params["embed"]``,
``params["ln_f"]`` and, for zamba2, the unstacked ``params["shared_attn"]``,
phi-3-vision's ``params["img_proj"]`` and whisper's stacked
``params["encoder"]`` -- so bridged reference weights drop in as they
are.  The port trains and serves the RoPE attention stacks, Mamba-2,
RWKV-6, zamba2's hybrid stack, the MoE family, phi-3-vision (image
tokens through ``img_feats``) and whisper (its encoder over
``enc_feats``); the paged backend serves none of the last three, as in
the reference (:func:`pageable`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      DEC_ATTN, MAMBA2, MOE, RWKV6,
                                      ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ImplConfig
from repro_torch.sharding.collectives import TensorParallel, copy_to_tp

Params = Dict[str, Any]
MOE_AUX_WEIGHT = 0.01           # the balance loss's weight in the training loss
SUPPORTED_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, MAMBA2, RWKV6, ATTN_SHARED, MOE,
                   DEC_ATTN)


def check_family(cfg: ModelConfig) -> None:
    """Refuse a config whose blocks the port cannot run."""
    if any(k not in SUPPORTED_KINDS for k in cfg.pattern) or (
            DEC_ATTN in cfg.pattern and not cfg.is_encdec):
        raise ValueError(
            f"the port's model covers global/sliding-window attention, "
            f"Mamba-2, RWKV-6, shared-attention, MoE and encoder-decoder "
            f"stacks; {cfg.name} has pattern={cfg.pattern} "
            f"family={cfg.family}")


def pageable(cfg: ModelConfig) -> bool:
    """Whether the paged backend may serve ``cfg``: not the MoE,
    vision-language or encoder-decoder families, which the reference's
    paged runner refuses too (the dense backend serves them)."""
    return (cfg.family not in ("moe", "vlm", "audio")
            and MOE not in cfg.pattern and not cfg.is_encdec)


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse, before any weights are made, a config that the runtime's
    training path (``Cluster.submit`` with ``SyntheticLM`` batches of
    tokens and labels) cannot feed: an encoder-decoder needs its encoder's
    frames, ``enc_feats``, in every batch, and the reference's executor
    fails with a ``KeyError`` on ``batch["enc_feats"]`` at its first
    step.  ``Model.loss_fn`` and ``make_train_step`` train it with the
    frames in the batch."""
    check_family(cfg)
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its batches need enc_feats "
            "(the encoder's input frames), which the runtime's synthetic "
            "token batches do not hold (the reference fails with a "
            "KeyError on batch['enc_feats'] at its first step); train it "
            "through Model.loss_fn or make_train_step with enc_feats in "
            "the batch")


def param_specs(cfg: ModelConfig) -> Params:
    """Full parameter spec tree (the reference's ``model_specs``)."""
    check_family(cfg)
    out = {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model,
                               cfg.tie_embeddings),
        "blocks": {f"p{i}_{kind}": T.stack_specs(T.block_specs(cfg, kind),
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


def _vocab_split(cfg: ModelConfig, params: Params,
                 tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """``tp`` when the planner split the vocab over it, else None."""
    if tp is None or params["embed"]["tok"].shape[0] == cfg.vocab_size:
        return None
    return tp


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Token embedding, times ``sqrt(d_model)`` where the config asks for
    gemma's scale; vocab-parallel over ``tp`` where the vocab is split."""
    scale = math.sqrt(cfg.d_model) if cfg.scale_embed else 1.0
    return L.embed(params["embed"], tokens, scale,
                   _vocab_split(cfg, params, tp))


def _shared(params: Params) -> Params:
    return {k: params[k] for k in ("shared_attn",) if k in params}


#: the block kinds whose training forward runs tensor-parallel
TP_KINDS = (ATTN_GLOBAL, ATTN_LOCAL)


class Model:
    """The reference's ``Model``: the training loss and the dense serving
    entry points (``prefill``, ``decode_step``), functions over a
    parameter tree with the execution strategy of an :class:`ImplConfig`.
    The serving entry points write into a dense cache tree in place.

    With ``tp`` (the rank's :class:`TensorParallel` group), ``loss_fn``
    runs on this rank's blocks of the planner's compute layout: the heads,
    ffn columns and vocab rows it split over the group, the rest whole.
    That covers the attention + MLP stacks (``TP_KINDS``); without ``tp``
    no collective runs."""

    def __init__(self, cfg: ModelConfig, impl: Optional[ImplConfig] = None,
                 tp: Optional[TensorParallel] = None):
        check_family(cfg)
        if tp is not None and any(k not in TP_KINDS for k in cfg.pattern):
            raise NotImplementedError(
                f"{cfg.name}: the tensor-parallel forward covers attention "
                f"+ MLP stacks ({TP_KINDS}); pattern {cfg.pattern} trains "
                "data-parallel (tp=False)")
        self.cfg = cfg
        self.impl = impl or ImplConfig()
        self.tp = tp

    # -- positions (non-RoPE stacks: rwkv6, whisper) -------------------------
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

    # -- frontends (stubs, as in the reference) -------------------------------
    def _encoder(self, params: Params, enc_feats: torch.Tensor,
                 remat: str = "none") -> torch.Tensor:
        """whisper's encoder over precomputed frame embeddings (B, T, d)
        (the conv frontend is a stub): sinusoidal positions, the stacked
        bidirectional layers, each under the ``remat`` policy (training
        passes the plan's, as the reference does), ``ln_f``."""
        cfg = self.cfg
        enc = params["encoder"]
        x = self._add_positional(enc_feats)
        layer = T._remat(functools.partial(T.apply_encoder_block, cfg), remat)
        for bp in _unstack(enc["blocks"], cfg.num_encoder_layers):
            x = layer(bp, x)
        return T.apply_norm(cfg, enc["ln_f"], x)

    def _vlm_prefix(self, params: Params,
                    img_feats: torch.Tensor) -> torch.Tensor:
        """Stubbed CLIP patch embeddings (B, N, 1024) projected into the
        token stream."""
        return torch.matmul(img_feats, params["img_proj"])

    # -- entry point: prefill ------------------------------------------------
    def prefill(self, params: Params, tokens: torch.Tensor, cache_len: int,
                cache: Optional[Params] = None, slot: int = 0, *,
                img_feats: Optional[torch.Tensor] = None,
                enc_feats: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        """Forward over the prompt ``tokens`` (B, S) -> (last-token logits
        (B, 1, V) fp32, cache).  The decode state after the prompt (KV
        rows past S zeroed) is written in place into ``cache`` at batch
        rows ``slot .. slot + B`` (a new cache of B rows and ``cache_len``
        positions when none is given).

        A vision-language config takes ``img_feats`` (B, N, 1024): their
        projections go ahead of the tokens, so the prompt fills N + S
        positions and decode continues at ``S + N``.  An encoder-decoder
        config needs ``enc_feats`` (B, T, d), the encoder's input frames;
        its decoder blocks attend over the encoder's output."""
        cfg = self.cfg
        if cache is None:
            cache = self.init_cache(tokens.shape[0], cache_len, tokens.device)
        rows = slice(slot, slot + tokens.shape[0])
        x = embed_tokens(cfg, params, tokens)
        if cfg.family == "vlm" and img_feats is not None:
            x = torch.cat([self._vlm_prefix(params, img_feats), x], dim=1)
        x = self._add_positional(x)
        enc_out = None
        if cfg.is_encdec:
            if enc_feats is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: prefill "
                                 "needs enc_feats")
            enc_out = self._encoder(params, enc_feats)
        shared = _shared(params)
        for j, bp in enumerate(_unstack(params["blocks"], cfg.num_blocks)):
            for i, kind in enumerate(cfg.pattern):
                key = f"p{i}_{kind}"
                bc = {leaf: t[j, rows] for leaf, t in cache[key].items()}
                x, _ = T.apply_block_prefill(cfg, kind, bp[key], x, shared,
                                             bc, enc_out)
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

    def _run_blocks_train(self, params: Params, x: torch.Tensor,
                          enc_out: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stack as a Python loop over pattern blocks -> (x, the blocks'
        summed aux); under ``remat="full"`` each pattern block keeps only
        its inputs (and under ``"dots"`` its matmuls' outputs too) and is
        recomputed in the backward.  The shared components and the
        encoder's output pass the remat boundary as arguments, so every
        pattern block's recompute reaches them."""
        cfg = self.cfg

        def block_body(x, bp, shared, enc_out):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, kind in enumerate(cfg.pattern):
                x, a = T.apply_block_train(cfg, kind, bp[f"p{i}_{kind}"], x,
                                           shared, enc_out, self.tp)
                aux = aux + a
            return x, aux

        body = T._remat(block_body, self.impl.remat)
        shared = _shared(params)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp in _unstack(params["blocks"], cfg.num_blocks):
            x, a = body(x, bp, shared, enc_out)
            aux = aux + a
        return x, aux

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``batch`` plus ``MOE_AUX_WEIGHT`` times the
        MoE balance loss -> (loss, {"ce", "aux"}).  ``batch`` holds
        "tokens" and "labels" (B, S)[, "mask"]; a vision-language config
        may add "img_feats" (B, N, 1024), whose projections go ahead of the
        tokens and are dropped after ``ln_f`` (without them it trains on
        the text alone); an encoder-decoder needs "enc_feats" (B, T, d),
        the encoder's input frames."""
        cfg = self.cfg
        x = embed_tokens(cfg, params, batch["tokens"], self.tp)
        n_img = 0
        if cfg.family == "vlm" and "img_feats" in batch:
            x = torch.cat([self._vlm_prefix(params, batch["img_feats"]), x],
                          dim=1)
            n_img = batch["img_feats"].shape[1]
        x = self._add_positional(x)
        enc_out = None
        if cfg.is_encdec:
            if "enc_feats" not in batch:
                raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                                 "training batch needs enc_feats")
            enc_out = self._encoder(params, batch["enc_feats"],
                                    self.impl.remat)
        x, aux = self._run_blocks_train(params, x, enc_out)
        x = T.apply_norm(cfg, params["ln_f"], x)
        if n_img:
            x = x[:, n_img:]
        ce = self._cross_entropy(params, x, batch["labels"],
                                 batch.get("mask"))
        return ce + MOE_AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    def _cross_entropy(self, params: Params, x: torch.Tensor,
                       labels: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
        """CE over the vocab head.  With ``impl.loss_chunk`` > 0 dividing
        the sequence, the unembed and CE run over sequence chunks, each
        recomputed in the backward, so the fp32 logits (B, S, V) never
        exist at once.  Vocab-parallel where the planner split the vocab
        over ``tp``: each rank's logits are its run of the vocab."""
        cfg = self.cfg
        c = self.impl.loss_chunk
        s = x.shape[1]
        tp = _vocab_split(cfg, params, self.tp)
        if tp is not None:
            x = copy_to_tp(x, tp)
        if c <= 0 or s <= c or s % c:
            logits = L.unembed(params["embed"], x, cfg.logit_softcap)
            return L.softmax_cross_entropy(logits, labels, mask, tp)
        m = (mask.float() if mask is not None
             else torch.ones(labels.shape, device=x.device))

        def chunk(xi, li, mi):
            logits = L.unembed(params["embed"], xi, cfg.logit_softcap)
            return (L.token_nll(logits, li, tp) * mi).sum()

        tot = sum(checkpoint(chunk, x[:, i:i + c], labels[:, i:i + c],
                             m[:, i:i + c], use_reentrant=False)
                  for i in range(0, s, c))
        return tot / m.sum().clamp(min=1.0)
