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

Under a serving plan of a mesh (``Model(layout=...)``, a
``planner.ServeLayout``) every stack the port serves -- the attention,
MoE, Mamba-2, zamba2, RWKV-6, phi-3-vision and whisper stacks -- serves
sharded as the reference's ``lower_cell`` lays out a prefill or decode
cell: each rank holds its blocks of the weights (``param_specs_tree``)
and of the dense cache and recurrent state (``cache_specs_tree``, laid
out once a model: ``Model.cache_layouts``), takes its lanes of the
batch, runs its query and KV heads, ffn columns, experts and SSM/WKV
heads, and returns whole-vocab logits for its lanes.  Under a plan with
FSDP (weight-gathered serving: dbrx-132b's on ``h100x4``) the stored
slices are split over 'data' too; each call gathers the components
outside the blocks to their compute layout once, and each stacked block
just before its forward, freed just after it
(``collectives.gather_for_serving``); with the cache's sequence split
over 'data' as well (a long-context plan) it is refused (ROADMAP item
A8d).
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
from repro_torch.sharding.collectives import (TensorParallel, copy_to_tp,
                                              gather_account, gather_along,
                                              gather_for_serving,
                                              gather_from_tp,
                                              tensor_parallel)

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
                device: DeviceLike = None, layouts=None) -> Params:
    """Random weights from ``seed`` with a ``torch.Generator`` on the
    target device.  They are not the reference's ``jax.random`` weights:
    parity runs bridge those in (``repro_torch.bridge``).  With
    ``layouts`` (a tree of ``planner.Layout``) each leaf is drawn as one
    process draws it and only this rank's block of it is kept."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return L.init_from_specs(param_specs(cfg), gen, dev, layouts=layouts)


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


def lane_block(lanes) -> Tuple[int, int]:
    """(blocks, this rank's block) of the lanes laid out by ``lanes`` (a
    serving model's ``Model.lanes``); (1, 0) for a model of one
    process."""
    return (1, 0) if lanes is None else lanes.part(1)


def gather_lanes(t: torch.Tensor, lanes) -> torch.Tensor:
    """``t`` (B_local, ...) over this rank's lanes -> every lane's, in
    order, on every rank (all-gathered over the axes ``lanes``, a serving
    model's ``Model.lanes``, splits the batch dim over); ``t`` as it is
    for a model of one process."""
    return t if lanes is None else gather_along(t, lanes.mesh, lanes.dims[1])


class Model:
    """The reference's ``Model``: the training loss and the dense serving
    entry points (``prefill``, ``decode_step``), functions over a
    parameter tree with the execution strategy of an :class:`ImplConfig`.
    The serving entry points write into a dense cache tree in place.

    With ``tp`` (the rank's :class:`TensorParallel` group), ``loss_fn``
    runs on this rank's blocks of the planner's compute layout: the heads,
    ffn columns and vocab rows it split over the group, the rest whole.
    That covers every stack the port runs (``SUPPORTED_KINDS``: the
    attention + MLP, MoE, Mamba-2, zamba2, RWKV-6 and whisper stacks, its
    encoder too); an MoE stack's routed experts then run
    expert-parallel over the same axis (``impl.ep_shard_ctx``, which the
    planner's expert layout implies under TP); without ``tp`` and
    ``ep_shard_ctx`` no collective runs.

    With ``shards`` (a sharded train step's
    ``collectives.ShardedParams``), ``loss_fn`` takes this rank's stored
    blocks of the params: the components outside the stacked blocks are
    put on their compute layout at its start, and each pattern block's
    stored slices inside the block's remat body, so that an FSDP-split
    block is gathered for its forward and again for its recompute, and
    its gradient goes to the step's sums as the backward produces it.

    With ``layout`` (a ``planner.ServeLayout``: a serving plan over a
    ``TorchMesh``), ``prefill`` and ``decode_step`` serve sharded: the
    params are this rank's blocks of the plan's ``param_specs_tree``
    (``init_params(..., layouts=layout.params(...))``), ``init_cache``
    makes this rank's blocks of the plan's ``cache_specs_tree`` (their
    layouts ``cache_layouts``, the lanes' ``lanes``), the tokens are this
    rank's lanes, ``tp`` (the plan's ``model`` axis unless given) splits
    the heads, ffn columns and vocab, an MoE stack's experts run
    expert-parallel under ``impl.ep_shard_ctx`` (``serve_step.
    impl_from_plan`` sets it where the plan's ``ep`` is), and a block
    whose cache layout splits the sequence decodes under
    ``impl.decode_shard_ctx``.  Every kind serves so
    (``transformer.SERVE_MESH_KINDS``).  Under a plan with ``fsdp`` the
    params are this rank's stored slices, split over 'data' beyond the
    compute layout (``layout.compute``): ``prefill`` and ``decode_step``
    gather the components outside the blocks once a call and each stacked
    block just before its forward, one block alive at a time
    (``param_layouts``, ``compute_layouts``; :meth:`gather_bytes`).  A
    plan with ``fsdp`` and ``seq_axes`` both (dbrx-132b's ``long_500k``
    on ``h100x4``: the weights and the cache's sequence over 'data') is
    refused, naming ROADMAP item A8d."""

    def __init__(self, cfg: ModelConfig, impl: Optional[ImplConfig] = None,
                 tp: Optional[TensorParallel] = None, shards=None,
                 layout=None):
        check_family(cfg)
        # the stored and compute layouts of weight-gathered serving (None
        # where the stored slices are the compute blocks)
        self.param_layouts = self.compute_layouts = None
        if layout is not None:
            bad = [k for k in cfg.pattern if k not in T.SERVE_MESH_KINDS]
            if bad:
                raise T.serve_mesh_refusal(
                    f"{cfg.name} (pattern {cfg.pattern}) under the plan "
                    f"{layout.plan.mesh.name}")
            if layout.plan.fsdp and layout.plan.seq_axes:
                raise NotImplementedError(
                    f"{cfg.name}: weight-gathered serving with the cache's "
                    f"sequence split over {layout.plan.seq_axes} as well "
                    f"(the plan {layout.plan.mesh.name}'s fsdp and seq_axes: "
                    "a long-context plan) is ROADMAP item A8d")
            if layout.plan.fsdp:
                specs = param_specs(cfg)
                self.param_layouts = layout.params(cfg, specs)
                self.compute_layouts = layout.compute(cfg, specs)
            if tp is None and layout.plan.tp:
                tp = tensor_parallel(layout.mesh)
        if tp is not None and MOE in cfg.pattern and (
                impl is None or impl.ep_shard_ctx is None):
            raise NotImplementedError(
                f"{cfg.name}: under tensor parallelism the routed experts "
                "run expert-parallel over the 'model' axis (the plan's ep, "
                "ImplConfig.ep_shard_ctx); the experts' ffn columns split "
                "over it are not ported")
        self.cfg = cfg
        self.impl = impl or ImplConfig()
        self.tp = tp
        self.shards = shards
        self.layout = layout
        # the cache's stored layout (``cache_specs_tree`` at a batch and a
        # length that split evenly: every cache this model makes has it)
        # and the lanes' (its batch dim's split)
        self.cache_layouts = self.lanes = None
        if layout is not None:
            plan = layout.plan
            self.cache_layouts = layout.cache(cfg, T.cache_specs(
                cfg, layout.mesh.size(plan.batch_axes),
                layout.mesh.size(plan.seq_axes or ("model",))))
            self.lanes = next(iter(next(iter(
                self.cache_layouts.values())).values()))

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
                   device: DeviceLike = None, dtype=None) -> Params:
        """Zeros for ``batch`` lanes of ``cache_len`` positions (the leaves'
        dtypes, or ``dtype``); under a ``layout``, this rank's blocks of
        them, laid out as ``cache_layouts`` (a ``ValueError`` where the
        lanes or positions do not split so)."""
        dev = resolve_device(device)
        if self.layout is None:
            return T.init_cache(self.cfg, batch, cache_len, dev, dtype)
        specs = T.cache_specs(self.cfg, batch, cache_len)
        lay = self.layout.cache(self.cfg, specs)
        if lay != self.cache_layouts:
            plan = self.layout.plan
            raise ValueError(
                f"{self.cfg.name}: a cache of {batch} lanes and {cache_len} "
                f"positions does not split as the plan lays it out (the "
                f"lanes over {plan.batch_axes}, the sequence over "
                f"{plan.seq_axes or ('model',)} where it is split): make "
                f"both multiples of those axes' sizes")
        return {key: {k: torch.zeros(
            lay[key][k].local_shape(s.shape), dtype=dtype or s.dtype,
            device=dev) for k, s in leaf.items()}
            for key, leaf in specs.items()}

    def _seq_split(self, key: str):
        """(mesh, axes) over which block ``key``'s cache stores its
        sequence dim split (``cache_layouts``); None where it is whole."""
        if self.cache_layouts is None or "k" not in self.cache_layouts[key]:
            return None
        lay = self.cache_layouts[key]["k"]
        axes = lay.dims[3]                 # (NB, B, KV, S, hd)
        return (lay.mesh, axes) if lay.mesh.size(axes) > 1 else None

    def _decode_ctx(self, key: str):
        """The ``decode_shard_ctx`` block ``key``'s attention decodes
        under: the impl's where the stored layout splits the sequence
        (over the axes it names), else None (the update and the attention
        are local, as where the planner kept S whole)."""
        split = self._seq_split(key)
        if split is None:
            return None
        ctx = self.impl.decode_shard_ctx
        if ctx is None or tuple(ctx[1]) != split[1]:
            raise ValueError(
                f"{self.cfg.name}: the cache of {key} stores its sequence "
                f"split over {split[1]}; decode needs "
                f"ImplConfig.decode_shard_ctx over those axes (given: "
                f"{None if ctx is None else tuple(ctx[1])})")
        return ctx

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the whole vocab: a vocab-parallel head's
        blocks all-gathered over ``tp``."""
        logits = L.unembed(params["embed"], x, self.cfg.logit_softcap)
        tp = _vocab_split(self.cfg, params, self.tp)
        return logits if tp is None else gather_from_tp(logits, tp, dim=-1)

    # -- frontends (stubs, as in the reference) -------------------------------
    def _encoder(self, params: Params, enc_feats: torch.Tensor,
                 remat: str = "none") -> torch.Tensor:
        """whisper's encoder over precomputed frame embeddings (B, T, d)
        (the conv frontend is a stub): sinusoidal positions, the stacked
        bidirectional layers, each under the ``remat`` policy (training
        passes the plan's, as the reference does), ``ln_f``; with ``tp``,
        each layer's heads and ffn columns this rank's where the planner
        split them."""
        cfg = self.cfg
        enc = params["encoder"]
        x = self._add_positional(enc_feats)
        layer = T._remat(functools.partial(T.apply_encoder_block, cfg,
                                           tp=self.tp), remat)
        for bp in _unstack(enc["blocks"], cfg.num_encoder_layers):
            x = layer(bp, x)
        return T.apply_norm(cfg, enc["ln_f"], x)

    def _vlm_prefix(self, params: Params,
                    img_feats: torch.Tensor) -> torch.Tensor:
        """Stubbed CLIP patch embeddings (B, N, 1024) projected into the
        token stream."""
        return torch.matmul(img_feats, params["img_proj"])

    # -- weight-gathered (FSDP) serving ---------------------------------------
    def _call_params(self, params: Params) -> Params:
        """``params`` with the components outside the stacked blocks on
        their compute layout: gathered here, once a call, where the plan
        has FSDP; ``params`` as they are otherwise."""
        if self.param_layouts is None:
            return params
        rest = {k: v for k, v in params.items() if k != "blocks"}
        out = gather_for_serving(
            rest, {k: self.param_layouts[k] for k in rest},
            {k: self.compute_layouts[k] for k in rest})
        out["blocks"] = params["blocks"]
        return out

    def _block_params(self, bp: Params) -> Params:
        """One stacked block's stored slices (``bp``, by pattern key) on
        their compute layout: gathered where the plan has FSDP (the caller
        drops them before the next block's), ``bp`` otherwise."""
        if self.param_layouts is None:
            return bp
        return gather_for_serving(bp, self.param_layouts["blocks"],
                                  self.compute_layouts["blocks"],
                                  stacked=True)

    def join_gathers(self, params: Params) -> None:
        """The gathers of a ``prefill`` or ``decode_step`` call that this
        rank does not run, in the call's order (the components outside the
        blocks, then each block), each dropped when done: a rank of a data
        group that holds none of a prefill's lanes joins them, since its
        peers over 'data' gather from it.  Nothing where the plan has no
        FSDP."""
        if self.param_layouts is None:
            return
        params = self._call_params(params)
        for stored in _unstack(params["blocks"], self.cfg.num_blocks):
            self._block_params(stored)

    def gather_bytes(self, itemsize: int = 2) -> Tuple[int, int]:
        """(one stacked block's gathered bytes, the gathered components'
        outside the blocks) of weight-gathered serving at ``itemsize``
        bytes a weight: what a call holds beside the stored slices at
        most; (0, 0) where nothing is gathered."""
        if self.param_layouts is None:
            return 0, 0
        return gather_account(param_specs(self.cfg), self.param_layouts,
                              self.compute_layouts, itemsize)

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
        its decoder blocks attend over the encoder's output.

        Under a ``layout``, ``tokens`` are this rank's lanes, ``cache`` and
        ``slot`` this rank's (a new cache: its blocks of the lanes of every
        rank), ``img_feats`` / ``enc_feats`` those lanes' rows, and the
        logits are those lanes' over the whole vocab."""
        cfg = self.cfg
        params = self._call_params(params)
        if cache is None:
            cache = self.init_cache(
                tokens.shape[0] * lane_block(self.lanes)[0], cache_len,
                tokens.device)
        rows = slice(slot, slot + tokens.shape[0])
        x = embed_tokens(cfg, params, tokens, self.tp)
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
        for j, stored in enumerate(_unstack(params["blocks"],
                                            cfg.num_blocks)):
            bp = self._block_params(stored)
            for i, kind in enumerate(cfg.pattern):
                key = f"p{i}_{kind}"
                bc = {leaf: t[j, rows] for leaf, t in cache[key].items()}
                split = self._seq_split(key)
                block = None if split is None else (
                    split[0].size(split[1]), split[0].index(split[1]))
                x, _ = T.apply_block_prefill(cfg, kind, bp[key], x, shared,
                                             bc, enc_out, self.impl, self.tp,
                                             block)
            del bp          # a gathered block is freed before the next one
        x = T.apply_norm(cfg, params["ln_f"], x[:, -1:])
        return self._logits(params, x), cache

    # -- entry point: decode (one token) -------------------------------------
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, pos: int) -> Tuple[torch.Tensor, Params]:
        """tokens (B, 1) at the shared position ``pos`` -> (logits (B, 1,
        V) fp32, cache updated in place).  Under a ``layout``, this rank's
        lanes and cache blocks, the logits over the whole vocab."""
        cfg = self.cfg
        params = self._call_params(params)
        x = self._add_positional_decode(
            embed_tokens(cfg, params, tokens, self.tp), pos)
        shared = _shared(params)
        for j, stored in enumerate(_unstack(params["blocks"],
                                            cfg.num_blocks)):
            bp = self._block_params(stored)
            for i, kind in enumerate(cfg.pattern):
                key = f"p{i}_{kind}"
                bc = {leaf: t[j] for leaf, t in cache[key].items()}
                x, _ = T.apply_block_decode(cfg, kind, bp[key], x, bc, pos,
                                            shared, self.impl, self.tp,
                                            self._decode_ctx(key))
            del bp          # a gathered block is freed before the next one
        x = T.apply_norm(cfg, params["ln_f"], x)
        return self._logits(params, x), cache

    def _run_blocks_train(self, params: Params, x: torch.Tensor,
                          enc_out: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stack as a Python loop over pattern blocks -> (x, the blocks'
        summed aux); under ``remat="full"`` each pattern block keeps only
        its inputs (and under ``"dots"`` its matmuls' outputs too) and is
        recomputed in the backward.  The shared components and the
        encoder's output pass the remat boundary as arguments, so every
        pattern block's recompute reaches them; with ``shards`` the block's
        stored slices are put on their compute layout inside the body."""
        cfg, shards = self.cfg, self.shards

        def block_body(x, bp, shared, enc_out, j):
            if shards is not None:
                bp = shards.block(bp, j)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, kind in enumerate(cfg.pattern):
                x, a = T.apply_block_train(cfg, kind, bp[f"p{i}_{kind}"], x,
                                           shared, enc_out, self.tp,
                                           self.impl)
                aux = aux + a
            return x, aux

        body = T._remat(block_body, self.impl.remat)
        shared = _shared(params)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, bp in enumerate(_unstack(params["blocks"], cfg.num_blocks)):
            x, a = body(x, bp, shared, enc_out, j)
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
        if self.shards is not None:
            params = self.shards.shared(params)
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
