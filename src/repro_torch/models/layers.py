"""Shared building blocks: norms, positions, MLPs, embeddings.

Counterpart of ``repro/models/layers.py``.  Plain functions on tensors
over plain parameter dictionaries, in the reference's layouts, so the
tests compare like with like.  ``rms_norm`` goes through the Hopper
RMSNorm kernel's autograd Function on CUDA tensors (its plain version,
differentiated by autograd, on CPU tensors); the large products stay
``torch.matmul`` (the reference leaves them to XLA).  Where no gradient
is taken (serving), ``rms_norm`` calls the kernel's wrapper directly and
builds no autograd node.

The functions that take ``tp`` (a :class:`TensorParallel` group) run
this rank's part of a tensor-parallel layer when one is given: the
gated MLP (and whisper's biased one) column-parallel into ``wi_*`` and
row-parallel out of ``wo``, the embedding and the CE vocab-parallel;
without one they are the one-card code, with no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm
from repro_torch.sharding.collectives import (TensorParallel, all_reduce,
                                              copy_to_tp, reduce_from_tp)

Params = Dict[str, Any]


class Spec(NamedTuple):
    """Parameter leaf spec: shape, the reference's logical axis names (one
    per dim, ``None`` for a dim it names none; ``axes=None`` names none at
    all) and init std (0 = zeros).  The sharding planner reads the axes;
    init reads only shape and std."""
    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None
    std: float = 0.02


def spec_axes(spec: Spec) -> Tuple[Optional[str], ...]:
    """A spec's logical axes, one per dim."""
    if spec.axes is None:
        return (None,) * len(spec.shape)
    if len(spec.axes) != len(spec.shape):
        raise ValueError(f"spec {spec.shape} names {len(spec.axes)} axes "
                         f"{spec.axes}")
    return tuple(spec.axes)


def logical_axes(specs):
    """Spec tree -> logical-axes tree (tuples of axis names)."""
    if isinstance(specs, Spec):
        return spec_axes(specs)
    return {k: logical_axes(v) for k, v in specs.items()}


class CacheSpec(NamedTuple):
    """Decode-state leaf spec: shape + dtype (the reference's
    ``jax.ShapeDtypeStruct``); materialized as zeros."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# the largest piece of a leaf drawn at once (1 GiB in fp32); a larger
# leaf is drawn in runs of its leading dim that fit, so that making a
# full-width MoE expert stack needs no fp32 copy of the whole stack
INIT_SLICE_ELEMS = 1 << 28


def _normal(shape: Tuple[int, ...], std: float, generator: torch.Generator,
            device: torch.device, dtype: torch.dtype,
            out: Optional[torch.Tensor] = None, lay=None) -> torch.Tensor:
    """normal(0, std) drawn in fp32 and cast, in runs of the leading dim of
    at most ``INIT_SLICE_ELEMS`` elements (each slice in turn so, where one
    alone is larger), each run cast straight into ``out`` (a new tensor
    when None), so no more than one run's fp32 draw is held.  With ``lay``
    (a ``planner.Layout``) ``out`` is this rank's block of the leaf: each
    run is drawn whole, so the generator advances as by the whole draw,
    and only its part of the block is kept."""
    if len(shape) == 1 or int(np.prod(shape)) <= INIT_SLICE_ELEMS:
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(std)
        if lay is None and out is None:
            return t.to(dtype)
        if lay is not None:
            t = lay.local(t)
        if out is None:
            out = torch.empty(t.shape, dtype=dtype, device=device)
        return out.copy_(t)
    if out is None:
        out = torch.empty(shape if lay is None else lay.local_shape(shape),
                          dtype=dtype, device=device)
    n0, i0 = (1, 0) if lay is None else lay.part(0)
    lo, hi = i0 * shape[0] // n0, (i0 + 1) * shape[0] // n0
    run = max(1, INIT_SLICE_ELEMS // int(np.prod(shape[1:])))
    for i in range(0, shape[0], run):
        n = min(run, shape[0] - i)
        sub = (n,) + tuple(shape[1:]) if n > 1 else tuple(shape[1:])
        if lay is None:
            _normal(sub, std, generator, device, dtype,
                    out[i:i + n] if n > 1 else out[i])
            continue
        # the run in fp32 where it is one draw (a larger row comes cast),
        # its rows in the block cast as they are copied
        drawn = _normal(sub, std, generator, device,
                        torch.float32 if int(np.prod(sub)) <= INIT_SLICE_ELEMS
                        else dtype).view((n,) + tuple(shape[1:]))
        a, b = max(i, lo), min(i + n, hi)
        if a < b:
            rest = dataclasses.replace(lay, dims=((),) + tuple(lay.dims[1:]))
            out[a - lo:b - lo].copy_(rest.local(drawn[a - i:b - i]))
        del drawn
    return out


def init_from_specs(specs, generator: torch.Generator,
                    device: torch.device, dtype=torch.bfloat16,
                    layouts=None) -> Params:
    """Materialize a parameter tree from a spec tree, leaves in sorted key
    order, by the reference's rules: zeros for std 0 (the ``(1+g)`` norm
    gains, biases), ones for an unstacked std-1 gain (a vector or a square
    matrix), else normal(0, std) drawn in fp32 and cast (:func:`_normal`).
    With ``layouts`` (a tree of ``planner.Layout`` keyed as ``specs``)
    only this rank's block of each leaf is kept, its values one
    process's (:func:`_normal`'s ``lay``): no whole leaf larger than one
    drawn run is ever held."""
    out = {}
    for key in sorted(specs):
        spec = specs[key]
        lay = None if layouts is None else layouts[key]
        if isinstance(spec, dict):
            out[key] = init_from_specs(spec, generator, device, dtype, lay)
            continue
        shape = spec.shape
        if lay is not None and lay.local_shape(shape) != tuple(shape):
            shape = lay.local_shape(shape)
        else:
            lay = None
        if spec.std == 0.0:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
        elif spec.std == 1.0 and (len(spec.shape) == 1 or (
                len(spec.shape) == 2 and spec.shape[0] == spec.shape[1])):
            out[key] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[key] = _normal(spec.shape, spec.std, generator, device,
                               dtype, lay=lay)
    return out


def param_count(specs) -> int:
    """Elements of every ``Spec`` leaf of a spec tree."""
    if isinstance(specs, Spec):
        return int(np.prod(specs.shape))
    return sum(param_count(v) for v in specs.values())


def param_bytes(specs, bytes_per_param: int = 2) -> int:
    return param_count(specs) * bytes_per_param


def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), ("embed",), std=0.0)   # zero-init: (1+g) form


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6,
             split=None) -> torch.Tensor:
    """K3 (``kernels.rmsnorm``) with its Function where a gradient is
    taken on the card; on the CPU plain ops, or the Function with
    ``split`` (rows split over a group: ``kernels.rmsnorm.rmsnorm``),
    whose sums over the group autograd cannot see."""
    if needs_grad(x, gain) and (x.device.type != "cpu" or split is not None):
        return RMSNorm.apply(x, gain, eps, split)
    return rmsnorm(x, gain, eps, split)


def layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics, the gain and bias
    applied as they are (not ``1 + g``); whisper's norms.  Plain ops: the
    reference computes it outside any Pallas kernel."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gain.float() + bias.float()).to(x.dtype)


def group_norm_heads(x: torch.Tensor, gain: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the last dim of (..., H, hd) (RWKV-6's
    ``ln_x``), fp32 statistics; plain ops (no Pallas counterpart)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gain.float()).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int,
                         device: torch.device) -> torch.Tensor:
    """(seq_len, d_model) fp32 sin/cos positions, computed in float64 with
    numpy as the reference does and rounded once."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / np.power(10_000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def needs_grad(*ts: torch.Tensor) -> bool:
    """Will autograd record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).
    Half-split rotation computed in fp32."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    ang = positions[..., :, None].float() * rope_freqs(hd, theta, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp_specs(d_model: int, d_ff: int) -> Params:
    return {"wi_gate": Spec((d_model, d_ff), ("embed", "ffn")),
            "wi_up": Spec((d_model, d_ff), ("embed", "ffn")),
            "wo": Spec((d_ff, d_model), ("ffn", "embed"))}


def gated_mlp(p: Params, x: torch.Tensor,
              tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """With ``tp``, ``p`` holds this rank's ffn columns: the replicated
    input enters through :func:`copy_to_tp` and the partial outputs are
    summed over the group."""
    if tp is not None:
        x = copy_to_tp(x, tp)
    g = torch.matmul(x, p["wi_gate"])
    u = torch.matmul(x, p["wi_up"])
    y = torch.matmul(F.silu(g) * u, p["wo"])
    return y if tp is None else reduce_from_tp(y, tp)


def mlp_specs(d_model: int, d_ff: int) -> Params:
    return {"wi": Spec((d_model, d_ff), ("embed", "ffn")),
            "bi": Spec((d_ff,), ("ffn",), std=0.0),
            "wo": Spec((d_ff, d_model), ("ffn", "embed")),
            "bo": Spec((d_model,), ("embed",), std=0.0)}


def mlp(p: Params, x: torch.Tensor,
        tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """whisper's biased MLP: each bias added to its product's output in the
    activation dtype, and the tanh form of GELU (``jax.nn.gelu``'s
    default, which the reference calls).  With ``tp``, ``p`` holds this
    rank's ffn columns of ``wi`` and ``bi`` and rows of ``wo``: the
    replicated input enters through :func:`copy_to_tp`, the partial
    products are summed over the group, and then the whole ``bo`` is
    added once."""
    if tp is not None:
        x = copy_to_tp(x, tp)
    h = F.gelu(torch.matmul(x, p["wi"]) + p["bi"], approximate="tanh")
    y = torch.matmul(h, p["wo"])
    return (y if tp is None else reduce_from_tp(y, tp)) + p["bo"]


def embed_specs(vocab: int, d_model: int, tie: bool) -> Params:
    out = {"tok": Spec((vocab, d_model), ("vocab", "embed"))}
    if not tie:
        out["head"] = Spec((d_model, vocab), ("embed", "vocab"))
    return out


def embed(p: Params, tokens: torch.Tensor, scale: float = 1.0,
          tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """With ``tp``, ``p["tok"]`` holds this rank's run of vocab rows: ids
    outside it look up zeros, and the rows are summed over the group (one
    rank holds each id, so the sum is exact)."""
    if tp is None:
        x = p["tok"][tokens]
    else:
        rows = p["tok"].shape[0]
        ids = tokens.long() - tp.rank * rows
        inside = (ids >= 0) & (ids < rows)
        x = p["tok"][ids.clamp(0, rows - 1)] * inside[..., None].to(
            p["tok"].dtype)
        x = reduce_from_tp(x, tp)
    if scale != 1.0:
        x = (x.float() * scale).to(x.dtype)
    return x


def unembed(p: Params, x: torch.Tensor,
            softcap: Optional[float] = 0.0) -> torch.Tensor:
    if "head" in p:
        logits = torch.matmul(x, p["head"])
    else:
        logits = torch.matmul(x, p["tok"].t())
    logits = logits.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Per-position negative log-likelihood, fp32: logsumexp minus the
    label logit.  With ``tp``, ``logits`` are this rank's run of the vocab:
    the max and the sum of exponentials are reduced over the group, and
    the label's logit comes from the rank that holds it."""
    logits = logits.float()
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, labels.long()[..., None])[..., 0]
    v = logits.shape[-1]
    m = all_reduce(logits.detach().amax(-1), tp.group, dist.ReduceOp.MAX)
    lse = m + reduce_from_tp((logits - m[..., None]).exp().sum(-1), tp).log()
    ids = labels.long() - tp.rank * v
    inside = (ids >= 0) & (ids < v)
    lab = logits.gather(-1, ids.clamp(0, v - 1)[..., None])[..., 0]
    return lse - reduce_from_tp(lab * inside, tp)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          tp: Optional[TensorParallel] = None
                          ) -> torch.Tensor:
    """Mean CE over valid positions (:func:`token_nll`).  logits fp32
    (..., V); labels (...) integer; mask (...) or None.  (The reference
    contracts with a one-hot to keep a vocab-sharded gather off its SPMD
    partitioner; a gather is exact, and the port's vocab-parallel CE takes
    the label's logit from the rank that holds it.)"""
    nll = token_nll(logits, labels, tp)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
