"""The collectives of a sharded train step, written out.

The reference's sharded training is GSPMD: ``jax.jit`` over the
planner's PartitionSpecs, with the partitioner inserting the
collectives.  The port has no partitioner, so this module holds the ones
it needs, as ``torch.distributed`` calls over a
:class:`~repro_torch.launch.mesh.TorchMesh`'s groups (NCCL on cards with
a rank each; gloo on the CPU or ranks sharing a card): moving a leaf
between two of the planner's layouts (:func:`narrow_to`,
:func:`gather_to`), the tensor-parallel pair of autograd ops
(:func:`copy_to_tp`, :func:`reduce_from_tp`), and the expert-parallel
ones: the scatter/gather pair of activations over the ``model`` axis
(:func:`scatter_to_tp`, :func:`gather_from_tp`), the token exchange
(:func:`all_to_all`) and the balance loss's mean over the mesh
(:func:`mesh_mean`).  Only ``all_reduce``, ``all_gather`` and
``all_to_all_single`` are used, which both backends have (gloo has no
``reduce_scatter``), so the same code runs on both.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Tuple

import torch
import torch.distributed as dist

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.sharding.planner import Layout


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's tensor-parallel group: the ranks along the mesh's
    ``model`` axis, ``size`` of them, this rank at ``rank``."""
    group: dist.ProcessGroup
    size: int
    rank: int


def tensor_parallel(mesh) -> "TensorParallel | None":
    """A mesh's tensor-parallel group for this rank: its ``model`` axis,
    or None when that axis is one rank."""
    size = mesh.size(("model",))
    if size == 1:
        return None
    return TensorParallel(mesh.group(("model",)), size, mesh.coords["model"])


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group``; nothing when ``group`` is None (a group
    of this rank alone)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _blocks(t: torch.Tensor, mesh, axes) -> List[torch.Tensor]:
    """``t`` of every rank along ``axes``, ordered by their index along
    ``axes`` (the first axis major)."""
    members = mesh.members(axes)
    outs = [torch.empty_like(t) for _ in members]
    dist.all_gather(outs, t.contiguous(), group=mesh.group(axes))
    blocks: List[torch.Tensor] = [t] * len(members)
    for r, o in zip(members, outs):
        blocks[mesh.index(axes, mesh.coords_of(r))] = o
    return blocks


def _refined(fine: "Layout", coarse: "Layout", dim: int) -> Tuple[str, ...]:
    """The axes ``fine`` splits ``dim`` over beyond ``coarse``'s (whose
    blocks ``fine``'s subdivide, ``coarse``'s axes major)."""
    f, c = fine.dims[dim], coarse.dims[dim]
    if f[:len(c)] != c:
        raise ValueError(f"layout {fine.spec} does not refine {coarse.spec}")
    return f[len(c):]


def narrow_to(local: torch.Tensor, src: "Layout", dst: "Layout") -> torch.Tensor:
    """This rank's block under ``dst`` of a leaf whose block under ``src``
    (a coarser layout) is ``local``: a view, no communication."""
    for d in range(local.dim()):
        rest = _refined(dst, src, d)
        n = dst.mesh.size(rest)
        if n > 1:
            size = local.shape[d] // n
            local = local.narrow(d, dst.mesh.index(rest) * size, size)
    return local


def gather_to(local: torch.Tensor, src: "Layout", dst: "Layout") -> torch.Tensor:
    """This rank's block under ``dst`` (a coarser layout) of a leaf whose
    block under ``src`` is ``local``: all-gathered along the axes ``src``
    splits beyond ``dst``."""
    for d in range(local.dim()):
        rest = _refined(src, dst, d)
        if src.mesh.size(rest) > 1:
            local = torch.cat(_blocks(local, src.mesh, rest), dim=d)
    return local


def gather_full(local: torch.Tensor, layout: "Layout") -> torch.Tensor:
    """The whole leaf, on every rank."""
    return gather_to(local, layout, dataclasses.replace(
        layout, dims=((),) * len(layout.dims)))


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tensor-parallel
    group in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the tensor-parallel group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Mark ``x``, the same on every rank of the group, as the input of
    per-rank work: a replicated activation entering column-parallel
    products, or a replicated weight applied to this rank's heads only.
    Each rank's gradient of it is a part; the backward sums them."""
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of every rank's partial ``x`` (a row-parallel product's
    output, a vocab-parallel gather), the same on every rank after."""
    return _ReduceFromTP.apply(x, tp.group)


def _cat_group(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group rank order."""
    outs = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(outs, x.contiguous(), group=tp.group)
    return torch.cat(outs, dim=dim)


def _own_block(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    size = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * size, size)


class _ScatterToTP(torch.autograd.Function):
    """This rank's block of ``dim`` forward; the blocks' gradients
    all-gathered backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _own_block(x, tp, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _cat_group(g, ctx.tp, ctx.dim), None, None


class _GatherFromTP(torch.autograd.Function):
    """Every rank's block all-gathered along ``dim`` forward; this rank's
    block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _cat_group(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.tp, ctx.dim).contiguous(), None, None


def scatter_to_tp(x: torch.Tensor, tp: TensorParallel,
                  dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` the same on every
    rank of the group, its gradient too): the expert-parallel token
    slice, ``shard_map``'s in-spec over ``model`` on a replicated
    activation.  The backward all-gathers the blocks' gradients, so every
    rank holds the whole gradient of ``x`` again."""
    return _ScatterToTP.apply(x, tp, dim)


def gather_from_tp(x: torch.Tensor, tp: TensorParallel,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim``, the same on
    every rank after (``shard_map``'s out-spec over ``model``); the
    backward keeps this rank's block of the (replicated) gradient.  A
    weight split over the group whose whole is applied to per-rank work
    (the router's expert columns) goes through :func:`copy_to_tp` after
    this, so that its partial gradients are summed first."""
    return _GatherFromTP.apply(x, tp, dim)


class _AllToAll(torch.autograd.Function):
    """Block ``j`` of dim 0 to rank ``j`` of the group; block ``i`` of the
    result from rank ``i``.  Its own reverse: the backward sends the
    gradients' blocks back the same way."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _exchange(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.tp), None


def _exchange(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=tp.group)
    all_to_all.routes[str(dist.get_backend(tp.group))] += 1
    return out


def all_to_all(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The expert-parallel token exchange over the group: ``x`` (n, ...),
    block ``j`` of dim 0 sent to rank ``j``; the result's block ``i`` is
    rank ``i``'s block for this rank.  ``all_to_all.routes`` counts the
    exchanges by backend: ``nccl``, or ``gloo`` (CPU tensors, or a card's
    tensors as they are where ranks share a card)."""
    if x.shape[0] != tp.size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} must be "
                         f"the group's {tp.size} ranks")
    return _AllToAll.apply(x, tp)


all_to_all.routes = {"nccl": 0, "gloo": 0}


def mesh_mean(x: torch.Tensor, tp: TensorParallel, mesh) -> torch.Tensor:
    """The mean of a per-rank scalar over every rank of ``mesh`` (the
    reference's ``pmean`` over all axes), with the gradient of its mean
    over the group ``tp`` alone: the train step itself averages the
    gradients over the batch axes, so the batch axes' share of the mean
    must not scale them a second time."""
    over_tp = reduce_from_tp(x, tp) / tp.size
    total = all_reduce(x.detach().clone(), mesh.world) / mesh.spec.num_devices
    return over_tp + (total - over_tp.detach())
