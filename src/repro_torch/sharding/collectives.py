"""The collectives of a sharded train step, written out.

The reference's sharded training is GSPMD: ``jax.jit`` over the
planner's PartitionSpecs, with the partitioner inserting the
collectives.  The port has no partitioner, so this module holds the ones
it needs, as ``torch.distributed`` calls over a
:class:`~repro_torch.launch.mesh.TorchMesh`'s groups (NCCL on cards with
a rank each; gloo on the CPU or ranks sharing a card): moving a leaf
between two of the planner's layouts (:func:`narrow_to`,
:func:`gather_to`), and the tensor-parallel pair of autograd ops
(:func:`copy_to_tp`, :func:`reduce_from_tp`).  Only ``all_reduce`` and
``all_gather`` are used: gloo has no ``reduce_scatter``, and the same
code runs on both backends.
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
