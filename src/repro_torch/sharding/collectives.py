"""The collectives of a sharded train step and of sharded serving,
written out.

The reference's sharded training is GSPMD: ``jax.jit`` over the
planner's PartitionSpecs, with the partitioner inserting the
collectives.  The port has no partitioner, so this module holds the ones
it needs, as ``torch.distributed`` calls over a
:class:`~repro_torch.launch.mesh.TorchMesh`'s groups (NCCL on cards with
a rank each; gloo on the CPU or ranks sharing a card): moving a leaf
between two of the planner's layouts (:func:`gather_to`), the step's
view of its stored params (:class:`ShardedParams`: each stacked block
all-gathered into its compute layout where the model applies it, one
block at a time, by an autograd op whose backward sums the block's
gradients over the batch axes straight into this rank's optimizer
slices: a :func:`reduce_scatter` over the axes a slice splits beyond
the compute layout, an all-reduce over the rest, one collective for the
leaves of a block that share their axes), the
tensor-parallel pair of autograd ops (:func:`copy_to_tp`,
:func:`reduce_from_tp`), and the expert-parallel ones: the
scatter/gather pair of activations over the ``model`` axis
(:func:`scatter_to_tp`, :func:`gather_from_tp`), the token exchange
(:func:`all_to_all`) and the balance loss's mean over the mesh
(:func:`mesh_mean`).  Sharded serving adds two forward-only ones: the
blocks of a tensor along a dim, concatenated in the mesh's block order
on every rank (:func:`gather_along`: the lanes' next tokens over the
batch axes), and the merge of the partial softmax states of a
sequence-sharded decode (:func:`combine_softmax_parts`: each rank's
attention output over its block of the cache and its log-sum-exp,
all-gathered over the sequence axes and combined in fp32), and
weight-gathered serving's gather of a block's stored slices to its
compute layout (:func:`gather_for_serving`, no autograd).  Only
``all_reduce``, ``all_gather``, ``reduce_scatter`` and
``all_to_all_single`` are used, which both backends have, card tensors
included (and, on NCCL, ``all_gather_into_tensor``: every all-gather
writes one buffer of the ranks' blocks), so the same code runs on both;
a collective's error raises.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import tree_unflatten

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


def _blocks(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` of every rank along ``axes`` in one (n, *t.shape) buffer,
    ordered by their index along ``axes`` (the first axis major): one
    all-gather into the buffer on NCCL where the group's order is the
    block order, else into its views block by block (gloo stages each
    through the host anyway)."""
    members = mesh.members(axes)
    group = mesh.group(axes)
    out = torch.empty((len(members),) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    order = [mesh.index(axes, mesh.coords_of(r)) for r in members]
    if order == list(range(len(order))) and \
            dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    else:
        dist.all_gather([out[i] for i in order], t.contiguous(), group=group)
    return out


def _joined(blocks: torch.Tensor, dim: int) -> torch.Tensor:
    """The blocks of :func:`_blocks` side by side along ``dim``: the
    buffer itself, viewed, for dim 0."""
    if dim == 0:
        return blocks.flatten(0, 1)
    return torch.cat(blocks.unbind(0), dim=dim)


def gather_along(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axes`` concatenated along ``dim`` in
    their block order (the first axis major), the same on every rank;
    ``t`` itself when ``axes`` span one rank."""
    if mesh.size(axes) == 1:
        return t
    return _joined(_blocks(t, mesh, axes), dim)


def merge_softmax_parts(outs: torch.Tensor,
                        lses: torch.Tensor) -> torch.Tensor:
    """The attention over the union of disjoint key blocks from each
    block's own: ``outs`` (R, ..., D), each block's softmax-weighted
    values, and ``lses`` (R, ...), each block's log-sum-exp of its scores
    (-inf for a block with no key).  In fp32: lse* = logsumexp_r lse_r,
    out = sum_r exp(lse_r - lse*) out_r, summed in block order; a row
    whose every block is empty gives 0.  Returns (..., D) in ``outs``'
    dtype."""
    lses = lses.float()
    top = torch.logsumexp(lses, dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.exp(lses - top)                 # 0 where lse_r = -inf
    out = (w[..., None] * outs.float()).sum(0)
    return out.to(outs.dtype)


def combine_softmax_parts(out: torch.Tensor, lse: torch.Tensor, mesh,
                          axes) -> torch.Tensor:
    """A sequence-sharded decode's attention: this rank's ``out`` (B, H,
    D) over its block of the cache and ``lse`` (B, H) fp32, all-gathered
    over the sequence ``axes`` in block order and merged
    (:func:`merge_softmax_parts`), the same on every rank of the group.
    Forward only."""
    return merge_softmax_parts(_blocks(out, mesh, axes),
                               _blocks(lse.float(), mesh, axes))


def _refined(fine: "Layout", coarse: "Layout", dim: int) -> Tuple[str, ...]:
    """The axes ``fine`` splits ``dim`` over beyond ``coarse``'s (whose
    blocks ``fine``'s subdivide, ``coarse``'s axes major)."""
    f, c = fine.dims[dim], coarse.dims[dim]
    if f[:len(c)] != c:
        raise ValueError(f"layout {fine.spec} does not refine {coarse.spec}")
    return f[len(c):]


def gather_to(local: torch.Tensor, src: "Layout", dst: "Layout") -> torch.Tensor:
    """This rank's block under ``dst`` (a coarser layout) of a leaf whose
    block under ``src`` is ``local``: all-gathered along the axes ``src``
    splits beyond ``dst``."""
    for d in range(local.dim()):
        rest = _refined(src, dst, d)
        if src.mesh.size(rest) > 1:
            local = _joined(_blocks(local, src.mesh, rest), d)
    return local


def gather_full(local: torch.Tensor, layout: "Layout") -> torch.Tensor:
    """The whole leaf, on every rank."""
    return gather_to(local, layout, dataclasses.replace(
        layout, dims=((),) * len(layout.dims)))


def reduce_scatter(inputs: List[torch.Tensor], mesh, axes) -> torch.Tensor:
    """The sum over the ranks along ``axes`` of their ``inputs[j]``, on
    the ``j``-th rank of the group (``mesh.members(axes)``'s order): this
    rank's block of the sum.  ``reduce_scatter.routes`` counts the calls
    by backend (gloo takes a card's tensors here as NCCL does)."""
    group = mesh.group(axes)
    out = torch.empty_like(inputs[0])
    dist.reduce_scatter(out, inputs, group=group)
    reduce_scatter.routes[str(dist.get_backend(group))] += 1
    return out


reduce_scatter.routes = {"nccl": 0, "gloo": 0}


#: the bytes of gathered compute blocks alive at once (``live``) and the
#: most alive at any time since ``peak`` was last set to 0; each gathered
#: tensor's storage is counted until it is freed
gathered_bytes = {"live": 0, "peak": 0}


def _release(n: int) -> None:
    gathered_bytes["live"] -= n


def _track(t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    gathered_bytes["live"] += n
    gathered_bytes["peak"] = max(gathered_bytes["peak"],
                                 gathered_bytes["live"])
    weakref.finalize(t.untyped_storage(), _release, n)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """One stored block of a leaf: its three layouts and where its fp32
    gradient sum is (block ``index`` of the leaf ``path`` of the step's
    sums, or the whole leaf when ``index`` is None)."""
    params: "Layout"
    compute: "Layout"
    opt: "Layout"
    owner: "ShardedParams"
    path: Tuple[str, ...]
    index: Optional[int] = None

    def acc(self) -> torch.Tensor:
        t = self.owner.sum_of(self.path)
        return t if self.index is None else t[self.index]


def _split(fine: "Layout", coarse: "Layout"):
    """(dim, axes): the one dim ``fine`` splits beyond ``coarse`` and the
    mesh axes it splits it over, or None when ``fine`` is ``coarse``."""
    found = [(d, _refined(fine, coarse, d)) for d in range(len(fine.dims))]
    found = [(d, a) for d, a in found if fine.mesh.size(a) > 1]
    if len(found) > 1:
        raise NotImplementedError(f"{fine.spec} splits {coarse.spec} further "
                                  "along more than one dim")
    return found[0] if found else None


def _gather_blocks(locals_, slots) -> List[torch.Tensor]:
    """Each stored block on its compute layout: the ones the params layout
    splits further all-gathered, one collective for the blocks split over
    the same axes (their flat concatenation), the rest as they are."""
    outs = [t.view_as(t) for t in locals_]
    by_axes: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
    for i, s in enumerate(slots):
        split = _split(s.params, s.compute)
        if split is not None:
            by_axes.setdefault(split[1], []).append((i, split[0]))
    for axes, items in by_axes.items():
        mesh = slots[items[0][0]].params.mesh
        flat = torch.cat([locals_[i].reshape(-1) for i, _ in items])
        parts = [p.split([locals_[i].numel() for i, _ in items])
                 for p in _blocks(flat, mesh, axes).unbind(0)]
        del flat
        for j, (i, d) in enumerate(items):
            outs[i] = torch.cat([p[j].view(locals_[i].shape) for p in parts],
                                dim=d)
            _track(outs[i])
    return outs


#: the most gradient elements one reduction takes at once (their fp32
#: copy is 256 MiB); a larger leaf is reduced alone
REDUCE_BUCKET_ELEMS = 1 << 26


def _reduce_blocks(grads, slots, batch_axes) -> None:
    """Each block's gradient (compute layout) summed over ``batch_axes``
    into its fp32 sum on the optimizer layout: reduce-scattered over the
    axes the optimizer layout splits beyond the compute layout (ZeRO's and
    FSDP's, each one of the batch axes) and all-reduced over the other
    batch axes, in fp32, one collective each for a run of blocks of one
    such pattern (their flat concatenation, up to
    ``REDUCE_BUCKET_ELEMS``).  A block that took no gradient adds
    nothing."""
    buckets: Dict[Tuple[str, ...], list] = {}
    for g, s in zip(grads, slots):
        if g is None:
            continue
        split = _split(s.opt, s.compute)
        d, axes = split if split is not None else (None, ())
        if not set(axes) <= set(batch_axes):
            raise ValueError(f"the optimizer layout {s.opt.spec} splits over "
                             f"{axes}, outside the batch axes "
                             f"{tuple(batch_axes)}")
        run = buckets.setdefault(axes, [[]])
        if run[-1] and sum(x[0].numel() for x in run[-1]) + g.numel() \
                > REDUCE_BUCKET_ELEMS:
            run.append([])
        run[-1].append((g, s, d))
    for axes, items in ((a, i) for a, runs in buckets.items()
                        for i in runs):
        mesh = items[0][1].compute.mesh
        n = mesh.size(axes)
        shapes = []
        for g, _, d in items:
            shape = list(g.shape)
            if d is not None:
                shape[d] //= n
            shapes.append(shape)
        sizes = [math.prod(shape) for shape in shapes]
        inputs = []
        for r in mesh.members(axes):
            k = mesh.index(axes, mesh.coords_of(r))
            buf = torch.empty(sum(sizes), dtype=torch.float32,
                              device=items[0][0].device)
            for piece, (g, _, d), shape in zip(buf.split(sizes), items,
                                               shapes):
                block = g if d is None else g.narrow(d, k * shape[d],
                                                     shape[d])
                piece.view(shape).copy_(block)
            inputs.append(buf)
        out = reduce_scatter(inputs, mesh, axes) if axes else inputs[0]
        del inputs
        all_reduce(out, mesh.group(tuple(a for a in batch_axes
                                         if a not in axes)))
        for piece, (_, s, _), shape in zip(out.split(sizes), items, shapes):
            s.acc().add_(piece.view(shape))


class _Materialize(torch.autograd.Function):
    """Stored blocks forward: their compute blocks, all-gathered where the
    params layout splits them further (FSDP; :func:`_gather_blocks`).
    Backward: their gradients summed over the batch axes into their fp32
    sums on the optimizer layout (:func:`_reduce_blocks`); no gradient is
    returned, so none is held.  ``anchor`` is a 0-d tensor that requires
    a gradient, which makes autograd call the backward."""

    @staticmethod
    def forward(ctx, anchor, slots, batch_axes, *locals_):
        ctx.slots, ctx.batch_axes = slots, batch_axes
        ctx.set_materialize_grads(False)
        return tuple(_gather_blocks(locals_, slots))

    @staticmethod
    def backward(ctx, *grads):
        _reduce_blocks(grads, ctx.slots, ctx.batch_axes)
        return (None,) * (3 + len(grads))


def _drop_dim0(lay: "Layout") -> "Layout":
    return dataclasses.replace(lay, dims=lay.dims[1:])


def _paths(tree, prefix=()) -> List[Tuple[str, ...]]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                         prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class ShardedParams:
    """A sharded train step's view of this rank's stored params (``lay``,
    a ``PlanLayouts``): :meth:`shared` gives the components outside the
    stacked blocks (the embedding and head, ``ln_f``, zamba2's
    ``shared_attn``, ...) on their compute layout, once a microbatch, and
    :meth:`block` one stacked block's leaves, which the model calls inside
    each block's remat body, so an FSDP-split block is gathered for its
    forward, freed, and gathered again in its recompute; each is one
    autograd op (:class:`_Materialize`).  Each leaf's gradient goes into
    its fp32 sum on the optimizer layout, reduced over ``batch_axes``,
    when the backward has produced the gradients of its block (or of the
    shared components); a sum is allocated at its first gradient
    (:meth:`begin`, :meth:`end`), so the first microbatch's forward holds
    none."""

    def __init__(self, lay, batch_axes, device):
        self.lay = lay
        self.batch_axes = tuple(batch_axes)
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self._like: Any = None
        self._sums: Dict[Tuple[str, ...], torch.Tensor] = {}

    def begin(self, like) -> None:
        """Sums shaped as ``like``'s leaves (the fp32 master params on the
        optimizer layout), made as the gradients come."""
        self._like, self._sums = like, {}

    def sum_of(self, path) -> torch.Tensor:
        if path not in self._sums:
            self._sums[path] = torch.zeros_like(_at(self._like, path))
        return self._sums[path]

    def end(self) -> Any:
        """The sums as a tree of ``like``'s (zeros for a leaf no gradient
        reached, as under ``jax.grad``)."""
        out = tree_unflatten(self._like, [self.sum_of(p)
                                          for p in _paths(self._like)])
        self._like, self._sums = None, {}
        return out

    def _materialize(self, tree, prefix, index=None):
        paths = _paths(tree)
        slots = []
        for path in paths:
            lays = [_at(t, prefix + path) for t in (
                self.lay.params, self.lay.compute, self.lay.opt)]
            if index is not None:
                lays = [_drop_dim0(x) for x in lays]
            slots.append(_Slot(*lays, self, prefix + path, index))
        outs = _Materialize.apply(self.anchor, tuple(slots), self.batch_axes,
                                  *(_at(tree, p) for p in paths))
        return tree_unflatten(tree, outs)

    def shared(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with every component but ``blocks`` on its compute
        layout (gathered here, held through the microbatch's backward)."""
        rest = {k: v for k, v in params.items() if k != "blocks"}
        return dict(self._materialize(rest, ()), blocks=params["blocks"])

    def block(self, bp: Dict[str, Any], index: int) -> Dict[str, Any]:
        """Block ``index`` of the stacked ``blocks`` (``bp``, its stored
        slices by pattern key) on its compute layout."""
        return self._materialize(bp, ("blocks",), index)


def gather_for_serving(tree, stored, compute, stacked: bool = False):
    """This rank's stored slices ``tree`` (a dict tree of tensors) on their
    compute layout, for a forward: weight-gathered (FSDP) serving's
    gather, with no autograd and no gradient sum (the train step's is
    :class:`ShardedParams`).  ``stored`` and ``compute`` are the leaves'
    layout trees (``planner.ServeLayout.params`` / ``.compute``); with
    ``stacked`` the tree is one block of stacked leaves, whose layouts
    keep the stacked dim.  Each leaf split over 'data' beyond its compute
    layout is all-gathered (:func:`gather_to`; a dim-0 split is the
    gather's buffer as it lands), the others are returned as they are;
    the gathered tensors count in ``gathered_bytes`` until they are
    freed."""
    with torch.no_grad():
        return _serve_tree(tree, stored, compute, stacked)


def _serve_tree(tree, stored, compute, stacked):
    if isinstance(tree, dict):
        return {k: _serve_tree(v, stored[k], compute[k], stacked)
                for k, v in tree.items()}
    if stacked:
        stored, compute = _drop_dim0(stored), _drop_dim0(compute)
    out = gather_to(tree, stored, compute)
    if out is not tree:
        _track(out)
    return out


def gather_account(specs, stored, compute, itemsize: int = 2):
    """(bytes of one stacked block's gathered leaves, bytes of the gathered
    components outside the blocks): the compute-layout bytes of each leaf
    of the spec tree ``specs`` (``layers.Spec`` leaves) that ``stored``
    splits beyond ``compute``, at ``itemsize`` bytes an element -- what
    :func:`gather_for_serving` holds at most at once beside the stored
    slices, block by block."""
    block = shared = 0
    for path in _paths(specs):
        spec, lp, lc = (_at(t, path) for t in (specs, stored, compute))
        if _split(lp, lc) is None:
            continue
        shape = lc.local_shape(spec.shape)
        if path[0] == "blocks":
            block += math.prod(shape[1:]) * itemsize
        else:
            shared += math.prod(shape) * itemsize
    return block, shared


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
