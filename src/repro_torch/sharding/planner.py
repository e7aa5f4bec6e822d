"""Sharding planner: Plan + logical axes -> per-leaf PartitionSpecs and
their layouts over a torch mesh.

The port's copy of ``repro/sharding/planner.py``, host arithmetic over
the port's spec trees.  The materializer decides the *placement
strategy* (which components are local vs. sharded); this module
translates that into per-leaf PartitionSpecs, guarding divisibility (a
dim that does not divide its mesh axes falls back to replication -- e.g.
GQA KV heads of 8 on a 16-way model axis).

``PartitionSpec`` is the port's own: a tuple whose entries are ``None``,
a mesh axis name or a tuple of names, so it compares equal to the tuple
of the reference's ``jax.sharding.PartitionSpec``.  Where the reference
binds a spec to a device mesh (``to_named``), :func:`to_layout` gives
each leaf its :class:`Layout` over a torch mesh
(``repro_torch.launch.mesh``): per dim, the mesh axes it is split over,
the first axis major as in JAX, and so the contiguous block this rank
holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.materializer import Plan
from repro_torch.models import layers as L

FSDP_MIN_ELEMS = 1 << 16


class PartitionSpec(tuple):
    """Per-dim entries: ``None`` (replicated), a mesh axis name, or a
    tuple of names (split over their product, the first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):          # pickle rebuilds it from its entries
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_size(mesh_spec, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh_spec.axis_size(a)
    return n


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def logical_rules(plan: Plan, cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """logical axis name -> mesh axes tuple (before divisibility checks)."""
    tp: Tuple[str, ...] = ("model",) if plan.tp else ()
    return {
        "vocab": tp,
        "embed": (),
        "embed2": tp,
        "q_heads": tp,
        "kv_heads": tp,
        "head_dim": (),
        "ffn": tp,
        "experts": ("model",) if plan.ep else (),
        "expert_ffn": () if plan.ep else tp,
        "ssm_inner": tp,
        "ssm_heads": tp,
        "ssm_state": (),
        "ssm_conv": (),
        "conv_w": (),
        "blocks": (),
        "lora": (),
        None: (),
    }


def spec_for_leaf(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  rules: Dict, plan: Plan,
                  extra_axes: Tuple[str, ...] = ()) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (divisibility-guarded).

    ``extra_axes``: mesh axes over which to additionally shard the largest
    still-unsharded dim (FSDP over 'data'; ZeRO over the full DP group)."""
    entries = []
    used = set()
    for dim, ax in enumerate(axes):
        mesh_axes = rules.get(ax, ())
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        if mesh_axes and shape[dim] % _axes_size(plan.mesh, mesh_axes) == 0:
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            entries.append(None)
    extra = tuple(a for a in extra_axes if a not in used)
    if extra and int(np.prod(shape)) >= FSDP_MIN_ELEMS:
        sz = _axes_size(plan.mesh, extra)
        # preference order (the reference measured that sharding the
        # contraction ('embed') dim makes its partitioner all-reduce
        # activations per matmul instead of gathering the smaller weights):
        #   1. extend an already model-sharded (non-contracting) dim;
        #   2. largest unsharded non-'embed' dim;
        #   3. largest unsharded dim (embed as last resort).
        if getattr(plan, "fsdp_contracting", False):
            # legacy layout family: largest unsharded dim, embed included
            cands = [(shape[d], d) for d in range(len(shape))
                     if entries[d] is None and shape[d] % sz == 0
                     and axes[d] != "blocks"]
            if cands:
                _, d = max(cands)
                entries[d] = extra if len(extra) > 1 else extra[0]
            return P(*entries)
        ext = None
        for d in range(len(shape)):
            cur = entries[d]
            if cur is None or axes[d] == "blocks":
                continue
            cur_t = cur if isinstance(cur, tuple) else (cur,)
            if shape[d] % (_axes_size(plan.mesh, cur_t) * sz) == 0:
                ext = (d, cur_t + extra)
                break
        if ext is not None:
            d, spec = ext
            entries[d] = spec
        else:
            cands = [(shape[d], d) for d in range(len(shape))
                     if entries[d] is None and shape[d] % sz == 0
                     and axes[d] != "blocks"]
            non_embed = [(n, d) for n, d in cands if axes[d] != "embed"]
            pool = non_embed or cands
            if pool:
                _, d = max(pool)
                entries[d] = extra if len(extra) > 1 else extra[0]
    return P(*entries)


def _zero_axes(plan: Plan) -> Tuple[str, ...]:
    """ZeRO shards optimizer state over the full data-parallel group."""
    return plan.batch_axes or ("data",)


def param_specs_tree(plan: Plan, cfg: ModelConfig, specs) -> Any:
    """Spec (``layers.Spec``) tree -> PartitionSpec tree."""
    rules = logical_rules(plan, cfg)
    extra = ("data",) if plan.fsdp else ()
    return _tree_map(lambda s: spec_for_leaf(L.spec_axes(s), s.shape, rules,
                                             plan, extra), specs)


def opt_state_specs_tree(plan: Plan, cfg: ModelConfig, specs) -> Any:
    """Optimizer-state sharding: params rules + ZeRO over the DP group."""
    rules = logical_rules(plan, cfg)
    extra: Tuple[str, ...] = ()
    if plan.fsdp:
        extra = ("data",)
    elif plan.zero:
        extra = _zero_axes(plan)
    return _tree_map(lambda s: spec_for_leaf(L.spec_axes(s), s.shape, rules,
                                             plan, extra), specs)


def compute_specs_tree(plan: Plan, cfg: ModelConfig, specs) -> Any:
    """The layout the forward and backward run on: the params' layout
    without FSDP's split over 'data' (the reference's partitioner gathers
    those dims where a product needs them; the port gathers a stacked
    block's inside its remat body, ``collectives.ShardedParams``)."""
    return param_specs_tree(dataclasses.replace(plan, fsdp=False), cfg,
                            specs)


def batch_spec(plan: Plan, extra_dims: int = 1) -> PartitionSpec:
    """Sharding for (B, S, ...) batch arrays."""
    b = plan.batch_axes if plan.batch_axes else None
    if len(plan.batch_axes) == 1:
        b = plan.batch_axes[0]
    return P(b, *([None] * extra_dims))


def activation_spec(plan: Plan) -> PartitionSpec:
    """(B, S, D) activation constraint."""
    b = plan.batch_axes or None
    if b and len(b) == 1:
        b = b[0]
    return P(b, None, None)


def cache_specs_tree(plan: Plan, cfg: ModelConfig, cache_specs) -> Any:
    """KV-cache / recurrent-state sharding specs over a tree of
    ``CacheSpec`` leaves (stacked: leading NB dim), each leaf's kind told
    by its key (the reference keys by pytree path):

      k / v / cross_k / cross_v : (NB, B, KV, S, hd) -> batch, heads|seq
      wkv                       : (NB, B, H, hd, hd) -> batch, heads?
      ssm                       : (NB, B, H, P, N)   -> batch, heads?
      conv / shift_t / shift_c  : batch only
    """
    mesh_spec = plan.mesh
    tp_size = mesh_spec.axis_size("model")
    batch = plan.batch_axes or None
    if batch and len(batch) == 1:
        batch = batch[0]

    def bspec_for(shp) -> Any:
        if batch is None:
            return None
        if shp[1] % _axes_size(mesh_spec, plan.batch_axes) != 0:
            return None
        return batch

    def leaf(key: str, s) -> PartitionSpec:
        shp = s.shape
        bspec = bspec_for(shp)
        if key in ("k", "v", "cross_k", "cross_v"):
            kv_spec = seq_spec = None
            if plan.kv_shard_heads and shp[2] % tp_size == 0:
                kv_spec = "model"
            elif plan.kv_shard_seq or plan.seq_axes:
                cand = plan.seq_axes or ("model",)
                if shp[3] % _axes_size(mesh_spec, cand) == 0:
                    seq_spec = cand if len(cand) > 1 else cand[0]
            return P(None, bspec, kv_spec, seq_spec, None)
        if key in ("wkv", "ssm"):
            hspec = "model" if (plan.tp and shp[2] % tp_size == 0) else None
            return P(None, bspec, hspec, None, None)
        return P(*([None, bspec] + [None] * (len(shp) - 2)))

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf(key, tree)

    return walk(cache_specs)


def ep_dispatch_spec(plan: Plan) -> Optional[PartitionSpec]:
    """(E, C, D) dispatch-buffer constraint for MoE expert parallelism."""
    if not plan.ep:
        return None
    cdim = plan.batch_axes or None
    if cdim and len(cdim) == 1:
        cdim = cdim[0]
    return P("model", cdim, None)


# ---------------------------------------------------------------------------
# layouts over a torch mesh
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    """A PartitionSpec entry as the tuple of mesh axes it splits over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Layout:
    """One leaf's placement over a torch mesh: per dim, the mesh axes it
    is split over (the first major).  ``mesh`` is a
    ``repro_torch.launch.mesh.TorchMesh`` (its ``spec`` and this rank's
    ``coords``)."""
    mesh: Any
    dims: Tuple[Tuple[str, ...], ...]

    @property
    def spec(self) -> PartitionSpec:
        return P(*(None if not a else a[0] if len(a) == 1 else a
                   for a in self.dims))

    def part(self, dim: int) -> Tuple[int, int]:
        """(number of blocks, this rank's block) along ``dim``."""
        return self.mesh.size(self.dims[dim]), \
            self.mesh.index(self.dims[dim])

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(n // self.part(d)[0] for d, n in enumerate(shape))

    def local(self, full):
        """This rank's block of the full tensor ``full`` (a view)."""
        for d in range(len(self.dims)):
            n, i = self.part(d)
            if n > 1:
                size = full.shape[d] // n
                full = full.narrow(d, i * size, size)
        return full

    @property
    def split_axes(self) -> Tuple[str, ...]:
        return tuple(a for axes in self.dims for a in axes)


def to_layout(tree, mesh) -> Any:
    """PartitionSpec tree -> :class:`Layout` tree over ``mesh``."""
    def one(spec):
        for entry in spec:
            for a in entry_axes(entry):
                if a not in mesh.spec.axes:
                    raise ValueError(f"{spec} names axis {a!r}, not one of "
                                     f"the mesh's {mesh.spec.axes}")
        return Layout(mesh, tuple(entry_axes(e) for e in spec))
    return _tree_map(one, tree)


class PlanLayouts(NamedTuple):
    """A training plan's layouts over a torch mesh: the parameters as
    stored (``params``), as the forward and backward run on them
    (``compute``), the optimizer state (``opt``), and the batch's rows
    (``batch``, a (B, S) layout)."""
    params: Any
    compute: Any
    opt: Any
    batch: Layout


class ServeLayout(NamedTuple):
    """A serving plan laid over a torch mesh: where the weights live
    (:meth:`params`, ``param_specs_tree``: under FSDP their slices split
    over 'data' too), where the forward runs on them (:meth:`compute`,
    ``compute_specs_tree``: the stored layout without FSDP's split, the
    same as :meth:`params` for a plan without FSDP) and where the dense
    cache's leaves live (:meth:`cache`, ``cache_specs_tree``: the lanes
    over the plan's batch axes, the KV heads over ``model`` or the
    sequence over the plan's sequence axes)."""
    plan: Plan
    mesh: Any

    def params(self, cfg: ModelConfig, specs) -> Any:
        return to_layout(param_specs_tree(self.plan, cfg, specs), self.mesh)

    def compute(self, cfg: ModelConfig, specs) -> Any:
        return to_layout(compute_specs_tree(self.plan, cfg, specs),
                         self.mesh)

    def cache(self, cfg: ModelConfig, specs) -> Any:
        return to_layout(cache_specs_tree(self.plan, cfg, specs), self.mesh)


def plan_layouts(plan: Plan, cfg: ModelConfig, specs, mesh) -> PlanLayouts:
    """The :class:`PlanLayouts` of ``plan`` for the spec tree ``specs``."""
    return PlanLayouts(
        to_layout(param_specs_tree(plan, cfg, specs), mesh),
        to_layout(compute_specs_tree(plan, cfg, specs), mesh),
        to_layout(opt_state_specs_tree(plan, cfg, specs), mesh),
        to_layout(batch_spec(plan), mesh))
