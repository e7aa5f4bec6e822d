"""Meshes of ``torch.distributed`` ranks: the counterpart of
``repro/launch/mesh.py``.

Where the reference lays a ``jax.sharding.Mesh`` over its devices, the
port lays a :class:`TorchMesh` over the ranks of an initialized
``torch.distributed`` world: rank ``r`` sits at the row-major coordinates
of ``r`` in the mesh's shape (``("data", "model")`` of ``(2, 2)``: ranks
0 and 1 share data row 0), and for every set of mesh axes longer than
one rank it holds the process group of the ranks that differ only along
those axes.  Nothing here runs at import: the world is joined by :func:`init_world`
(from ``torchrun``'s environment) or by the caller, never by importing
the module.

Rendezvous: ``torchrun`` gives ``env://``; tests and ``chip_smoke.py``
spawn their ranks with a ``file://`` store in a temporary directory (a
TCP port would collide between concurrent test workers).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.materializer import MeshSpec


class TorchMesh:
    """A :class:`MeshSpec` laid over the ranks of the current world."""

    def __init__(self, spec: MeshSpec):
        if not dist.is_initialized():
            raise RuntimeError(f"mesh {spec.name!r} needs an initialized "
                               "torch.distributed world")
        world = dist.get_world_size()
        if world != spec.num_devices:
            raise RuntimeError(f"mesh {spec.name!r} of shape {spec.shape} "
                               f"needs {spec.num_devices} ranks; the world "
                               f"has {world}")
        self.spec = spec
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        self._groups: Dict[frozenset, Tuple[dist.ProcessGroup, List[int]]] \
            = {}
        # every rank creates every group, in the same order
        for n in range(1, len(spec.axes) + 1):
            for axes in itertools.combinations(spec.axes, n):
                if self.size(axes) == 1:
                    continue
                for ranks in self._partition(axes):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[frozenset(axes)] = (group, ranks)

    def _partition(self, axes) -> List[List[int]]:
        """The ranks of the world grouped by their coordinates off
        ``axes`` (each group sorted)."""
        out: Dict[tuple, List[int]] = {}
        for r in range(self.spec.num_devices):
            c = self.coords_of(r)
            key = tuple(c[a] for a in self.spec.axes if a not in axes)
            out.setdefault(key, []).append(r)
        return list(out.values())

    def size(self, axes) -> int:
        """The number of ranks along ``axes``."""
        n = 1
        for a in axes:
            n *= self.spec.axis_size(a)
        return n

    def index(self, axes, coords: Optional[Dict[str, int]] = None) -> int:
        """This rank's (or ``coords``') index along ``axes``, the first
        axis major, as a dim split over ``axes`` numbers its blocks."""
        coords = coords or self.coords
        i = 0
        for a in axes:
            i = i * self.spec.axis_size(a) + coords[a]
        return i

    def coords_of(self, rank: int) -> Dict[str, int]:
        """A rank's coordinates: row-major in the mesh's shape."""
        return dict(zip(self.spec.axes, (int(c) for c in np.unravel_index(
            rank, self.spec.shape))))

    def group(self, axes) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's peers along ``axes`` (None
        when they are this rank alone)."""
        if self.size(axes) == 1:
            return None
        return self._groups[frozenset(axes)][0]

    def members(self, axes) -> List[int]:
        """The global ranks of :meth:`group`, in the group's rank order."""
        if self.size(axes) == 1:
            return [self.rank]
        return self._groups[frozenset(axes)][1]

    @property
    def world(self) -> Optional[dist.ProcessGroup]:
        return self.group(self.spec.axes)


def make_local_mesh(axes: Tuple[str, ...] = ("data", "model"),
                    shape: Optional[Tuple[int, ...]] = None) -> TorchMesh:
    """A mesh over whatever ranks the world has (tests): ``(world, 1,
    ...)`` unless ``shape`` is given."""
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    return TorchMesh(MeshSpec(f"local{tuple(shape)}", tuple(shape),
                              tuple(axes)))


def init_world(backend: str) -> None:
    """Join the ``torch.distributed`` world that ``torchrun``'s
    environment describes (``env://``); nothing when this process has
    joined one already."""
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:{local rank}`` when the host has a card
    for every rank, else ``cuda:0`` (several ranks sharing one card, which
    only gloo allows: NCCL then raises here); a CPU device as it is."""
    if device.type != "cuda":
        return device
    world = dist.get_world_size()
    cards = torch.cuda.device_count()
    if cards >= world:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local)
    if dist.get_backend() == "nccl":
        raise RuntimeError(
            f"NCCL needs a card per rank: the world has {world} ranks and "
            f"the host {cards} card(s); run fewer ranks, or gloo to share a "
            "card")
    return torch.device("cuda", 0)
