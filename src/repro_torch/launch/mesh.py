"""Meshes — the port of `repro.launch.mesh`.

A `Mesh` names its axes and their sizes (`shape`, a mapping in axis
order, as a `jax.sharding.Mesh`'s). Devices are laid out row-major: the
device of coordinates (c_0, c_1, ...) is rank sum(c_a * stride_a), the
first axis major, as `jax.make_mesh` orders them, so a block tiled over
an axis tuple follows jax's order.

`make_production_mesh` describes the 256- or 512-chip meshes that only
the layouts and the dry-run read: it holds no process group. A live mesh
(`make_local_mesh`) spans the current `torch.distributed` world, one
device a process, and holds a process group for every set of its axes:
`group(axes)` joins the ranks that differ only on `axes`, in
coordinate order. Without a process group a (1, 1) mesh is one rank and
makes no `torch.distributed` call.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist


class Mesh:
    """Axis names and sizes, and on a live mesh this process's rank, its
    coordinates and the process groups of its axis sets."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 live: bool = False):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.live = live
        self.distributed = live and dist.is_available() and \
            dist.is_initialized()
        self._groups = {}
        self._place(dist.get_rank() if self.distributed else 0)
        if self.distributed:
            if dist.get_world_size() != self.size:
                raise ValueError(f"a mesh of {self.size} devices over a "
                                 f"world of {dist.get_world_size()}")
            self._make_groups()

    def _place(self, rank: int) -> None:
        self.rank = rank
        self.coords: Dict[str, int] = {}
        for a in reversed(self.axis_names):
            self.coords[a] = rank % self.shape[a]
            rank //= self.shape[a]

    def at(self, rank: int) -> "Mesh":
        """The mesh's layout as rank `rank` sees it (its coordinates and
        blocks; no process groups): for computing another rank's
        blocks."""
        m = Mesh(tuple(self.shape.values()), self.axis_names)
        m.live = True
        m._place(rank)
        return m

    def __repr__(self):
        return f"Mesh({self.shape}, live={self.live})"

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _make_groups(self) -> None:
        """One process group for every nonempty set of axes (every rank
        creates every group, in one order, as `new_group` requires)."""
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    base = dict(zip(others, fixed))
                    ranks = sorted(self._rank_of(dict(base, **dict(
                        zip(axes, c)))) for c in itertools.product(
                            *(range(self.shape[a]) for a in axes)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def group(self, axes) -> Optional[object]:
        """The process group of the ranks that differ from this one only
        on `axes` (a name or a tuple), or None off a distributed mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.distributed or not axes:
            return None
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def index(self, axes) -> int:
        """This rank's index along `axes` (a name or a tuple, the first
        major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def make_production_mesh(*, multi_pod: bool = False, tp: int = 16) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 (2 pods, 512 chips), as a
    description: axes "pod" (slow inter-pod links — DP / DiLoCo /
    pipeline only), "data" (batch) and "model" (TP / EP / sequence).
    ``tp`` re-splits the 256 intra-pod chips between the data and model
    axes."""
    assert 256 % tp == 0, tp
    shape = (2, 256 // tp, tp) if multi_pod else (256 // tp, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A live (data, model) mesh over the current `torch.distributed`
    world, one device a process; (1, 1) without a process group is one
    rank. Raises ValueError when the world has too few processes, and
    when it has more than the mesh spans."""
    n = data * model
    have = dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} devices over a world of {have} "
                         f"processes: a live mesh spans the world")
    return Mesh((data, model), ("data", "model"), live=True)
