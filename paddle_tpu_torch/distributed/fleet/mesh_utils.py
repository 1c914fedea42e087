"""The process mesh — counterpart of
``paddle_tpu.distributed.fleet.mesh_utils``.

The reference's ``jax.sharding.Mesh`` lays devices of one process out on
named axes. Here the model is one process per device, so a ``Mesh`` lays
the world's ranks out on named axes (``mesh.devices`` is the rank
array), and each axis, or set of axes, has one ``torch.distributed``
subgroup per coordinate of the other axes: ``mesh.group(axes)`` is the
``communication.Group`` of those that holds this rank, with
``.process_group``, ``.nranks`` and ``.rank`` (this rank's index in the
group's sorted ranks, which is its coordinate along a single axis of a
row-major mesh). Every rank creates the subgroups in the same order
(``torch.distributed.new_group`` requires it): all of an axis set's
subgroups at its first ``group`` call.

In place of a ``NamedSharding``, ``describe(spec)`` gives a plain
description of each dimension's axis and its size.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "PartitionSpec", "init_mesh", "get_mesh", "set_mesh",
           "axis_size", "describe"]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor (None: not split), as the
    reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """The world's ranks on named axes (see the module docstring)."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        arr = np.asarray(ranks, dtype=np.int64)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"Mesh: {arr.ndim}-d ranks for axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"Mesh: repeated axis names {names}")
        if sorted(arr.reshape(-1).tolist()) != list(range(arr.size)):
            raise ValueError(f"Mesh: the ranks must be 0..{arr.size - 1} "
                             f"each once, got {arr.tolist()}")
        self.devices = arr
        self.axis_names = names
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s coordinate on each axis (default this rank)."""
        from ..parallel import get_rank

        r = get_rank() if rank is None else int(rank)
        where = np.argwhere(self.devices == r)
        if len(where) == 0:
            raise ValueError(f"rank {r} is not in the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def _axes(self, axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"{a!r} is not an axis of the mesh "
                                 f"{dict(self.shape)}")
        return tuple(a for a in self.axis_names if a in axes)

    def rank_lists(self, axes) -> list:
        """The ranks of every subgroup over ``axes``, one list per
        coordinate of the other axes (row-major)."""
        axes = self._axes(axes)
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in keep]
        arr = np.transpose(self.devices, rest + keep)
        arr = arr.reshape(-1, int(np.prod([self.devices.shape[i]
                                           for i in keep]) or 1))
        return [sorted(int(r) for r in row) for row in arr]

    def group(self, axes):
        """The ``communication.Group`` over ``axes`` that holds this rank
        (its subgroups are created on the first call; see the module
        docstring)."""
        from ..communication import Group
        from ..parallel import get_rank, init_parallel_env, is_initialized

        axes = self._axes(axes)
        hit = self._groups.get(axes)
        if hit is None:
            if not is_initialized():
                init_parallel_env()
            world = torch.distributed.get_world_size()
            if world != self.size:
                raise ValueError(f"the mesh {dict(self.shape)} has "
                                 f"{self.size} ranks, the world {world}")
            me = get_rank()
            label = "+".join(axes)
            for ranks in self.rank_lists(axes):
                pg = (torch.distributed.new_group(ranks=ranks)
                      if len(ranks) < world else
                      torch.distributed.group.WORLD)
                if me in ranks:
                    hit = Group(ranks=ranks, axis_name=label, pg=pg)
            self._groups[axes] = hit
        return hit

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


_mesh: Optional[Mesh] = None


def init_mesh(shape: Sequence[int] = None,
              axis_names: Sequence[str] = ("dp",), ranks=None) -> Mesh:
    """Create and install the global mesh over the world's ranks (joining
    the world first when needed: ``init_parallel_env``). Default: every
    rank on one 'dp' axis. An axis size of -1 is inferred."""
    global _mesh
    from ..parallel import init_parallel_env, is_initialized

    if not is_initialized():
        init_parallel_env()
    world = torch.distributed.get_world_size()
    r = np.asarray(ranks if ranks is not None else np.arange(world))
    if shape is None:
        shape = [r.size]
    shape = [int(s) for s in shape]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = r.size // known
    _mesh = Mesh(r.reshape(shape), tuple(axis_names))
    return _mesh


def set_mesh(mesh: Mesh) -> None:
    global _mesh
    _mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _mesh


def axis_size(axis_name: str) -> Optional[int]:
    if _mesh is None or axis_name not in _mesh.axis_names:
        return None
    return _mesh.shape[axis_name]


def describe(spec, mesh: Optional[Mesh] = None) -> list:
    """A plain description of a ``PartitionSpec`` over ``mesh`` (default
    the global one): per dimension ``{"axis": name or None, "parts":
    size}`` (the number of pieces the dimension is cut into)."""
    mesh = mesh or _mesh
    out = []
    for a in spec:
        if a is None:
            out.append({"axis": None, "parts": 1})
            continue
        names = (a,) if isinstance(a, str) else tuple(a)
        parts = int(np.prod([mesh.shape[n] for n in names])) if mesh else 1
        out.append({"axis": a, "parts": parts})
    return out

