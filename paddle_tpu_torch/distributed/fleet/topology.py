"""The hybrid-parallel topology — counterpart of
``paddle_tpu.distributed.fleet.topology`` (Paddle's
``CommunicateTopology`` and ``HybridCommunicateGroup``).

The topology numbers the world's ranks on the axes ``data``, ``pipe``,
``sharding`` and ``model``; each axis's group is the ``torch.distributed``
subgroup of the ranks that differ from this one only along it (the
reference names a mesh axis instead, ``dp``, ``pp``, ``sharding``,
``mp``, which the groups keep as their ``axis_name``).
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch

from ..communication import Group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = np.arange(int(np.prod(dims))).reshape(dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        coords = [kwargs[name] for name in self._parallel_names]
        return int(self.coordinate[tuple(coords)])

    def get_coord(self, rank):
        idx = np.argwhere(self.coordinate == rank)[0]
        return tuple(int(i) for i in idx)

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(int(r) for r in self.coordinate[tuple(sl)].reshape(-1))

    def get_comm_list(self, axis_name):
        """Every group along ``axis_name``: one list of ranks per
        combination of the other axes."""
        axis = self._parallel_names.index(axis_name)
        other = [d for i, d in enumerate(self._dims) if i != axis]
        out = []
        for coords in itertools.product(*[range(d) for d in other]):
            sl = list(coords)
            sl.insert(axis, slice(None))
            out.append([int(r) for r in
                        self.coordinate[tuple(sl)].reshape(-1)])
        return out


class HybridCommunicateGroup:
    """This rank's view of the topology: its coordinate on each axis and
    the group of each axis that holds it. The groups are made on every
    rank in the same order (``torch.distributed.new_group``'s rule), so
    every rank must build the topology."""

    _axis_name_map = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                      "model": "mp"}

    def __init__(self, topology: CommunicateTopology, global_rank=0):
        self._topo = topology
        self.global_rank = int(global_rank)
        self.nranks = topology.world_size()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")
        names = topology.get_hybrid_group_names()
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))
        dist = torch.distributed
        joined = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if joined else 1
        self._groups: Dict[str, Group] = {}
        for name in names:
            for ranks in topology.get_comm_list(name):
                ranks = sorted(ranks)
                pg = None
                if joined and world > 1 and len(ranks) < world:
                    pg = dist.new_group(ranks=ranks)
                if self.global_rank in ranks:
                    self._groups[name] = Group(
                        ranks=ranks, axis_name=self._axis_name_map[name],
                        pg=pg)

    # -- degrees / ranks ----------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_stage_id(self):
        return self._coord["pipe"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_global_rank(self):
        return self.global_rank

    # -- groups -------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_check_parallel_group(self):
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    # -- pipeline helpers ---------------------------------------------------
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    def topology(self):
        return self._topo

    def get_rank_from_stage(self, stage_id, **kwargs):
        coord = dict(self._coord)
        coord["pipe"] = stage_id
        coord.update(kwargs)
        return self._topo.get_rank(**coord)
