"""Strategy → mesh — counterpart of
``paddle_tpu.distributed.fleet.form_mesh``: the ``Mesh`` of ranks that a
``DistributedStrategy``'s ``hybrid_configs`` describe."""
from __future__ import annotations

import numpy as np
import torch

from . import mesh_utils

__all__ = ["strategy_mesh"]

_AXIS_KEYS = [  # (hybrid_configs key, mesh axis name), in Fleet.init's order
    ("dp_degree", "dp"),
    ("pp_degree", "pp"),
    ("sharding_degree", "sharding"),
    ("mp_degree", "mp"),
    ("sp_degree", "sp"),
]


def strategy_mesh(strategy=None) -> mesh_utils.Mesh:
    """The mesh of ``hybrid_configs``: axes of degree 1 are dropped, a
    ``dp_degree`` of -1 takes the ranks left. Without a strategy: the
    global mesh, else every rank on one 'dp' axis (not installed)."""
    from ..parallel import init_parallel_env, is_initialized

    if not is_initialized():
        init_parallel_env()
    world = torch.distributed.get_world_size()
    ranks = np.arange(world)
    if strategy is None:
        m = mesh_utils.get_mesh()
        return m if m is not None else mesh_utils.Mesh(ranks, ("dp",))
    hc = strategy.hybrid_configs
    sizes, names = [], []
    for key, axis in _AXIS_KEYS:
        d = int(hc.get(key, 1) or 1)
        if d == -1 or d > 1:
            sizes.append(d)
            names.append(axis)
    if not sizes:
        return mesh_utils.Mesh(ranks, ("dp",))
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = max(1, world // known)
    total = int(np.prod(sizes))
    if total != world:
        if world == 1:
            # one rank: the degrees stay the configuration's intent
            return mesh_utils.Mesh(ranks, ("dp",))
        raise ValueError(
            f"hybrid_configs axes {dict(zip(names, sizes))} need {total} "
            f"ranks but the world has {world}")
    return mesh_utils.Mesh(ranks.reshape(sizes), tuple(names))
