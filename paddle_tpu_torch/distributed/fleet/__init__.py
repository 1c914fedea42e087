"""The fleet facade and the training engine — counterpart of
``paddle_tpu.distributed.fleet``: ``fleet.init``, ``DistributedStrategy``,
``distributed_model``, ``distributed_optimizer``, ``create_train_step``,
the topology, the mesh of ranks and ``ParallelTrainStep``."""
from . import mesh_utils  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .engine import ParallelTrainStep, param_partition_spec  # noqa: F401
from .fleet_base import (  # noqa: F401
    Fleet,
    create_train_step,
    distributed_model,
    distributed_optimizer,
    fleet,
    get_hybrid_communicate_group,
    init,
    is_first_worker,
    worker_index,
    worker_num,
)
from .form_mesh import strategy_mesh  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401

__all__ = ["ParallelTrainStep", "param_partition_spec", "DistributedStrategy",
           "Fleet", "fleet", "init", "create_train_step", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "is_first_worker", "worker_index", "worker_num", "strategy_mesh",
           "CommunicateTopology", "HybridCommunicateGroup", "mesh_utils"]
