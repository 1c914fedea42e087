"""The fleet facade — counterpart of
``paddle_tpu.distributed.fleet.fleet_base``.

``fleet.init(is_collective=True, strategy=...)`` joins the world
(``init_parallel_env``), builds the hybrid topology and its groups, and
installs the global ``Mesh`` of ranks with the reference's axes (dp, pp,
sharding, mp, sp; a "rest" axis takes ranks the degrees leave over).
``distributed_model`` wraps a layer in ``DataParallel``,
``distributed_optimizer`` an optimizer in ``HybridParallelOptimizer``, and
``create_train_step`` builds the ``ParallelTrainStep`` that the strategy
asks for: data parallelism, and ZeRO at ``sharding_configs['stage']`` when
``strategy.sharding``. The meta-strategies of the reference's
``meta_strategies.py`` (LocalSGD, DGC, gradient merge, fp16 all-reduce)
raise: they are the second half of the multi-device port, with tensor
parallelism and the pipeline (``distributed_model`` of a
``PipelineLayer`` at ``pp_degree`` > 1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .distributed_strategy import DistributedStrategy
from .topology import CommunicateTopology, HybridCommunicateGroup
from . import mesh_utils

__all__ = [
    "Fleet", "init", "is_first_worker", "worker_index", "worker_num",
    "distributed_optimizer", "distributed_model",
    "get_hybrid_communicate_group",
]

_NEXT_SLICE = ("the second half of the multi-device port (tensor "
               "parallelism, the pipeline, MoE and the meta-strategies)")


class RoleMakerBase:
    """Paddle's role makers, collective mode only."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective


PaddleCloudRoleMaker = RoleMakerBase
UserDefinedRoleMaker = RoleMakerBase


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._topology: Optional[CommunicateTopology] = None
        self._is_initialized = False
        self._user_defined_optimizer = None

    def init(self, role_maker=None, is_collective=False, strategy=None,
             device=None):
        """Join the world (on ``device``: the card by default, ``"cpu"``
        for gloo) and lay it out as the strategy's ``hybrid_configs``
        say (``dp_degree`` -1 takes the ranks left)."""
        from ..parallel import get_rank, init_parallel_env

        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device)
        hc = self._strategy.hybrid_configs
        n = torch.distributed.get_world_size()
        mp = max(int(hc.get("mp_degree", 1)), 1)
        pp = max(int(hc.get("pp_degree", 1)), 1)
        sharding = max(int(hc.get("sharding_degree", 1)), 1)
        sp = max(int(hc.get("sp_degree", 1)), 1)
        dp = int(hc.get("dp_degree", -1))
        if dp == -1:
            dp = max(n // (mp * pp * sharding * sp), 1)
        if dp * mp * pp * sharding * sp != n and n != 1:
            raise ValueError(
                f"hybrid degrees dp({dp})*mp({mp})*pp({pp})*sharding("
                f"{sharding})*sp({sp}) must equal the world size {n}")
        # the "data" axis of the topology holds every rank that splits
        # the batch: dp x sp
        self._topology = CommunicateTopology(
            hybrid_group_names=["data", "pipe", "sharding", "model"],
            dims=[max(n // (pp * sharding * mp), 1), pp, sharding, mp])
        self._hcg = HybridCommunicateGroup(self._topology, get_rank())
        dims = [dp, pp, sharding, mp, sp]
        axes = ["dp", "pp", "sharding", "mp", "sp"]
        total = int(np.prod(dims))
        if total == n:
            mesh_utils.init_mesh(dims, axes)
        elif total < n and n % total == 0:
            mesh_utils.init_mesh(dims + [-1], axes + ["rest"])
        else:
            mesh_utils.init_mesh([n], ["dp"])
        self._is_initialized = True
        return self

    # -- info ---------------------------------------------------------------
    def is_first_worker(self):
        from ..parallel import get_rank

        return get_rank() == 0

    def worker_index(self):
        from ..parallel import get_rank

        return get_rank()

    def worker_num(self):
        from ..parallel import get_world_size

        return get_world_size()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        from ..communication import barrier

        barrier()

    @property
    def worker_endpoints(self):
        from ..parallel import ParallelEnv

        return ParallelEnv().trainer_endpoints

    def get_hybrid_communicate_group(self):
        return self._hcg

    # -- optimizer / model --------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        self._user_defined_optimizer = optimizer
        from .hybrid_optimizer import HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)

    def distributed_model(self, model):
        hc = self._strategy.hybrid_configs if self._strategy else {}
        if int(hc.get("pp_degree", 1) or 1) > 1:
            raise NotImplementedError(
                f"fleet.distributed_model at pp_degree > 1 (the pipeline) "
                f"is {_NEXT_SLICE}")
        from ...nn.layer_dp import DataParallel

        group = (self._hcg.get_data_parallel_group()
                 if self._hcg is not None else None)
        return DataParallel(model, group=group)

    def minimize(self, optimizer=None, loss=None, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        opt = optimizer or self._user_defined_optimizer
        if loss is not None:
            return opt.minimize(loss)
        return None, None

    def create_train_step(self, model, loss_fn, optimizer=None, mesh=None,
                          compute_dtype=None, **kw):
        """The ``ParallelTrainStep`` of the strategy (the reference's
        StrategyCompiler role): data parallelism over the mesh's 'dp'
        axis, ZeRO at ``sharding_configs['stage']`` over 'sharding' when
        ``strategy.sharding``, ``recompute``, and with ``strategy.amp``
        bf16 (``use_bf16``) or fp16 compute. The meta-strategies raise."""
        from .engine import ParallelTrainStep
        from .form_mesh import strategy_mesh

        opt = optimizer or self._user_defined_optimizer
        if hasattr(opt, "_inner_opt"):
            opt = opt._inner_opt  # the HybridParallelOptimizer wrapper
        st = self._strategy
        if mesh is None:
            mesh = mesh_utils.get_mesh() or strategy_mesh(st)
        if st is not None:
            for flag in ("localsgd", "adaptive_localsgd", "dgc",
                         "fp16_allreduce", "gradient_merge"):
                if getattr(st, flag):
                    raise NotImplementedError(
                        f"DistributedStrategy.{flag} (meta_strategies.py) "
                        f"is {_NEXT_SLICE}")
            if compute_dtype is None and st.amp:
                compute_dtype = (torch.bfloat16
                                 if st.amp_configs.get("use_bf16", True)
                                 else torch.float16)
        zero = 0
        if st is not None and st.sharding:
            zero = int(st.sharding_configs.get("stage", 1))
            if st.sharding_configs.get("offload", False):
                raise NotImplementedError(
                    "sharding_configs['offload'] (optimizer state in host "
                    "memory) is not ported")
        dp = "dp" if "dp" in mesh.axis_names else None
        return ParallelTrainStep(
            model, loss_fn, opt, mesh=mesh, dp_axis=dp,
            sharding_axis=("sharding" if "sharding" in mesh.axis_names
                           else None),
            sp_axis="sp" if "sp" in mesh.axis_names else None,
            zero_stage=zero,
            recompute=bool(st.recompute) if st is not None else False,
            compute_dtype=compute_dtype, **kw)

    # -- checkpoint ---------------------------------------------------------
    def save_persistables(self, executor=None, dirname=None,
                          main_program=None, mode=0):
        from ...framework.io import save

        if self._user_defined_optimizer is not None and hasattr(
                self._user_defined_optimizer, "state_dict"):
            save(self._user_defined_optimizer.state_dict(),
                 f"{dirname}/fleet.pdopt")

    def save_inference_model(self, executor, dirname, feeded_var_names=None,
                             target_vars=None, main_program=None,
                             export_for_deployment=True, mode=0):
        raise NotImplementedError("use paddle_tpu_torch.jit.save for "
                                  "inference export")


fleet = Fleet()


def init(role_maker=None, is_collective=False, strategy=None, device=None):
    return fleet.init(role_maker, is_collective, strategy, device)


def is_first_worker():
    return fleet.is_first_worker()


def worker_index():
    return fleet.worker_index()


def worker_num():
    return fleet.worker_num()


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def distributed_model(model):
    return fleet.distributed_model(model)


def create_train_step(model, loss_fn, optimizer=None, mesh=None,
                      compute_dtype=None, **kw):
    return fleet.create_train_step(model, loss_fn, optimizer, mesh,
                                   compute_dtype, **kw)


def get_hybrid_communicate_group():
    return fleet._hcg
