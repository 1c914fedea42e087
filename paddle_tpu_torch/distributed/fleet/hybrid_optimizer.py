"""HybridParallelOptimizer — counterpart of
``paddle_tpu.distributed.fleet.hybrid_optimizer``.

Wraps the user's optimizer for eager training: ``step`` first averages
every gradient over the data-parallel group (an all-reduce of each dtype's
gradients packed in one buffer), then steps the optimizer.
"""
from __future__ import annotations

import torch

from ...optimizer.optimizer import Optimizer

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer: Optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    @torch.no_grad()
    def _sync_grads(self):
        from ...nn.layer_dp import average_gradients

        group = (self._hcg.get_data_parallel_group()
                 if self._hcg is not None else None)
        average_gradients(
            [p for p in self._inner_opt._parameter_list
             if not getattr(p, "is_distributed", False)], group)

    def step(self):
        self._sync_grads()
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad
