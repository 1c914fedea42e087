"""The training and evaluation steps of a layer — counterpart of
``paddle_tpu.jit.train_step``.

``TrainStep(layer, loss_fn, optimizer)(inputs, labels)`` is one step of
``distributed.fleet.engine.ParallelTrainStep`` on the layer's own
dtypes: the same forward, backward and optimizer step (the reference
keeps two copies of one update, ``_finish_step`` and
``apply_optimizer_update``; the port has one). A bf16 layer under
``multi_precision`` trains on f32 masters made from its bf16 values, as
the reference's ``TrainStep`` does. Its telemetry is ``jit/steps`` and
``jit/step_ms``.

``EvalStep(layer)(*inputs)`` is the layer's forward in eval mode without
autograd.

``check_finite``, ``guard_updates`` and ``fingerprint_every`` are the
engine's resilience contract (see ``distributed.fleet.engine``), and
``prefetch`` stages batches onto the step's device (``EvalStep.prefetch``
onto the layer's). One difference from the reference's ``TrainStep``: its
sweep reads the gradients after a global-norm clip has scaled them (so one
NaN gradient marks every clipped one), the port's reads them as they come,
as the reference's ``ParallelTrainStep`` does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.tree import as_tensor
from ..distributed.fleet.engine import ParallelTrainStep
from .functionalize import functionalize

__all__ = ["TrainStep", "EvalStep"]


class TrainStep(ParallelTrainStep):
    """One training step of ``layer`` on ``device`` (default ``"cuda"``),
    with ``remat`` an ``ops.remat_policy`` policy or ``'auto'`` (resolved
    on the first batch, gauge entry ``jit.train_step``)."""

    _telemetry = "jit"
    _remat_entry = "jit.train_step"

    def __init__(self, layer: nn.Module, loss_fn: Callable, optimizer,
                 device=None, remat="off", *,
                 check_finite: Optional[bool] = None,
                 guard_updates: bool = False,
                 fingerprint_every: Optional[int] = None):
        super().__init__(layer, loss_fn, optimizer, device=device,
                         remat=remat, check_finite=check_finite,
                         guard_updates=guard_updates,
                         fingerprint_every=fingerprint_every)


class EvalStep:
    """``layer``'s forward in eval mode, without autograd, on the device
    of its parameters. ``loss_fn`` is kept, as in the reference, and not
    called."""

    def __init__(self, layer: nn.Module, loss_fn: Optional[Callable] = None):
        self._layer = layer
        self._loss_fn = loss_fn
        self._apply = functionalize(layer, training=False)
        self._device = next(layer.parameters()).device

    def prefetch(self, batches, depth: int = 2, buckets=None):
        """An ``io.DevicePrefetcher`` over input batches, staged onto the
        layer's device (see ``TrainStep.prefetch``)."""
        from ..io.prefetch import DevicePrefetcher

        return DevicePrefetcher(batches, depth=depth, buckets=buckets,
                                device=self._device)

    @torch.no_grad()
    def __call__(self, *inputs):
        return self._apply(*(as_tensor(a).to(self._device, non_blocking=True)
                             for a in inputs))
