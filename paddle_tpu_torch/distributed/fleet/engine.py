"""The training step — counterpart of
``paddle_tpu.distributed.fleet.engine.ParallelTrainStep``, on one device.

``ParallelTrainStep(layer, loss_fn, optimizer)(inputs, labels)`` runs the
layer's forward in train mode, ``loss_fn(out, *labels)``, autograd's
backward (through the hand-written LayerNorm and flash-attention backward
kernels on the card) and the optimizer's multi-tensor Adam, and returns
the f32 0-d loss on the device without waiting for it.

A float ``compute_dtype`` runs in one of the reference's two modes
(``master_weights`` defaults to the optimizer's ``multi_precision``):

- master mode: the layer's float parameters are cast to it once, at
  construction, and the optimizer keeps their f32 values as masters;
  each step updates the masters and re-casts the resident copies in the
  same kernel pass;
- without masters: the f32 parameters stay resident; each step runs the
  forward on their casts, made under autograd, so the gradients arrive
  in f32 and the update is f32 (the reference's per-step cast in
  ``forward_loss``).

Each call is the goodput ledger's ``productive_step`` and opens the
reference's spans: ``step`` (unless a loop above holds one), with ``h2d``
(the inputs' copies) and ``compute`` (forward, backward and update)
inside it.

``compute_dtype=None`` trains in f32. The engine hands the optimizer the
layer's parameter names (``Optimizer.name_parameters``), as the
reference's engine passes names to ``apply_decay_param_fun``.

The optimizer's options apply as in its own ``step``: a learning-rate
scheduler is read at every step (the caller steps it, or ``run_steps``
does), and a ``ClipGradByGlobalNorm`` is folded into the Adam kernel. The
reference's compiled engines skip a ``ClipGradByValue`` or
``ClipGradByNorm`` without a word (``apply_optimizer_update``); the port
refuses them here. ``remat`` (or the older ``recompute``; ``remat`` wins)
names an ``ops.remat_policy`` policy: each decoder block, or encoder
layer, is recomputed in the backward.

Unlike the reference, whose jitted step holds its own copy of the state,
the step updates the layer's parameters in place: they ARE the step's
state. So are its buffers: a train-mode forward updates BatchNorm's
running statistics in place, and in master mode they stay f32 (only
parameters are cast). Inputs are moved with ``non_blocking=True``, so a
pinned batch (``io.DataLoader`` built for the card) overlaps its copy.
Under ``amp.auto_cast`` the white-listed ops of the forward run in the
AMP dtype on the f32 parameters (the reference's O1).
``sync_to_layer()`` puts the f32 masters into the layer (the reference's
checkpoint contract), and the next step casts them back;
``refresh_from_layer()`` is the other way round: the masters are rebuilt
from what was loaded into the layer, where it disagrees with them.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch
from torch import nn

from ...core.place import resolve_device
from ...jit.functionalize import functionalize, set_params
from ...nn.clip import ClipGradByGlobalNorm
from ...ops import remat_policy
from ...optimizer.lr import LRScheduler
from ...profiler import goodput as _goodput
from ...profiler import spans as _spans
from ...profiler.telemetry import get_telemetry

__all__ = ["ParallelTrainStep"]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class ParallelTrainStep:
    """One training step of ``layer`` on one device (default ``"cuda"``).

    Not ported yet, and refused: a mesh and its data-, tensor- and
    sequence-parallel axes, ZeRO sharding, ``remat='offload'`` and
    ``'auto'``, and a clip other than ``ClipGradByGlobalNorm``."""

    _telemetry = "engine"  # the prefix of the step's counters

    def __init__(self, layer: nn.Module, loss_fn: Callable, optimizer,
                 device=None, compute_dtype: Optional[torch.dtype] = None,
                 master_weights: Optional[bool] = None,
                 recompute=False, mesh=None, dp_axis=None,
                 mp_axis=None, sharding_axis=None, zero_stage: int = 0,
                 sp_axis=None, remat=None):
        if mesh is not None or zero_stage or any(
                a is not None for a in (dp_axis, mp_axis, sharding_axis,
                                        sp_axis)):
            raise NotImplementedError(
                f"{type(self).__name__}: meshes, data/tensor/sequence "
                "parallelism and ZeRO are not ported yet (one device only)")
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"{type(self).__name__}: {type(clip).__name__} needs a pass "
                "of its own that the compiled step does not have; the "
                "reference's compiled engines skip it silently. Use "
                "ClipGradByGlobalNorm, or Optimizer.step() outside an engine")
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"ParallelTrainStep: compute_dtype {compute_dtype} is not "
                "ported yet (float32 or bfloat16)")
        if compute_dtype == torch.float32:
            compute_dtype = None  # f32 training: the params are the masters
        if master_weights is None:
            master_weights = optimizer._multi_precision
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        tensors = [*layer.parameters(), *layer.buffers()]
        if any(t.device != dev for t in tensors):
            raise ValueError(
                f"ParallelTrainStep: the layer's parameters and buffers "
                f"must be on {dev} (build the model with device=...), "
                f"found {sorted({str(t.device) for t in tensors})}")
        self._device = dev
        self._layer = layer
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._compute_dtype = compute_dtype
        self._master = compute_dtype is not None and bool(master_weights)
        self._apply = remat_policy.apply_policy(functionalize(
            layer, training=True,
            compute_dtype=None if self._master else compute_dtype),
            recompute if remat is None else remat, layer)
        optimizer.name_parameters(layer.named_parameters())
        if self._master:
            for p in layer.parameters():
                if p.is_floating_point():
                    optimizer.state_for(p, master=p.detach())
                    p.data = p.data.to(compute_dtype)
        self._synced = False
        self._last_step_t: Optional[float] = None

    def __call__(self, inputs, labels) -> torch.Tensor:
        with _goodput.activity("productive_step"), \
                contextlib.ExitStack() as stack:
            if not _spans.in_category("step"):
                # a loop above (hapi's fit) may hold the step span already
                stack.enter_context(_spans.span(
                    "step", cat="step", step=self._optimizer._global_step))
            if self._synced:
                self._recast_from_masters()
            dev = self._device
            with _spans.span("h2d", cat="h2d"):
                inputs = tuple(a.to(dev, non_blocking=True) for a in
                               _as_tuple(inputs))
                labels = tuple(a.to(dev, non_blocking=True) for a in
                               _as_tuple(labels))
            with _spans.span("compute", cat="compute"):
                loss = self._loss_fn(self._apply(*inputs), *labels).float()
                loss.backward()
                self._optimizer.step()
                self._optimizer.clear_grad()
            self._record_step()
            return loss.detach()

    def run_steps(self, inputs, labels, step_scheduler: bool = True
                  ) -> torch.Tensor:
        """One step per entry of the leading axis of ``inputs`` and
        ``labels`` (tuples of [n_steps, ...] tensors, or one such tensor);
        returns the [n_steps] f32 losses. A learning-rate scheduler is
        stepped between the steps (``n_steps − 1`` times) unless
        ``step_scheduler=False``: the learning rates are the reference's,
        ``sched()`` for the first step and ``sched.step()`` before each
        further one."""
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        sched = self._optimizer._learning_rate
        if not (step_scheduler and isinstance(sched, LRScheduler)):
            sched = None
        losses = []
        for i in range(inputs[0].shape[0]):
            if i and sched is not None:
                sched.step()
            losses.append(self(tuple(a[i] for a in inputs),
                               tuple(b[i] for b in labels)))
        return torch.stack(losses)

    def _record_step(self) -> None:
        """``<prefix>/steps`` and ``<prefix>/step_ms`` (``engine`` here,
        ``jit`` for ``jit.TrainStep``): the step time is the interval
        between calls, which in steady state equals the device's step time
        without a blocking sync (the reference's rule)."""
        tel = get_telemetry()
        now = time.perf_counter()
        tel.counter(f"{self._telemetry}/steps")
        if self._last_step_t is not None:
            tel.observe(f"{self._telemetry}/step_ms",
                        (now - self._last_step_t) * 1e3)
        self._last_step_t = now

    def sync_to_layer(self) -> None:
        """Make the layer hold the trained weights as the reference's
        checkpoints carry them: the f32 masters in master mode (the
        parameters are cast back at the next step). The next step interval
        is not recorded: it would time this pause."""
        self._last_step_t = None
        if not self._master:
            return
        named = dict(self._layer.named_parameters())
        set_params(self._layer, {
            n: self._optimizer.state_for(p)["master"].clone()
            for n, p in named.items() if p.is_floating_point()})
        self._synced = True

    @torch.no_grad()
    def refresh_from_layer(self) -> None:
        """Take the layer's current values as the trained state, after
        something wrote into the layer (``hapi.Model.load``). Every f32
        master the optimizer holds (master mode, or a low-precision layer
        under ``multi_precision``) is rebuilt from its parameter where
        the two disagree: an element whose master still rounds to the
        parameter keeps the master's extra bits (a resume that restored
        both), any other takes the parameter's value. Otherwise the next
        step would cast stale masters over what was just loaded. In master
        mode the next step casts the masters back."""
        for p in self._layer.parameters():
            st = self._optimizer._accumulators.get(id(p))
            master = st.get("master") if st else None
            if master is not None:
                master.copy_(torch.where(master.to(p.dtype) == p, master,
                                         p.detach().float()))
        if self._master:
            self._synced = True

    def _recast_from_masters(self) -> None:
        for p in self._layer.parameters():
            if p.is_floating_point():
                p.data = self._optimizer.state_for(p)["master"].to(
                    self._compute_dtype)
        self._synced = False
