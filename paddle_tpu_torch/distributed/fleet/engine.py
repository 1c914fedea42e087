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

``compute_dtype=None`` trains in f32. Any float ``compute_dtype`` is
taken, as the reference's engine takes one: ``torch.bfloat16`` and
``torch.float16`` run the LayerNorm and attention kernels' instances of
that type, and in master mode the Adam kernel's (f32 masters, resident
copies re-cast in its pass). The engine adds no loss scaling in fp16,
nor does the reference's: a gradient past fp16's range is inf, and
``check_finite`` / ``guard_updates`` are the guard. The engine hands the
optimizer the layer's parameter names (``Optimizer.name_parameters``),
as the reference's engine passes names to ``apply_decay_param_fun``.

The optimizer's options apply as in its own ``step``: a learning-rate
scheduler is read at every step (the caller steps it, or ``run_steps``
does), and a ``ClipGradByGlobalNorm`` is folded into the Adam kernel.
The update is the reference engine's (``Optimizer.compiled_update``):
every parameter at the optimizer's learning rate (a ``ParamAttr``
``learning_rate`` and AdamW's ``lr_ratio`` are not read, as the
reference's ``apply_optimizer_update`` reads neither), and a row-sparse
gradient densified. A layer decorated for pure fp16 or bf16
(``amp.decorate(level='O2')``) trains on the f32 masters of a
``multi_precision`` optimizer, its gradients in the layer's dtype
through the Adam kernel. The
reference's compiled engines skip a ``ClipGradByValue`` or
``ClipGradByNorm`` without a word (``apply_optimizer_update``); the port
refuses them here. ``remat`` (or the older ``recompute``; ``remat`` wins)
names an ``ops.remat_policy`` policy: each decoder block, or encoder
layer, is recomputed in the backward. ``remat='auto'`` is resolved on the
first call's batch (``remat_policy.resolve`` over ``lower_cost``, entry
``fleet.train_step``, ``jit.train_step`` for ``jit.TrainStep``); the
chosen policy is the engine's from then on (``remat_policy_chosen``).
``lower_cost(policy, inputs, labels)`` measures one forward and backward
of this step under ``policy`` (``remat_policy.step_cost``: peak memory,
FLOPs, bytes) and leaves the engine as it was: parameters, masters,
optimizer state, ``.grad``, buffers, the dropout generators and the
global RNGs, the step count and the telemetry step counters.

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

The resilience contract of the reference's engines (what
``resilience.StepGuard`` and ``resilience.IntegrityMonitor`` build on):

- ``check_finite`` (default ``FLAGS_check_nan_inf`` when the engine is
  built) sweeps each step's ``loss``, ``grad`` and updated ``param``
  leaves (``core.sanitizer.finite_flags``' names, ``grad['fc.weight']``)
  and raises ``FloatingPointError`` after the update is committed;
- ``guard_updates`` keeps the sweep's flags for ``last_step_finite()``
  instead, and a step whose flags are not all true keeps every bit of the
  state it came with: parameters (and their resident casts), masters,
  moments, beta powers and buffers. The optimizer's step count still
  advances, as in the reference. With Adam the sweep is the kernel's
  check pass, run before the update, and the update reads its verdict on
  the device (``ops.fused.FiniteCheck``); other optimizers copy their
  state first and restore it with a ``torch.where``; buffers (BatchNorm's
  running statistics, written in the forward) are copied before the
  forward and restored the same way. No host sync either way;
- ``fingerprint_every`` (default ``PADDLE_TPU_FINGERPRINT_EVERY``, 0 =
  off) folds the state the step keeps into ``{"sum", "abs_sum", "xor"}``
  (``core.sanitizer.tree_fingerprint`` over params, optimizer state and
  buffers in the reference's structure; ``ops.tree_reduce`` on the card)
  on the steps whose ``_global_step`` is a multiple of it, and publishes
  it (``resilience.integrity.publish_fingerprint``) into a history of
  ``PADDLE_TPU_FP_HISTORY`` (64) entries; the device scalars are read only
  when ``last_fingerprint()`` asks;
- ``snapshot_state()`` copies the state; ``restore_state(snap)`` copies a
  snapshot (this engine's, or the reference engine's as numpy arrays)
  into the tensors already there, so that the Adam kernel's pointer table
  and the optimizer's per-parameter state stay valid;
- ``prefetch(batches, depth=2, buckets=None)`` is an
  ``io.DevicePrefetcher`` staged onto the engine's device.

Each step beats the watchdog (``resilience.watchdog.heartbeat``).
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...core import sanitizer
from ...core.place import resolve_device
from ...core.tree import as_tensor
from ...jit.functionalize import functionalize, set_params
from ...nn.clip import ClipGradByGlobalNorm
from ...ops import remat_policy
from ...optimizer.lr import LRScheduler
from ...profiler import goodput as _goodput
from ...profiler import spans as _spans
from ...profiler.telemetry import get_telemetry
from ...resilience import watchdog as _watchdog

__all__ = ["ParallelTrainStep"]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class ParallelTrainStep:
    """One training step of ``layer`` on one device (default ``"cuda"``).

    Not ported yet, and refused: a mesh and its data-, tensor- and
    sequence-parallel axes, ZeRO sharding, and a clip other than
    ``ClipGradByGlobalNorm``."""

    _telemetry = "engine"  # the prefix of the step's counters
    _remat_entry = "fleet.train_step"  # remat='auto''s gauge entry

    def __init__(self, layer: nn.Module, loss_fn: Callable, optimizer,
                 device=None, compute_dtype: Optional[torch.dtype] = None,
                 master_weights: Optional[bool] = None,
                 recompute=False, mesh=None, dp_axis=None,
                 mp_axis=None, sharding_axis=None, zero_stage: int = 0,
                 sp_axis=None, remat=None,
                 check_finite: Optional[bool] = None,
                 guard_updates: bool = False,
                 fingerprint_every: Optional[int] = None):
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
        if compute_dtype is not None and not compute_dtype.is_floating_point:
            raise TypeError(f"ParallelTrainStep: compute_dtype "
                            f"{compute_dtype} is not a float type")
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
        self._forward = functionalize(
            layer, training=True,
            compute_dtype=None if self._master else compute_dtype)
        self._remat = remat_policy.normalize(
            recompute if remat is None else remat)
        self.remat_policy_chosen: Optional[str] = None
        self._apply = None  # remat='auto': built on the first batch
        if self._remat != "auto":
            self.remat_policy_chosen = self._remat
            self._apply = remat_policy.apply_policy(self._forward,
                                                    self._remat, layer)
        optimizer.name_parameters(layer.named_parameters())
        if self._master:
            for p in layer.parameters():
                if p.is_floating_point():
                    optimizer.state_for(p, master=p.detach())
                    p.data = p.data.to(compute_dtype)
        self._synced = False
        self._last_step_t: Optional[float] = None
        self._init_resilience(check_finite, guard_updates, fingerprint_every)

    # -- the resilience contract --------------------------------------------
    def _init_resilience(self, check_finite, guard_updates,
                         fingerprint_every) -> None:
        from ...resilience.integrity import fingerprint_every_from_env

        self._guard_updates = bool(guard_updates)
        self._check_nan = (sanitizer.jit_check_enabled()
                           if check_finite is None
                           else bool(check_finite)) or self._guard_updates
        named = dict(self._layer.named_parameters())
        self._param_names = sorted(named)
        # the sweep's leaves in the reference's order: the loss, then each
        # float parameter's gradient and new value by sorted name
        self._swept = [named[n] for n in self._param_names
                       if named[n].is_floating_point()]
        swept_names = [n for n in self._param_names
                       if named[n].is_floating_point()]
        self._nan_names: List[str] = (
            ["loss"] + [f"grad[{n!r}]" for n in swept_names]
            + [f"param[{n!r}]" for n in swept_names])
        self._last_flags: Optional[torch.Tensor] = None
        if fingerprint_every is None:
            fingerprint_every = fingerprint_every_from_env()
        self._fp_every = max(0, int(fingerprint_every))
        self._fp_history: collections.deque = collections.deque(
            maxlen=int(os.environ.get("PADDLE_TPU_FP_HISTORY", "64") or 64))
        # the fingerprint's leaves: parameters and buffers by sorted name
        self._fp_params = sorted(named.items())
        buffers = sorted(self._layer.named_buffers())
        self._fp_buffer_names = [n for n, _ in buffers]
        self._fp_buffers = [b for _, b in buffers]
        self._window: Optional[list] = None  # run_steps' flags

    def last_step_finite(self):
        """``(ok, bad_leaf_names)`` of the latest step's sweep (a host read
        of its flags)."""
        return sanitizer.finite_report(self._nan_names, self._last_flags)

    @property
    def fingerprint_every(self) -> int:
        """The fingerprint interval (0 = off)."""
        return self._fp_every

    def last_fingerprint(self):
        """The newest fingerprint as ``(step, {"sum", "abs_sum", "xor"})``
        read to the host (numpy scalars: f32, f32, uint32), or None before
        the first one."""
        if not self._fp_history:
            return None
        step, fp = self._fp_history[-1]
        return step, _host_fingerprint(fp)

    def fingerprint_history(self):
        """The bounded history of ``(step, fingerprint)`` pairs, oldest
        first (device scalars: read them lazily)."""
        return list(self._fp_history)

    def _state_tree(self):
        """``(params, opt_state, buffers)`` as the reference's engine holds
        them: dicts by name (sorted when walked), each parameter's state
        under its keys (``beta1_pow``, ``beta2_pow``, ``master``,
        ``moment1``, ``moment2`` for Adam)."""
        params = {n: p.detach() for n, p in self._fp_params}
        state = {n: self._opt_state_of(p) for n, p in self._fp_params}
        buffers = dict(zip(self._fp_buffer_names, self._fp_buffers))
        return params, state, buffers

    def _opt_state_of(self, p) -> Dict[str, torch.Tensor]:
        """``p``'s optimizer state; for a parameter that has none yet, the
        state the optimizer would make for it."""
        st = self._optimizer._accumulators.get(id(p))
        return dict(st) if st is not None else \
            self._optimizer._init_state(p.detach())

    def _fp_leaves(self) -> List[torch.Tensor]:
        """The leaves of ``_state_tree()`` in its flatten order, without
        building the tree: the parameters by name, each one's state by
        name and key, the buffers by name."""
        params = [p for _, p in self._fp_params]
        out = list(params)
        for p in params:
            st = self._opt_state_of(p)
            out += [st[k] for k in sorted(st)]
        return out + self._fp_buffers

    def state_fingerprint(self) -> Dict[str, torch.Tensor]:
        """The fingerprint of the state as it is now (device scalars):
        ``tree_fingerprint(params, opt_state, buffers)``, through the
        multi-tensor kernel on the card."""
        from ...ops.tree_reduce import tree_fold

        return tree_fold(self._fp_leaves())

    def snapshot_state(self) -> dict:
        """A copy of the train state, ``{"params", "buffers",
        "opt_state"}`` by name (the reference's layout; in master mode the
        params are the resident casts and ``opt_state`` holds the
        masters)."""
        params, state, buffers = self._state_tree()
        return {"params": {n: t.clone() for n, t in params.items()},
                "buffers": {n: t.clone() for n, t in buffers.items()},
                "opt_state": {n: {k: v.clone() for k, v in st.items()}
                              for n, st in state.items()}}

    @torch.no_grad()
    def restore_state(self, snap: dict) -> None:
        """Copy a snapshot into the engine's own tensors (``copy_``: the
        optimizer's state and the Adam kernel's pointer table keep finding
        them). Leaves may be tensors on any device or numpy arrays (the
        reference's bfloat16 ones too); a parameter without optimizer
        state gets it."""
        named = dict(self._layer.named_parameters())
        bufs = dict(self._layer.named_buffers())
        for n, v in snap["params"].items():
            named[n].detach().copy_(as_tensor(v))
        for n, v in snap.get("buffers", {}).items():
            bufs[n].copy_(as_tensor(v))
        opt = self._optimizer
        for n, st in snap.get("opt_state", {}).items():
            p = named[n]
            cur = opt._accumulators.get(id(p))
            if cur is None:
                master = st.get("master")
                cur = opt.state_for(p, master=None if master is None
                                    else as_tensor(master))
            for k, v in st.items():
                cur[k].copy_(as_tensor(v))
        self._last_step_t = None

    def prefetch(self, batches, depth: int = 2, buckets=None):
        """An ``io.DevicePrefetcher`` over ``(inputs, labels)`` batches,
        staged onto this engine's device ``depth`` batches ahead; a staged
        batch passes through the step's ``.to()`` without a copy."""
        from ...io.prefetch import DevicePrefetcher

        return DevicePrefetcher(batches, depth=depth, buckets=buckets,
                                device=self._device)

    def _publish(self, step: int) -> None:
        from ...resilience.integrity import publish_fingerprint

        publish_fingerprint(self._fp_history, step, self.state_fingerprint(),
                            self._fp_every)

    def _fp_due(self, step: int) -> bool:
        return bool(self._fp_every) and step % self._fp_every == 0

    def __call__(self, inputs, labels) -> torch.Tensor:
        _watchdog.heartbeat()
        opt = self._optimizer
        step_no = opt._global_step
        with _goodput.activity("productive_step"), \
                contextlib.ExitStack() as stack:
            if not _spans.in_category("step"):
                # a loop above (hapi's fit) may hold the step span already
                stack.enter_context(_spans.span(
                    "step", cat="step", step=step_no))
            if self._synced:
                self._recast_from_masters()
            dev = self._device
            with _spans.span("h2d", cat="h2d"):
                inputs = tuple(as_tensor(a).to(dev, non_blocking=True)
                               for a in _as_tuple(inputs))
                labels = tuple(as_tensor(a).to(dev, non_blocking=True)
                               for a in _as_tuple(labels))
            if self._apply is None:
                self._resolve_remat(inputs, labels)
            with _spans.span("compute", cat="compute"):
                old_buffers = ([(b, b.clone()) for b in self._layer.buffers()]
                               if self._guard_updates else [])
                loss = self._loss_fn(self._apply(*inputs), *labels).float()
                loss.backward()
                flags = None
                # the reference's compiled update: the optimizer's learning
                # rate for every parameter, dense gradients
                with opt.compiled_update():
                    if self._check_nan:
                        flags = opt.step_checked(loss.detach(), self._swept,
                                                 gate=self._guard_updates)
                        if old_buffers:
                            ok = flags.all()
                            for b, old in old_buffers:
                                b.copy_(torch.where(ok, b, old))
                    else:
                        opt.step()
                opt.clear_grad()
            self._record_step()
        if self._window is not None:
            self._window.append(flags)
            return loss.detach()
        if self._fp_due(step_no):
            self._publish(step_no)
        if self._check_nan:
            self._last_flags = flags
            if not self._guard_updates:
                self._raise_if_nonfinite(step_no)
        return loss.detach()

    # -- remat='auto' ----------------------------------------------------------
    def lower_cost(self, policy, inputs, labels) -> Optional[Dict[str, float]]:
        """``remat_policy.step_cost`` of this step's forward and backward
        under ``policy`` on this batch (the measurement ``remat='auto'``
        ladders on), or None when it runs out of memory. The engine is left
        as it was (see the module docstring)."""
        dev = self._device
        inputs = tuple(as_tensor(a).to(dev) for a in _as_tuple(inputs))
        labels = tuple(as_tensor(a).to(dev) for a in _as_tuple(labels))
        return self._step_cost(remat_policy.normalize(policy), inputs,
                               labels)

    def _step_cost(self, policy: str, inputs, labels):
        layer = self._layer
        apply = remat_policy.apply_policy(self._forward, policy, layer)
        params = [p for p in layer.parameters() if p.requires_grad]
        gens = remat_policy._generators(layer)
        gen_states = [g.get_state() for g in gens]
        buffers = [(b, b.clone()) for b in layer.buffers()]
        cpu_rng = torch.get_rng_state()
        cuda_rng = (torch.cuda.get_rng_state(self._device)
                    if self._device.type == "cuda" else None)

        def run():
            for g, st in zip(gens, gen_states):
                g.set_state(st)  # each run draws the step's masks
            loss = self._loss_fn(apply(*inputs), *labels).float()
            torch.autograd.grad(loss, params, allow_unused=True)

        try:
            return remat_policy.step_cost(run, self._device,
                                          self._resident_bytes())
        finally:
            for g, st in zip(gens, gen_states):
                g.set_state(st)
            with torch.no_grad():
                for b, old in buffers:
                    b.copy_(old)
            torch.set_rng_state(cpu_rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self._device)

    def _resident_bytes(self) -> int:
        """Bytes of the state that lives across steps: parameters, buffers
        and the optimizer's tensors (each storage once)."""
        tensors = [*self._layer.parameters(), *self._layer.buffers()]
        for st in self._optimizer._accumulators.values():
            tensors += [t for t in st.values()
                        if isinstance(t, torch.Tensor)]
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in tensors}
        return sum(storages.values())

    def _resolve_remat(self, inputs, labels) -> None:
        """remat='auto': measure on this batch and build the step with the
        winner (once, before the first step)."""
        chosen = remat_policy.resolve(
            self._remat_entry,
            lambda policy: self._step_cost(policy, inputs, labels),
            device=self._device)
        self.remat_policy_chosen = chosen
        self._apply = remat_policy.apply_policy(self._forward, chosen,
                                                self._layer)

    def _raise_if_nonfinite(self, step_no: int) -> None:
        """The unguarded check's raise, after the update was committed; the
        step count stays where it was, as the reference's raise comes
        before its increment."""
        ok, _ = self.last_step_finite()
        if not ok:
            self._optimizer._global_step = step_no
            sanitizer.raise_if_nonfinite(self._nan_names, self._last_flags)

    def run_steps(self, inputs, labels, step_scheduler: bool = True
                  ) -> torch.Tensor:
        """One step per entry of the leading axis of ``inputs`` and
        ``labels`` (tuples of [n_steps, ...] tensors, or one such tensor);
        returns the [n_steps] f32 losses. A learning-rate scheduler is
        stepped between the steps (``n_steps − 1`` times) unless
        ``step_scheduler=False``: the learning rates are the reference's,
        ``sched()`` for the first step and ``sched.step()`` before each
        further one. As the reference's window: the sweep's flags are the
        AND over its steps (an unguarded check raises after the window),
        and one fingerprint of the window's final state is taken, labelled
        with its last step, when a step of the window is due."""
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        sched = self._optimizer._learning_rate
        if not (step_scheduler and isinstance(sched, LRScheduler)):
            sched = None
        first = self._optimizer._global_step
        n_steps = as_tensor(inputs[0]).shape[0]
        losses = []
        self._window = []
        try:
            for i in range(n_steps):
                if i and sched is not None:
                    sched.step()
                losses.append(self(tuple(a[i] for a in inputs),
                                   tuple(b[i] for b in labels)))
        finally:
            window, self._window = self._window, None
        if any(self._fp_due(first + k) for k in range(n_steps)):
            self._publish(first + n_steps - 1)
        if self._check_nan and window:
            self._last_flags = torch.stack(window).all(dim=0)
            if not self._guard_updates:
                self._raise_if_nonfinite(first)
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


def _host_fingerprint(fp: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A fingerprint's device scalars read to numpy: the sums as f32, the
    word as uint32 (the reference's dtypes)."""
    return {"sum": np.float32(fp["sum"].item()),
            "abs_sum": np.float32(fp["abs_sum"].item()),
            "xor": np.uint32(int(fp["xor"].item()) & 0xFFFFFFFF)}
