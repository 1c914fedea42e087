"""The training step — counterpart of
``paddle_tpu.distributed.fleet.engine.ParallelTrainStep``, on one device
or over a ``Mesh`` of ranks (one process per device).

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

Over a mesh (``mesh=``, a ``fleet.mesh_utils.Mesh`` of the world's
ranks; the reference's strategies become collectives of
``torch.distributed``):

- every rank passes the global batch and keeps its rows: dim 0 split over
  ``dp_axis`` (default ``'dp'`` when the mesh has it) and
  ``extra_batch_axes``, and with ``sp_axis`` dim 1 of each leaf whose
  dim 1 divides over that axis (``_sharded.BatchSharding``); ranks that
  differ along other axes (``sharding``) compute on the same rows;
- the loss is averaged over the data group (the data axes and
  ``sp_axis``), and so are the gradients: they are packed into one flat
  buffer per dtype and all-reduced once after the backward. A mean whose
  denominator depends on the data (a masked or ``ignore_index`` loss)
  divides by the global count (``parallel.data_parallel_scope``), so the
  result is the reference's mean over the global batch; BatchNorm's
  statistics are taken over the data group too;
- ``zero_stage`` 1 keeps the Adam state (moments, masters) only for this
  rank's contiguous shard of each flat buffer over ``sharding_axis``
  (``_sharded.FlatBucket``), updates the shard on kernel #7 and
  all-gathers the parameters; 2 also reduce-scatters the gradients; 3
  also keeps only the parameter shard between steps, all-gathered for the
  step's forward and backward and freed after it. A global-norm clip
  all-reduces the sum of squares between #7's norm pass and its update,
  and the finite sweep's flags are AND-ed over the world, so every rank
  skips the same step. ZeRO takes ``Adam`` and ``AdamW``; zero_stage 0
  runs any optimizer on the reduced gradients;
- ``sp_axis``: attention runs as ``ops.attention.ring_attention`` over
  that axis's group (each rank holds ``L / sp`` positions; GPT's position
  ids start at ``rank_in_sp · L_local``);
- ``mp_axis`` of more than one rank raises: tensor parallelism is the
  second half of the multi-device port;
- ``param_specs`` are the reference's ``param_partition_spec``s;
  ``snapshot_state``, ``restore_state``, ``sync_to_layer``, the
  fingerprints and ``last_step_finite`` give the gathered, global values
  on every rank, and ``prefetch`` stages each rank's own rows.

A world of one runs the same collectives (NCCL copies) and adds no
arithmetic: its losses are the single-device engine's.
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
from ...ops import fused, remat_policy
from ...optimizer.lr import LRScheduler
from ...profiler import goodput as _goodput
from ...profiler import spans as _spans
from ...profiler.telemetry import get_telemetry
from ...resilience import watchdog as _watchdog
from .. import communication as comm
from ..parallel import data_parallel_scope
from ._sharded import BatchSharding, FlatBucket
from .mesh_utils import PartitionSpec

__all__ = ["ParallelTrainStep", "param_partition_spec"]

_TP_SLICE = ("tensor parallelism (mp_axis over more than one rank) is the "
             "second half of the multi-device port")


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def param_partition_spec(param, shape, zero_stage=0,
                         sharding_axis="sharding", mesh=None,
                         shard_params=False) -> PartitionSpec:
    """The reference's spec of a parameter over ``mesh``: its tensor
    parallel ``tp_spec`` (axes absent from the mesh, of one rank, or that
    do not divide the dimension dropped), and with ``shard_params`` the
    first dimension that divides evenly over ``sharding_axis`` and is not
    already split."""
    tp = list(getattr(param, "tp_spec", None) or (None,) * len(shape))
    tp = (tp + [None] * len(shape))[:len(shape)]
    if mesh is not None:
        tp = [a if (a in mesh.axis_names and mesh.shape[a] > 1
                    and shape[i] % mesh.shape[a] == 0) else None
              for i, a in enumerate(tp)]
    if (shard_params and mesh is not None
            and sharding_axis in mesh.axis_names):
        size = mesh.shape[sharding_axis]
        if size > 1:
            for i, (dim, spec) in enumerate(zip(shape, tp)):
                if spec is None and dim % size == 0 and dim >= size:
                    tp[i] = sharding_axis
                    break
    return PartitionSpec(*tp)


class ParallelTrainStep:
    """One training step of ``layer`` on one device (default ``"cuda"``),
    or over ``mesh`` (see the module docstring).

    Refused: tensor parallelism (``mp_axis`` over more than one rank),
    and a clip other than ``ClipGradByGlobalNorm``."""

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
                 fingerprint_every: Optional[int] = None,
                 extra_batch_axes=()):
        if mesh is None and (zero_stage or extra_batch_axes or any(
                a is not None for a in (dp_axis, mp_axis, sharding_axis,
                                        sp_axis))):
            raise ValueError(f"{type(self).__name__}: data, sequence and "
                             "tensor axes and ZeRO need a mesh")
        if int(zero_stage) not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage {zero_stage} (0, 1, 2 or 3)")
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
        if device is None and mesh is not None:
            from ..parallel import world_device

            device = world_device()  # the world's: this rank's card or CPU
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
        self._mesh = mesh
        self._zero = int(zero_stage) if mesh is not None else 0
        if self._remat == "auto" and self._zero >= 3:
            raise NotImplementedError(
                "remat='auto' measures the step on the resident parameters; "
                "ZeRO-3 keeps only their shards: pick a policy")
        masters = {}
        if self._master:
            for n, p in layer.named_parameters():
                if p.is_floating_point():
                    if self._zero >= 1:
                        masters[n] = p.detach().float()
                    else:
                        optimizer.state_for(p, master=p.detach())
                    p.data = p.data.to(compute_dtype)
        self._synced = False
        self._synced_views = False  # ZeRO: parameters off their flat views
        self._last_step_t: Optional[float] = None
        self._init_resilience(check_finite, guard_updates, fingerprint_every)
        if mesh is not None:
            self._init_mesh(mesh, dp_axis, mp_axis, sharding_axis, sp_axis,
                            tuple(extra_batch_axes), masters)

    # -- the mesh -------------------------------------------------------------
    def _init_mesh(self, mesh, dp_axis, mp_axis, sharding_axis, sp_axis,
                   extra_batch_axes, masters) -> None:
        from ...optimizer.optimizer import Adam

        if not hasattr(mesh, "group"):
            raise TypeError("ParallelTrainStep: mesh must be a "
                            "distributed.fleet.mesh_utils.Mesh of ranks")
        names = mesh.axis_names

        def axis(a, default):
            if a is None:
                return default if default in names else None
            if a not in names:
                raise ValueError(f"{a!r} is not an axis of the mesh "
                                 f"{dict(mesh.shape)}")
            return a

        dp_axis = axis(dp_axis, "dp")
        sharding_axis = axis(sharding_axis, "sharding")
        mp_axis = axis(mp_axis, "mp")
        if sp_axis is not None and sp_axis not in names:
            raise ValueError(f"sp_axis {sp_axis!r} is not an axis of this "
                             f"mesh {names}")
        for a in extra_batch_axes:
            axis(a, None)
        if mp_axis is not None and mesh.shape[mp_axis] > 1:
            raise NotImplementedError(f"ParallelTrainStep: {_TP_SLICE}")
        batch_axes = tuple(a for a in (dp_axis, *extra_batch_axes) if a)
        data_axes = batch_axes + ((sp_axis,) if sp_axis else ())
        self._sp_axis = sp_axis
        self._batch_sharding = BatchSharding(mesh, batch_axes, sp_axis)
        self._data_group = mesh.group(data_axes) if data_axes else None
        self._data_size = (self._data_group.nranks
                           if self._data_group is not None else 1)
        self._sp_group = mesh.group(sp_axis) if sp_axis else None
        self._sharding_group = (mesh.group(sharding_axis) if sharding_axis
                                and self._zero >= 1 else None)
        shards = (self._sharding_group.nranks
                  if self._sharding_group is not None else 1)
        coord = (self._sharding_group.rank
                 if self._sharding_group is not None else 0)
        self._param_specs = {
            n: param_partition_spec(p, tuple(p.shape), self._zero,
                                    sharding_axis or "sharding", mesh,
                                    shard_params=self._zero >= 3)
            for n, p in self._layer.named_parameters()}
        opt = self._optimizer
        if self._zero >= 1 and (not isinstance(opt, Adam) or opt._lazy):
            raise NotImplementedError(
                f"ZeRO shards the state of the multi-tensor Adam kernel "
                f"(Adam, AdamW); {type(opt).__name__} keeps its state "
                "replicated: use zero_stage=0")
        # one flat buffer per dtype of the trained parameters, in the
        # layer's order
        by_dtype: Dict[torch.dtype, list] = {}
        for n, p in self._layer.named_parameters():
            if p.is_floating_point() and p.requires_grad:
                by_dtype.setdefault(p.dtype, []).append((n, p))
        self._buckets: List[FlatBucket] = []
        for items in by_dtype.values():
            bk = FlatBucket([n for n, _ in items], [p for _, p in items],
                            shards, coord, own_shard=self._zero >= 3,
                            hold_params=self._zero >= 1)
            self._buckets.append(bk)
            if self._zero == 0:
                continue
            f32 = torch.float32
            sl = slice(bk.start, bk.start + bk.S)
            bk.m1 = torch.zeros(bk.S, dtype=f32, device=bk.device)
            bk.m2 = torch.zeros(bk.S, dtype=f32, device=bk.device)
            bk.master = (bk.scatter_values(
                {n: masters[n] for n in bk.names}, f32)[sl].clone()
                if self._master else None)
            n_p = len(bk.names)
            bk.b1p = torch.ones(n_p, dtype=f32, device=bk.device)
            bk.b2p = torch.ones(n_p, dtype=f32, device=bk.device)
            # the rank that holds a parameter's first element speaks for
            # its beta powers in the gathered state
            owner = torch.zeros(n_p, dtype=f32, device=bk.device)
            for pc in bk.pieces:
                if pc.p_lo == 0:
                    owner[pc.index] = 1.0
            bk.owner = owner
            bk.install()
            if self._zero >= 3:
                bk.release()
        swept = {n: j for j, n in enumerate(
            n for n in self._param_names
            if dict(self._layer.named_parameters())[n].is_floating_point())}
        self._swept_index = swept
        self._flag_slots: Dict[tuple, torch.Tensor] = {}
        self._piece_lists: Dict[tuple, tuple] = {}

    @property
    def param_specs(self) -> Dict[str, PartitionSpec]:
        """Each parameter's spec as the reference's engine computes it
        (``param_partition_spec``)."""
        if self._mesh is None:
            return {n: PartitionSpec(*(None,) * p.dim())
                    for n, p in self._layer.named_parameters()}
        return dict(self._param_specs)

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
        ``moment1``, ``moment2`` for Adam). Under ZeRO: the values
        gathered from every rank's shards."""
        if self._zero >= 1:
            return self._gathered_state()
        params = {n: p.detach() for n, p in self._fp_params}
        state = {n: self._opt_state_of(p) for n, p in self._fp_params}
        buffers = dict(zip(self._fp_buffer_names, self._fp_buffers))
        return params, state, buffers

    @torch.no_grad()
    def _gathered_state(self):
        """ZeRO: the global state, gathered over the sharding group (new
        tensors; each beta power from the rank that holds its parameter's
        first element)."""
        params = {n: p.detach() for n, p in self._fp_params}
        state = {n: self._opt_state_of(p) for n, p in self._fp_params}
        for bk in self._buckets:
            def full(shard):
                out = torch.empty(bk.total, dtype=shard.dtype,
                                  device=shard.device)
                self._all_gather(out, shard)
                return bk.split_values(out)

            vals = full(bk.shard)
            m1, m2 = full(bk.m1), full(bk.m2)
            master = full(bk.master) if bk.master is not None else None
            pows = []
            for v in (bk.b1p, bk.b2p):
                v = v * bk.owner
                if self._sharding_group is not None:
                    comm.all_reduce(v, group=self._sharding_group)
                pows.append(v)
            for i, n in enumerate(bk.names):
                params[n] = vals[n]
                st = {"beta1_pow": pows[0][i], "beta2_pow": pows[1][i],
                      "moment1": m1[n], "moment2": m2[n]}
                if master is not None:
                    st["master"] = master[n]
                state[n] = st
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
        if self._zero >= 1:
            params, state, buffers = self._gathered_state()
            out = [params[n] for n in sorted(params)]
            for n in sorted(state):
                out += [state[n][k] for k in sorted(state[n])]
            return out + [buffers[n] for n in sorted(buffers)]
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
        for n, v in snap.get("buffers", {}).items():
            bufs[n].copy_(as_tensor(v))
        self._last_step_t = None
        if self._zero >= 1:
            self._restore_sharded(snap)
            return
        for n, v in snap["params"].items():
            named[n].detach().copy_(as_tensor(v))
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

    def _restore_sharded(self, snap: dict) -> None:
        """ZeRO: each rank keeps its shard of a global snapshot."""
        f32 = torch.float32
        opt_state = snap.get("opt_state", {})
        for bk in self._buckets:
            sl = slice(bk.start, bk.start + bk.S)
            full = bk.scatter_values(snap["params"])
            bk.shard.copy_(full[sl])
            if self._zero < 3:
                bk.full.copy_(full)
            st = {n: opt_state.get(n, {}) for n in bk.names}
            for key, dst in (("moment1", bk.m1), ("moment2", bk.m2),
                             ("master", bk.master)):
                if dst is None:
                    continue
                vals = {n: st[n].get(key) for n in bk.names}
                if key == "master":  # a snapshot without masters: params
                    vals = {n: v if v is not None else
                            as_tensor(snap["params"][n]).float()
                            for n, v in vals.items()}
                elif any(v is None for v in vals.values()):
                    continue
                dst.copy_(bk.scatter_values(vals, f32)[sl])
            for i, n in enumerate(bk.names):
                for key, vec in (("beta1_pow", bk.b1p), ("beta2_pow", bk.b2p)):
                    if key in st[n]:
                        vec[i] = as_tensor(st[n][key]).reshape(()).to(f32)

    def prefetch(self, batches, depth: int = 2, buckets=None):
        """An ``io.DevicePrefetcher`` over ``(inputs, labels)`` batches,
        staged onto this engine's device ``depth`` batches ahead; a staged
        batch passes through the step's ``.to()`` without a copy."""
        from ...io.prefetch import DevicePrefetcher

        return DevicePrefetcher(
            batches, depth=depth, buckets=buckets, device=self._device,
            sharding=self._batch_sharding if self._mesh is not None
            else None)

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
            with _spans.span("h2d", cat="h2d"):
                inputs, labels = self._to_device(inputs, labels)
            if self._apply is None:
                self._resolve_remat(inputs, labels)
            with _spans.span("compute", cat="compute"):
                old_buffers = ([(b, b.clone()) for b in self._layer.buffers()]
                               if self._guard_updates else [])
                if self._mesh is None:
                    loss = self._loss_fn(self._apply(*inputs),
                                         *labels).float()
                    loss.backward()
                    loss = loss.detach()
                    flags = self._update_replicated(loss)
                else:
                    loss, flags = self._compute_mesh(inputs, labels)
                if old_buffers and flags is not None:
                    ok = flags.all()
                    for b, old in old_buffers:
                        b.copy_(torch.where(ok, b, old))
                opt.clear_grad()
            self._record_step()
        if self._window is not None:
            self._window.append(flags)
            return loss
        if self._fp_due(step_no):
            self._publish(step_no)
        if self._check_nan:
            self._last_flags = flags
            if not self._guard_updates:
                self._raise_if_nonfinite(step_no)
        return loss

    def _to_device(self, inputs, labels):
        """The batch on the engine's device: this rank's rows of it over a
        mesh (``non_blocking``: a pinned batch overlaps its copy)."""
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        if self._mesh is not None:
            inputs, labels = self._batch_sharding.local((inputs, labels))
        dev = self._device
        return (tuple(as_tensor(a).to(dev, non_blocking=True)
                      for a in inputs),
                tuple(as_tensor(a).to(dev, non_blocking=True)
                      for a in labels))

    def _update_replicated(self, loss):
        """The optimizer's own step on every parameter (the gradients
        already averaged over a mesh); the sweep's flags, or None."""
        opt = self._optimizer
        # the reference's compiled update: the optimizer's learning rate
        # for every parameter, dense gradients
        with opt.compiled_update():
            if self._check_nan:
                return opt.step_checked(
                    loss, self._swept, gate=self._guard_updates,
                    consensus=None if self._mesh is None
                    else self._world_and)
            opt.step()
        return None

    @staticmethod
    def _world_and(flags: torch.Tensor) -> torch.Tensor:
        """The flags AND-ed over every rank of the world (every rank then
        skips the same step)."""
        t = flags.to(torch.int32)
        comm.all_reduce(t, op=comm.ReduceOp.MIN)
        return t.bool()

    # -- one step over the mesh --------------------------------------------------
    def _compute_mesh(self, inputs, labels):
        """Forward and backward on this rank's rows, the reductions, the
        update; returns the global loss and the sweep's flags (or None)."""
        from ...ops.attention import ring_scope

        if self._zero >= 3:
            self._gather_params()
        elif self._synced_views:
            for bk in self._buckets:
                bk.install()
            self._synced_views = False
        data_pg = (self._data_group.process_group
                   if self._data_group is not None else None)
        scope = (ring_scope(self._sp_group) if self._sp_axis
                 else contextlib.nullcontext())
        with data_parallel_scope(data_pg, self._data_size), scope:
            loss = self._loss_fn(self._apply(*inputs), *labels).float()
            loss.backward()
        loss = loss.detach().clone()
        self._mean_over_data(loss)
        if self._zero == 0:
            self._reduce_grads_replicated()
            return loss, self._update_replicated(loss)
        grads = self._reduce_grads_sharded()
        if self._zero >= 3:
            for bk in self._buckets:
                bk.release()
        flags = self._update_sharded(loss, grads)
        if self._zero < 3:
            for bk in self._buckets:
                self._all_gather(bk.full, bk.shard.clone())
        return loss, flags

    def _mean_over_data(self, t: torch.Tensor) -> None:
        if self._data_group is None:
            return
        comm.all_reduce(t, group=self._data_group)
        if self._data_size > 1:
            t.div_(self._data_size)

    def _all_gather(self, out: torch.Tensor, shard: torch.Tensor) -> None:
        """``out`` ← the sharding group's shards in rank order."""
        if self._sharding_group is None:
            out.copy_(shard)
            return
        with comm._collective_span("all_gather", self._sharding_group,
                                   comm._nbytes(out)):
            comm.all_gather_into(out, shard,
                                 self._sharding_group.process_group)

    def _gather_params(self) -> None:
        """ZeRO-3: every bucket's full buffer from the shards, and the
        parameters pointed at it."""
        for bk in self._buckets:
            self._all_gather(bk.materialize(), bk.shard)
            bk.install()
        self._synced_views = False

    def _flat_grads(self, bk: FlatBucket) -> torch.Tensor:
        """The bucket's gradients packed into its flat buffer (zeros for a
        parameter without one and for the padding)."""
        if bk.grad_full is None:
            bk.grad_full = torch.zeros(bk.total, dtype=bk.dtype,
                                       device=bk.device)
        grads = [p.grad for p in bk.params]
        if any(g is None for g in grads):
            bk.grad_full.zero_()
        views = [bk.param_view(i, bk.grad_full)
                 for i, g in enumerate(grads) if g is not None]
        if views:
            torch._foreach_copy_(views, [g for g in grads if g is not None])
        return bk.grad_full

    @torch.no_grad()
    def _reduce_grads_replicated(self) -> None:
        """zero_stage 0: each dtype's gradients averaged over the data
        group in one all-reduce, then handed back as views."""
        for bk in self._buckets:
            had = [p.grad is not None for p in bk.params]
            flat = self._flat_grads(bk)
            self._mean_over_data(flat)
            for i, p in enumerate(bk.params):
                if had[i]:
                    p.grad = bk.param_view(i, flat)

    @torch.no_grad()
    def _reduce_grads_sharded(self):
        """ZeRO 1-3: the averaged gradient of this rank's shard of each
        bucket (ZeRO-1: all-reduced over the data group and sliced; 2 and
        3: reduce-scattered over the sharding group, then all-reduced over
        the data group); returns ``[(bucket, [S] grads, stepped)]``."""
        out = []
        for bk in self._buckets:
            stepped = [p.grad is not None for p in bk.params]
            flat = self._flat_grads(bk)
            if self._zero == 1:
                self._mean_over_data(flat)
                g = flat[bk.start:bk.start + bk.S]
            else:
                if bk.grad_shard is None:
                    bk.grad_shard = torch.empty(bk.S, dtype=bk.dtype,
                                                device=bk.device)
                g = bk.grad_shard
                if self._sharding_group is None:
                    g.copy_(flat)
                else:
                    comm.reduce_scatter(g, flat, op=comm.ReduceOp.AVG,
                                        group=self._sharding_group)
                self._mean_over_data(g)
            out.append((bk, g, stepped))
        return out

    @torch.no_grad()
    def _update_sharded(self, loss, grads):
        """ZeRO 1-3: kernel #7 over this rank's pieces, with the clip's
        global norm and the world's finite verdict; returns the flags."""
        opt = self._optimizer
        key = tuple(tuple(stepped) for _, _, stepped in grads)
        lists = self._piece_lists.get(key)
        if lists is None:  # the pieces' views: the same tensors every step
            lists = self._piece_lists[key] = self._pieces_of(grads)
        P, G, M1, M2, B1, B2, MS, WD, DC, NC, names = lists
        dev = self._device
        lr = opt.lr_device_scalar(dev)
        kw = dict(beta1=opt._beta1, beta2=opt._beta2, eps=opt._epsilon,
                  weight_decay=WD, decoupled_decay=DC, need_clip=NC)
        norm = None
        clip = opt._grad_clip
        if clip is not None:
            if G:
                sq = fused.grad_global_norm(G, clip.clip_norm, NC)[:1]
                sq = sq.square()
            else:
                sq = torch.zeros(1, dtype=torch.float32, device=dev)
            if self._sharding_group is not None:
                comm.all_reduce(sq, group=self._sharding_group)
            n = sq.sqrt()
            norm = torch.cat([n, clip.clip_norm / n.clamp(min=clip.clip_norm)])
        flags = ok = None
        with opt.compiled_update():
            if self._check_nan:
                local = (fused.adam_finite_check(
                    P, G, M1, M2, B1, B2, lr, MS, norm=norm, loss=loss,
                    **kw)[0] if P else None)
                flags = self._name_flags(local, names, loss)
                ok = flags.all().to(torch.int32)
            if P:
                fused.fused_adam_step(
                    P, G, M1, M2, B1, B2, lr, masters=MS, norm=norm,
                    ok=ok if self._guard_updates else None, **kw)
        opt._global_step += 1
        return flags

    def _pieces_of(self, grads):
        """The update's lists over this rank's pieces of the parameters
        stepped: views of the flat shards, their state and gradients (all
        persistent tensors), the coefficients and the names."""
        opt = self._optimizer
        P, G, M1, M2, B1, B2, MS, WD, DC, NC, names = ([] for _ in range(11))
        for bk, g, stepped in grads:
            for pc in bk.pieces:
                if not stepped[pc.index]:
                    continue
                p = bk.params[pc.index]
                P.append(bk.shard[pc.a:pc.b])
                G.append(g[pc.a:pc.b])
                M1.append(bk.m1[pc.a:pc.b])
                M2.append(bk.m2[pc.a:pc.b])
                B1.append(bk.b1p[pc.index])
                B2.append(bk.b2p[pc.index])
                MS.append(bk.master[pc.a:pc.b] if bk.master is not None
                          else None)
                WD.append(opt._l2_coeff(p))
                DC.append(opt._decoupled_coeff(p))
                NC.append(getattr(p, "need_clip", True))
                names.append(bk.names[pc.index])
        return P, G, M1, M2, B1, B2, MS, WD, DC, NC, names

    def _name_flags(self, local, names, loss) -> torch.Tensor:
        """The sweep's flags by parameter name (``[loss, grad[n]..,
        param[n]..]`` in ``_nan_names``' order) from this rank's pieces'
        flags, AND-ed over the world."""
        n = len(self._swept_index)
        dev = loss.device
        out = torch.ones(1 + 2 * n, dtype=torch.int32, device=dev)
        if local is None:
            out[0] = torch.isfinite(loss).all().to(torch.int32)
        else:
            key = (dev, tuple(names))
            slots = self._flag_slots.get(key)
            if slots is None:
                js = [self._swept_index[nm] for nm in names]
                slots = self._flag_slots[key] = torch.tensor(
                    [0] + [1 + j for j in js] + [1 + n + j for j in js],
                    device=dev)
            out.scatter_reduce_(0, slots, local[:-1].to(torch.int32),
                                "amin")
        return self._world_and(out)

    # -- remat='auto' ----------------------------------------------------------
    def lower_cost(self, policy, inputs, labels) -> Optional[Dict[str, float]]:
        """``remat_policy.step_cost`` of this step's forward and backward
        under ``policy`` on this batch (the measurement ``remat='auto'``
        ladders on), or None when it runs out of memory. The engine is left
        as it was (see the module docstring)."""
        if self._zero >= 3:
            raise NotImplementedError(
                "lower_cost measures the step on the resident parameters; "
                "ZeRO-3 keeps only their shards")
        inputs, labels = self._to_device(inputs, labels)
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
        if self._zero >= 1:
            for bk in self._buckets:
                tensors += [t for t in (bk.shard, bk.m1, bk.m2, bk.master)
                            if t is not None]
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
        if self._zero >= 1:
            self._sync_sharded()
            return
        if not self._master:
            return
        named = dict(self._layer.named_parameters())
        set_params(self._layer, {
            n: self._optimizer.state_for(p)["master"].clone()
            for n, p in named.items() if p.is_floating_point()})
        self._synced = True

    @torch.no_grad()
    def _sync_sharded(self) -> None:
        """ZeRO: the layer gets the gathered parameters (the f32 masters in
        master mode) and the optimizer the gathered state, as the
        reference's ``sync_to_layer`` hands it over; the next step points
        the parameters back at the flat buffers."""
        params, state, _ = self._gathered_state()
        named = dict(self._layer.named_parameters())
        for bk in self._buckets:
            for n in bk.names:
                p = named[n]
                src = state[n]["master"] if self._master else params[n]
                p.data = src.clone()
                self._optimizer._accumulators[id(p)] = state[n]
        self._synced_views = True

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
        if self._zero >= 1:
            named = dict(self._layer.named_parameters())
            for bk in self._buckets:
                vals = {n: named[n].detach() for n in bk.names}
                sl = slice(bk.start, bk.start + bk.S)
                full = bk.scatter_values(vals)
                if bk.master is not None:
                    new = bk.scatter_values(vals, torch.float32)[sl]
                    bk.master.copy_(torch.where(
                        bk.master.to(bk.dtype) == full[sl], bk.master, new))
                bk.shard.copy_(full[sl])
                if self._zero < 3:
                    bk.full.copy_(full)
            self._synced_views = True
            return
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
