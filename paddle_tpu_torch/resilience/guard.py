"""StepGuard — policy-driven recovery around train steps; counterpart of
``paddle_tpu.resilience.guard``, the whole module.

Turns the sanitizer's detect-and-die contract (``core.sanitizer`` raises
``FloatingPointError`` on any non-finite leaf) into detect-recover-
continue, in layers:

1. **Skip** — engines built with ``guard_updates=True`` keep, on the
   device, the incoming params/buffers/optimizer state when the step's
   own finite sweep fails (the Adam kernel's check pass gates its
   update; see ``distributed.fleet.engine``): a non-finite step never
   applies its optimizer update, at zero host round-trips. The guard
   then reads the small flag vector, quarantines the offending host
   batch to disk for offline repro, and backs off the AMP loss scale.
2. **Rollback** — K *consecutive* bad steps mean the parameters were
   likely already poisoned by an earlier finite-but-wrong update; the
   guard rolls engine state back to its rolling last-good snapshot (an
   in-memory on-device copy taken every ``snapshot_every`` good steps,
   periodically spilled to disk via
   ``incubate.checkpoint.save_train_state``).
3. **Give up** — ``max_rollbacks`` rollbacks without a single good step
   in between re-raises ``FloatingPointError`` (detection is still the
   floor: recovery never silently loops forever).

The guard is also the step-boundary host for the other resilience
layers: it feeds the Watchdog heartbeat, checks the preemption flag
(emergency checkpoint → ``EXIT_PREEMPTED``), drives the silent-
corruption ``IntegrityMonitor`` (``integrity=`` ctor arg — fingerprint
exchange + healthy-replica repair, with this guard's rolling snapshot
as the repair ladder's second rung), and consults the active
``FaultInjector`` so every one of these paths is testable
deterministically.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.sanitizer import finite_report  # noqa: F401  (engine contract)
from ..core.tree import flatten_with_path, structure, tree_map, unflatten
from ..profiler import goodput as _goodput
from ..profiler.telemetry import get_telemetry
from . import watchdog as _watchdog
from .inject import active_injector
from .preemption import EXIT_PREEMPTED, preemption_requested

__all__ = ["RecoveryPolicy", "StepGuard", "finite_report", "copy_tree",
           "quarantine_batch", "load_quarantine", "replay_quarantine"]


def copy_tree(tree):
    """A copy of every tensor leaf on its own device (other leaves as
    they are): a snapshot that the engine's in-place updates cannot
    reach."""
    return tree_map(lambda a: a.detach().clone()
                    if isinstance(a, torch.Tensor) else a, tree)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a bf16 tensor widened to f32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


# -- batch quarantine ------------------------------------------------------

def quarantine_batch(directory: str, step: int, inputs, labels,
                     bad_names=()) -> str:
    """Persist the batch that produced a non-finite step, for offline
    repro (``replay_quarantine``). Host numpy only — fetching the batch
    is fine on the bad path. The batch's STRUCTURE is saved alongside the
    leaves (``core.tree.structure``, as JSON), so a structured batch (dict
    of features, nested tuples) replays with its original shape, not as
    a flat tuple. Returns the file path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step-{int(step)}.npz")
    arrays = {}
    treedefs = {}
    counts = {}
    for prefix, tree in (("input", inputs), ("label", labels)):
        leaves = [leaf for _, leaf in flatten_with_path(tree)]
        treedefs[prefix] = structure(tree)
        counts[prefix] = len(leaves)
        for i, leaf in enumerate(leaves):
            arrays[f"{prefix}_{i}"] = _host_array(leaf)
    meta = {"step": int(step), "bad": list(bad_names), "ts": time.time(),
            "n_inputs": counts["input"], "n_labels": counts["label"]}

    def _write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f,
                     __meta__=np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8),
                     __treedefs__=np.frombuffer(json.dumps(treedefs).encode(),
                                                dtype=np.uint8),
                     **arrays)

    from ..framework.io import atomic_replace

    atomic_replace(path, _write)
    return path


def load_quarantine(path: str):
    """Returns ``(inputs, labels, meta)`` with the original structure
    restored (leaves come back as host numpy arrays)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        treedefs = _skeleton(json.loads(bytes(z["__treedefs__"]).decode()))
        inputs = unflatten(
            treedefs["input"],
            [z[f"input_{i}"] for i in range(meta["n_inputs"])])
        labels = unflatten(
            treedefs["label"],
            [z[f"label_{i}"] for i in range(meta["n_labels"])])
    return inputs, labels, meta


def _skeleton(s):
    """A ``core.tree.structure`` skeleton back from JSON (lists for its
    tuples)."""
    if isinstance(s, dict):
        return {k: _skeleton(v) for k, v in s.items()}
    kind = s[0]
    if kind == "dict":
        return ("dict", [(k, _skeleton(v)) for k, v in s[1]])
    if kind in ("list", "tuple"):
        return (kind, [_skeleton(v) for v in s[1]])
    return (kind,)


def replay_quarantine(step_engine, path: str) -> Tuple[bool, List[str]]:
    """Run a quarantined batch through a guarded step in isolation and
    return its finite report — ``(False, bad_leaves)`` confirms the
    repro. The engine must be built with ``guard_updates=True`` so the
    replay cannot corrupt its state either."""
    inputs, labels, _ = load_quarantine(path)
    step_engine(inputs, labels)
    return step_engine.last_step_finite()


# -- the guard -------------------------------------------------------------

@dataclasses.dataclass
class RecoveryPolicy:
    """Knobs for StepGuard. Defaults are conservative: skip bad steps,
    roll back after 3 in a row, give up after 3 fruitless rollbacks.

    Env knobs (read by ``from_env``): PADDLE_TPU_GUARD_K,
    PADDLE_TPU_GUARD_MAX_ROLLBACKS, PADDLE_TPU_GUARD_SNAPSHOT_EVERY.
    """

    max_consecutive_bad: int = 3    # K: bad streak before rollback
    max_rollbacks: int = 3          # rollbacks w/o a good step before raising
    snapshot_every: int = 25        # good steps between rolling snapshots
    spill_every: int = 0            # snapshots between disk spills (0 = off)
    spill_path: Optional[str] = None      # disk home for spills + preemption
    quarantine_dir: Optional[str] = "quarantine"
    scale_backoff: float = 0.5      # AMP loss-scale multiplier per bad step
    min_loss_scale: float = 1.0

    @classmethod
    def from_env(cls, **overrides) -> "RecoveryPolicy":
        env = os.environ
        base = dict(
            max_consecutive_bad=int(env.get("PADDLE_TPU_GUARD_K", 3)),
            max_rollbacks=int(env.get("PADDLE_TPU_GUARD_MAX_ROLLBACKS", 3)),
            snapshot_every=int(env.get("PADDLE_TPU_GUARD_SNAPSHOT_EVERY", 25)),
        )
        base.update(overrides)
        return cls(**base)


class StepGuard:
    """Wrap a guarded step engine (``jit.TrainStep`` or
    ``fleet.ParallelTrainStep`` built with ``guard_updates=True``) in the
    recovery policy. Call it exactly like the engine::

        step = TrainStep(net, loss_fn, opt, guard_updates=True)
        guard = StepGuard(step, RecoveryPolicy(spill_path="ckpt/em"))
        guard.install_preemption()
        for i in range(guard.resume(), total_steps):
            loss = guard(inputs[i], labels[i])

    ``step_count`` counts ATTEMPTED steps (bad steps consume their batch
    too), so it doubles as the data-position cursor across preemption
    resume.

    Cost: the guard reads the step's tiny flag vector after every call,
    which synchronizes on that step's completion — the same per-step
    fetch the ``FLAGS_check_nan_inf`` detect path has always paid, but
    it does bound a guarded loop at device step time (no host/device
    overlap). Deferred (lag-one) flag checking would recover the overlap
    and is left as future work; the engine's gate keeps state safe
    either way.
    """

    def __init__(self, step, policy: Optional[RecoveryPolicy] = None,
                 scaler=None, injector=None,
                 on_preempt: Optional[Callable[[], None]] = None,
                 integrity=None):
        if not getattr(step, "_guard_updates", False):
            raise ValueError(
                "StepGuard needs an engine built with guard_updates=True "
                "(TrainStep/ParallelTrainStep ctor arg) — without it the "
                "step applies non-finite updates before the guard can see "
                "them")
        self._engine = step
        self.policy = policy or RecoveryPolicy()
        self._scaler = scaler
        self._injector = injector
        self._on_preempt = on_preempt
        # silent-corruption defense (resilience.integrity): the monitor
        # consumes the engine's fingerprints at step boundaries,
        # exchanges them across ranks, and repairs divergence from a
        # healthy replica — with this guard's rolling snapshot as its
        # second rung on the repair ladder
        self._integrity = integrity
        if integrity is not None and integrity._snapshot_restore is None:
            integrity._snapshot_restore = self._restore_snapshot
        self.step_count = 0
        self._snap = None
        self._snap_meta = None
        self._snap_step = -1
        self._snapshots = 0
        self._bad_streak = 0
        self._rollbacks_since_good = 0

    # -- lifecycle ---------------------------------------------------------
    def install_preemption(self) -> "StepGuard":
        from .preemption import install_preemption_handler

        install_preemption_handler()
        return self

    def resume(self) -> int:
        """Restore the engine from the spill checkpoint when one exists
        (emergency or periodic) and return the step to continue from —
        0 on a fresh run. The loop owns data positioning: batch ``i``
        must be derivable from ``i`` (or the loader re-wound)."""
        p = self.policy.spill_path
        if not p:
            return self.step_count
        from ..incubate.checkpoint import restore_train_state

        if not (os.path.exists(p) or os.path.exists(p + ".tmp-old")):
            return self.step_count
        # restore_train_state already owns the I/O retry policy; the
        # whole resume (read + reinstall + meta) is checkpoint_restore
        # wall time in the goodput ledger
        with _goodput.activity("checkpoint_restore"):
            payload = restore_train_state(p)
            self._engine.restore_state(payload["state"])
            if "opt_meta" in payload:
                self._apply_opt_meta(
                    json.loads(bytes(np.asarray(payload["opt_meta"],
                                                dtype=np.uint8)).decode()))
            self.step_count = int(np.asarray(payload["step"]))
        get_telemetry().counter("resilience/resumes")
        self._take_snapshot(self.step_count)
        return self.step_count

    # -- the guarded step --------------------------------------------------
    def __call__(self, inputs, labels):
        step_i = self.step_count
        _watchdog.heartbeat(step_i)
        self._check_preemption()
        inj = self._injector if self._injector is not None \
            else active_injector()
        if inj is not None:
            inj.maybe_sigterm(step_i)
            self._check_preemption()  # same boundary sees the injected signal
            inj.maybe_kill_rank(step_i)   # SIGKILL: never returns if due
            inj.maybe_hang_rank(step_i)   # heartbeat starvation if due
            if inj.bitflip_param_due(step_i):
                # silent on-device corruption: finite, tiny, invisible
                # to the NaN sweep — only the fingerprint divergence
                # path (resilience.integrity) can catch it
                from .integrity import corrupt_param_bit

                corrupt_param_bit(self._engine)
            inputs = inj.corrupt_batch(step_i, inputs)
            inj.maybe_slow(step_i)
            inj.maybe_slow_rank(step_i)  # rank-scoped straggler stall
        if self._snap is None:
            # the load-time state is known-good by definition; every
            # later snapshot is taken only AFTER a verified-good step
            self._take_snapshot(step_i)
        # goodput: the guarded step INCLUDING the finite sweep's device
        # sync is productive wall time; recovery work nests inside and
        # claims rollback_recovery for itself (a nested claim suspends
        # this one, so nothing double-books)
        with _goodput.activity("productive_step"):
            loss = self._engine(inputs, labels)
            ok, bad = self._engine.last_step_finite()
            self.step_count += 1
            if ok:
                self._bad_streak = 0
                self._rollbacks_since_good = 0
                if (self.step_count - self._snap_step) \
                        >= self.policy.snapshot_every:
                    # refresh only on a good step: refreshing pre-step
                    # could capture params already poisoned by a
                    # finite-but-wrong update right before a bad streak —
                    # exactly the state rollback exists to escape
                    self._take_snapshot(self.step_count)
            else:
                self._handle_bad(step_i, inputs, labels, bad)
            if self._integrity is not None:
                # divergence check rides the SAME boundary on every rank
                # (ranks run the loop in lockstep, so the exchange cannot
                # deadlock against a peer that skipped it); on bad steps
                # the fingerprint covers the KEPT state — the gate ran
                # before the fingerprint fold
                self._integrity.after_step(self.step_count)
        return loss

    # -- internals ---------------------------------------------------------
    def _restore_snapshot(self) -> bool:
        """Integrity-monitor fallback rung: reinstall the rolling
        last-good snapshot's ARRAYS (False when none exists yet).

        Deliberately does NOT roll back the optimizer's global-step/LR
        cursor the way the NaN rollback does: the surviving ranks are
        still at the current loop position, and the fingerprint schedule
        and exchange keys are derived from the step counter — a minority
        rank that rewinds its cursor would fingerprint at different step
        labels than its peers and deadlock every later exchange. Keeping
        the cursor means this rung restores older-but-clean arrays at
        the current position; the next interval's exchange then repairs
        the remaining delta from the healthy replica (or re-detects)."""
        if self._snap is None:
            return False
        tel = get_telemetry()
        with _goodput.activity("rollback_recovery"), \
                tel.timer("resilience/rollback_ms"):
            self._engine.restore_state(self._snap)
        tel.counter("resilience/rollbacks")
        return True

    def _opt_meta(self):
        """Scalar optimizer state the array snapshot misses: the global
        step and the LR scheduler position. Without these, a resumed (or
        rolled-back) job's warmup/decay schedule restarts from zero while
        the params continue from step N."""
        opt = getattr(self._engine, "_optimizer", None)
        if opt is None:
            return None
        meta = {"global_step": int(getattr(opt, "_global_step", 0))}
        sched = getattr(opt, "_learning_rate", None)
        if hasattr(sched, "state_dict"):
            meta["lr"] = sched.state_dict()
        return meta

    def _apply_opt_meta(self, meta) -> None:
        opt = getattr(self._engine, "_optimizer", None)
        if opt is None or not meta:
            return
        opt._global_step = int(meta.get("global_step", 0))
        sched = getattr(opt, "_learning_rate", None)
        if "lr" in meta and hasattr(sched, "set_state_dict"):
            sched.set_state_dict(meta["lr"])

    def _take_snapshot(self, step_i: int) -> None:
        self._snap = self._engine.snapshot_state()
        self._snap_meta = self._opt_meta()
        self._snap_step = step_i
        self._snapshots += 1
        pol = self.policy
        if pol.spill_every and pol.spill_path \
                and self._snapshots % pol.spill_every == 0:
            self._spill(step_i)

    def _spill(self, step_i: int) -> None:
        # save_train_state already owns the I/O retry policy
        from ..incubate.checkpoint import save_train_state

        payload = {"state": self._snap, "step": np.asarray(int(step_i))}
        if self._snap_meta is not None:
            # scalar side-band rides as a uint8 JSON array (LR state may
            # hold strings and bools)
            payload["opt_meta"] = np.frombuffer(
                json.dumps(self._snap_meta).encode(), dtype=np.uint8)
        # goodput: both the periodic spill (nested under the step's
        # claim) and the emergency preemption spill are checkpoint_save
        with _goodput.activity("checkpoint_save"):
            save_train_state(payload, self.policy.spill_path)
        get_telemetry().counter("resilience/spills")

    def _check_preemption(self) -> None:
        if not preemption_requested():
            return
        from .preemption import exit_for_relaunch

        # from the latch to the exit, wall time is drain_shutdown (the
        # emergency spill below still claims checkpoint_save for itself)
        _goodput.shutdown_begin()
        if self.policy.spill_path:
            # the CURRENT state (not the rolling snapshot): every good
            # step since the last spill survives the preemption
            self._snap = self._engine.snapshot_state()
            self._snap_meta = self._opt_meta()
            self._snap_step = self.step_count
            self._spill(self.step_count)
        exit_for_relaunch(self._on_preempt)

    def _handle_bad(self, step_i: int, inputs, labels, bad_names) -> None:
        tel = get_telemetry()
        tel.counter("resilience/nonfinite_steps")
        pol = self.policy
        # goodput: everything downstream of a non-finite step — the
        # quarantine spill, the scale backoff, the snapshot rollback —
        # is recovery wall time, not productive step time (this nests
        # inside the step's claim and suspends it)
        with _goodput.activity("rollback_recovery"):
            if pol.quarantine_dir:
                with tel.timer("resilience/quarantine_ms"):
                    quarantine_batch(pol.quarantine_dir, step_i, inputs,
                                     labels, bad_names)
                tel.counter("resilience/quarantined_batches")
            if self._scaler is not None and getattr(
                    self._scaler, "is_enable", lambda: False)():
                self._scaler.backoff(pol.scale_backoff, pol.min_loss_scale)
            self._bad_streak += 1
            if self._bad_streak < pol.max_consecutive_bad:
                return  # the engine's gate already skipped the update
            if self._rollbacks_since_good >= pol.max_rollbacks:
                shown = ", ".join(bad_names[:8])
                try:
                    from ..profiler.spans import flight_recorder

                    tail = ("\n-- flight recorder (last span events, "
                            "newest last) --\n"
                            + flight_recorder().format_tail(20))
                except Exception:
                    tail = ""
                raise FloatingPointError(
                    f"StepGuard: giving up after "
                    f"{self._rollbacks_since_good} rollbacks without a "
                    f"finite step (step {step_i}, non-finite: {shown}). "
                    f"Quarantined batches are under "
                    f"{pol.quarantine_dir!r} for repro." + tail)
            with tel.timer("resilience/rollback_ms"):
                self._engine.restore_state(self._snap)
                self._apply_opt_meta(self._snap_meta)
            tel.counter("resilience/rollbacks")
            self._rollbacks_since_good += 1
            self._bad_streak = 0
