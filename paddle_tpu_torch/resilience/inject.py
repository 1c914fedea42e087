"""Deterministic fault injection — the harness that keeps every recovery
path in ``resilience`` exercised, not just claimed; counterpart of
``paddle_tpu.resilience.inject``, the whole module (its batches are
torch's: ``corrupt_batch`` poisons a tensor on its own device, or a numpy
array).

Faults are keyed on STEP (or batch) indices, never on randomness, so a
failing recovery test replays bit-identically. Injection points are
consulted by the runtime itself:

- ``corrupt_batch(step, inputs)`` — StepGuard poisons the first float
  leaf of the batch with NaN at the configured steps (the NaN then flows
  through the REAL step into loss/grads, exactly like a bad example or
  an overflowed activation would);
- ``maybe_slow(step)`` — StepGuard sleeps at a step boundary, tripping
  the Watchdog deadline;
- ``maybe_slow_rank(step)`` — rank-scoped boundary stall
  (``slow_rank@step:rank:secs``): exactly ONE rank of a multi-process
  job straggles deterministically — short enough not to trip the hang
  supervisor, long enough that the cluster-timeline skew analysis
  (``profiler.cluster_trace`` / ``check_cluster_timeline``) must name
  this rank late into the next collective;
- ``maybe_sigterm(step)`` — StepGuard delivers a real SIGTERM to this
  process, driving the preemption path end-to-end;
- ``worker_kill_due(batch_idx)`` — the DataLoader multiprocess iterator
  SIGKILLs the worker that produced the given batch, driving the
  respawn/re-enqueue path;
- ``maybe_kill_rank(step)`` — StepGuard SIGKILLs THIS process when its
  trainer rank matches the plan (``kill_rank@step:r``), driving the
  launch supervisor's rank-failure detection + elastic relaunch;
- ``maybe_hang_rank(step)`` — StepGuard parks the rank in a long sleep
  (``hang_rank@step:r``), starving its heartbeat file so the supervisor
  detects a hung rank;
- ``corrupt_ckpt_due(generation)`` — ``ClusterCheckpoint`` flips a byte
  in one committed shard AFTER the commit (``corrupt_ckpt@n``), so the
  manifest-verified restore path must catch it and fall back;
- ``bitflip_param_due(step)`` — StepGuard flips ONE low-mantissa bit of
  one resident parameter at the step boundary when this rank matches
  (``bitflip_param@step:r``, via ``resilience.integrity
  .corrupt_param_bit``): silent in-device corruption — finite, tiny,
  invisible to the NaN/Inf sweep — that only the bit-exact fingerprint
  divergence path (``resilience.integrity``) can catch.

Request-level faults (consulted by ``inference.serving``; indices are
engine-assigned request ids / scheduler batch indices, so they replay
deterministically against a deterministic load plan):

- ``slow_req(req_id)`` — the batch CONTAINING request ``req_id`` stalls
  (``slow_req@id:secs``): a straggler request that backs the queue up,
  driving admission rejects and queued-deadline expiry downstream;
- ``drop_req_due(req_id)`` — that request's result is lost
  post-execution (``drop_req@id``): the accounting layer must still
  terminate it (ERROR), proving no request can vanish silently;
- ``storm_deadline(req_id)`` — ``deadline_storm@id:n`` gives the ``n``
  requests starting at ``id`` a near-zero deadline (default 1 ms):
  a burst of already-hopeless work the server must shed at every stage
  without stalling live traffic;
- the existing ``sigterm@n`` is also consulted by the serving scheduler
  at batch-boundary ``n`` — a deterministic mid-load preemption.

Env-driven for subprocess runs (the CI smoke gate, launch children):

    PADDLE_TPU_INJECT="nan@3,sigterm@7,slow@5:1.5,kill_worker@2"
    PADDLE_TPU_INJECT="kill_rank@4:1,hang_rank@2:0,corrupt_ckpt@1"
    PADDLE_TPU_INJECT="bitflip_param@3:1,slow_rank@5:1:0.75"
    PADDLE_TPU_INJECT="slow_req@10:0.4,drop_req@12,deadline_storm@20:8"

One-shot semantics: every injection fires at most once per injector.
Cross-process one-shot (a relaunched job must not re-receive the same
SIGTERM) is handled by marker files under ``PADDLE_TPU_INJECT_STATE``
(or the ``state_dir`` argument) — present marker means already fired.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, Iterable, Optional, Set

import numpy as np

__all__ = ["FaultInjector", "install_injector", "active_injector",
           "clear_injector"]

_ENV_SPEC = "PADDLE_TPU_INJECT"
_ENV_STATE = "PADDLE_TPU_INJECT_STATE"


class FaultInjector:
    """Deterministic, step-indexed fault plan.

    Args:
        nan_steps: step indices whose batch gets a NaN poisoned into its
            first floating leaf.
        sigterm_steps: step indices at whose boundary a real SIGTERM is
            delivered to this process.
        slow_steps: ``{step: seconds}`` boundary sleeps (watchdog food).
        slow_rank_steps: ``{step: (rank, seconds)}`` — boundary sleep
            only when this process's trainer rank matches: the
            deterministic single-rank straggler the cluster-timeline
            gate blames.
        kill_worker_batches: batch indices after whose delivery the
            producing DataLoader worker is SIGKILLed.
        kill_rank_steps: ``{step: rank}`` — SIGKILL this process at the
            step boundary when its trainer rank matches.
        hang_rank_steps: ``{step: rank}`` — park this process in a
            ``hang_seconds`` sleep (heartbeat starvation) when its
            trainer rank matches.
        corrupt_ckpt_gens: committed cluster-checkpoint generation
            ordinals to bit-flip post-commit.
        hang_seconds: duration of an injected hang — long enough that
            only supervisor detection (not the sleep ending) can end it.
        state_dir: directory for cross-process one-shot markers; a fault
            whose marker file exists never fires again (survives the
            relaunch the fault itself provokes).
    """

    def __init__(self, nan_steps: Iterable[int] = (),
                 sigterm_steps: Iterable[int] = (),
                 slow_steps: Optional[Dict[int, float]] = None,
                 slow_rank_steps: Optional[Dict[int, tuple]] = None,
                 kill_worker_batches: Iterable[int] = (),
                 kill_rank_steps: Optional[Dict[int, int]] = None,
                 hang_rank_steps: Optional[Dict[int, int]] = None,
                 bitflip_param_steps: Optional[Dict[int, int]] = None,
                 corrupt_ckpt_gens: Iterable[int] = (),
                 hang_seconds: float = 3600.0,
                 slow_req_ids: Optional[Dict[int, float]] = None,
                 drop_req_ids: Iterable[int] = (),
                 deadline_storms: Optional[Dict[int, int]] = None,
                 storm_deadline_s: float = 1e-3,
                 state_dir: Optional[str] = None):
        self.nan_steps = {int(s) for s in nan_steps}
        self.sigterm_steps = {int(s) for s in sigterm_steps}
        self.slow_steps = {int(k): float(v)
                           for k, v in (slow_steps or {}).items()}
        self.slow_rank_steps = {
            int(k): (int(v[0]), float(v[1]))
            for k, v in (slow_rank_steps or {}).items()}
        self.kill_worker_batches = {int(b) for b in kill_worker_batches}
        self.kill_rank_steps = {int(k): int(v)
                                for k, v in (kill_rank_steps or {}).items()}
        self.hang_rank_steps = {int(k): int(v)
                                for k, v in (hang_rank_steps or {}).items()}
        self.bitflip_param_steps = {
            int(k): int(v) for k, v in (bitflip_param_steps or {}).items()}
        self.corrupt_ckpt_gens = {int(g) for g in corrupt_ckpt_gens}
        self.hang_seconds = float(hang_seconds)
        self.slow_req_ids = {int(k): float(v)
                             for k, v in (slow_req_ids or {}).items()}
        self.drop_req_ids = {int(r) for r in drop_req_ids}
        # deadline_storm@id:n expands to the n request ids it covers
        self.storm_req_ids: Set[int] = set()
        for start, n in (deadline_storms or {}).items():
            self.storm_req_ids.update(range(int(start), int(start) + int(n)))
        self.storm_deadline_s = float(storm_deadline_s)
        self.state_dir = state_dir
        self._fired: Set[str] = set()

    # -- plan parsing ------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str, state_dir: Optional[str] = None
                  ) -> "FaultInjector":
        """Parse ``"nan@3,sigterm@7,slow@5:1.5,kill_worker@2,
        kill_rank@4:1,hang_rank@2:0,corrupt_ckpt@1,
        slow_req@10:0.4,drop_req@12,deadline_storm@20:8"``."""
        nan, sig, kill, corrupt, drop_req = [], [], [], [], []
        slow: Dict[int, float] = {}
        slow_rank: Dict[int, tuple] = {}
        kill_rank: Dict[int, int] = {}
        hang_rank: Dict[int, int] = {}
        bitflip: Dict[int, int] = {}
        slow_req: Dict[int, float] = {}
        storms: Dict[int, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, where = part.partition("@")
            kind = kind.strip().lower()
            if kind == "slow":
                step, _, secs = where.partition(":")
                slow[int(step)] = float(secs or 1.0)
            elif kind == "slow_rank":
                # slow_rank@step:rank:secs — the rank field is required
                # (a rank-scoped fault without a rank is a spec bug, not
                # a default-to-0 guess)
                step, _, rest = where.partition(":")
                r, _, secs = rest.partition(":")
                if not r.strip():
                    raise ValueError(
                        f"slow_rank needs step:rank[:secs], got {part!r}")
                slow_rank[int(step)] = (int(r), float(secs or 1.0))
            elif kind == "nan":
                nan.append(int(where))
            elif kind == "sigterm":
                sig.append(int(where))
            elif kind == "kill_worker":
                kill.append(int(where))
            elif kind in ("kill_rank", "hang_rank", "bitflip_param"):
                step, _, r = where.partition(":")
                target = {"kill_rank": kill_rank, "hang_rank": hang_rank,
                          "bitflip_param": bitflip}[kind]
                target[int(step)] = int(r or 0)
            elif kind == "corrupt_ckpt":
                corrupt.append(int(where))
            elif kind == "slow_req":
                rid, _, secs = where.partition(":")
                slow_req[int(rid)] = float(secs or 1.0)
            elif kind == "drop_req":
                drop_req.append(int(where))
            elif kind == "deadline_storm":
                rid, _, n = where.partition(":")
                storms[int(rid)] = int(n or 1)
            else:
                raise ValueError(f"unknown fault kind {kind!r} in {spec!r}")
        return cls(nan_steps=nan, sigterm_steps=sig, slow_steps=slow,
                   slow_rank_steps=slow_rank,
                   kill_worker_batches=kill, kill_rank_steps=kill_rank,
                   hang_rank_steps=hang_rank, bitflip_param_steps=bitflip,
                   corrupt_ckpt_gens=corrupt,
                   slow_req_ids=slow_req, drop_req_ids=drop_req,
                   deadline_storms=storms, state_dir=state_dir)

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        env = os.environ if env is None else env
        spec = env.get(_ENV_SPEC)
        if not spec:
            return None
        return cls.from_spec(spec, state_dir=env.get(_ENV_STATE))

    # -- one-shot bookkeeping ---------------------------------------------
    def _once(self, key: str) -> bool:
        """True exactly once per fault key (per process, and per
        ``state_dir`` when configured)."""
        if key in self._fired:
            return False
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
            marker = os.path.join(self.state_dir, key + ".done")
            if os.path.exists(marker):
                self._fired.add(key)
                return False
            with open(marker, "w") as f:
                f.write(str(time.time()))
        self._fired.add(key)
        return True

    # -- injection points --------------------------------------------------
    def corrupt_batch(self, step: int, batch):
        """Poison the first floating leaf of ``batch`` with NaN when
        ``step`` is scheduled; otherwise return the batch unchanged. A
        tensor leaf is poisoned in a copy on its own device, any other
        leaf in a numpy copy."""
        if int(step) not in self.nan_steps or not self._once(f"nan@{step}"):
            return batch
        import torch

        from ..core.tree import tree_map

        self._count("nan")
        done = [False]

        def poison(leaf):
            if done[0]:
                return leaf
            if isinstance(leaf, torch.Tensor):
                if not leaf.is_floating_point():
                    return leaf
                a = leaf.detach().clone(
                    memory_format=torch.contiguous_format)
                a.view(-1)[0] = float("nan")
                done[0] = True
                return a
            a = np.array(leaf, copy=True) if not hasattr(leaf, "dtype") \
                else np.asarray(leaf).copy()
            if np.issubdtype(a.dtype, np.floating):
                a.ravel()[0] = np.nan
                done[0] = True
                return a
            return leaf

        return tree_map(poison, batch)

    def maybe_slow(self, step: int) -> float:
        secs = self.slow_steps.get(int(step), 0.0)
        if secs and self._once(f"slow@{step}"):
            self._count("slow")
            time.sleep(secs)
            return secs
        return 0.0

    def maybe_slow_rank(self, step: int) -> float:
        """Boundary sleep when BOTH the step and this process's trainer
        rank match the plan (``slow_rank@step:rank:secs``) — exactly one
        rank of the job straggles, deterministically. One-shot across
        relaunches via the state-dir marker (the secs field stays out of
        the marker key, like every other fault). Returns seconds slept."""
        due = self.slow_rank_steps.get(int(step))
        if due is None:
            return 0.0
        r, secs = due
        if r != self._rank() or not self._once(f"slow_rank@{step}:{r}"):
            return 0.0
        self._count("slow_rank")
        time.sleep(secs)
        return secs

    def maybe_sigterm(self, step: int) -> bool:
        if int(step) in self.sigterm_steps and self._once(f"sigterm@{step}"):
            self._count("sigterm")
            os.kill(os.getpid(), signal.SIGTERM)
            return True
        return False

    def worker_kill_due(self, batch_idx: int) -> bool:
        return (int(batch_idx) in self.kill_worker_batches
                and self._once(f"kill_worker@{batch_idx}"))

    @staticmethod
    def _rank() -> int:
        """This process's trainer rank, from the launcher env contract
        (the injector must work before and without device set-up)."""
        try:
            return int(os.environ.get("PADDLE_TRAINER_ID")
                       or os.environ.get("PROCESS_ID") or 0)
        except ValueError:
            return 0

    def maybe_kill_rank(self, step: int) -> bool:
        """SIGKILL this process at a scheduled (step, rank) boundary —
        the un-catchable death the launch supervisor must detect. The
        one-shot marker is written BEFORE the kill (the whole point is
        that the relaunched rank survives the same step)."""
        r = self.kill_rank_steps.get(int(step))
        if r is None or r != self._rank():
            return False
        if not self._once(f"kill_rank@{step}:{r}"):
            return False
        self._count("kill_rank")
        os.kill(os.getpid(), signal.SIGKILL)
        return True  # unreachable; documents intent

    def maybe_hang_rank(self, step: int) -> float:
        """Park this rank in a long sleep at a scheduled (step, rank)
        boundary, starving its heartbeat file. Ends only by supervisor
        teardown (SIGTERM interrupts the sleep; the marker, written
        before sleeping, keeps the relaunch hang-free)."""
        r = self.hang_rank_steps.get(int(step))
        if r is None or r != self._rank() \
                or not self._once(f"hang_rank@{step}:{r}"):
            return 0.0
        self._count("hang_rank")
        time.sleep(self.hang_seconds)
        return self.hang_seconds

    def bitflip_param_due(self, step: int) -> bool:
        """True exactly once at a scheduled (step, rank) boundary when
        THIS rank's resident state is due for a silent bit flip (the
        flip itself lives in ``resilience.integrity.corrupt_param_bit``,
        applied by StepGuard, which owns the engine). One-shot across
        relaunches via the state-dir marker, like ``kill_rank``."""
        r = self.bitflip_param_steps.get(int(step))
        if r is None or r != self._rank():
            return False
        if not self._once(f"bitflip_param@{step}:{r}"):
            return False
        self._count("bitflip_param")
        return True

    def slow_req(self, req_id: int) -> float:
        """Stall the caller (the serving scheduler, about to dispatch
        the batch containing request ``req_id``) — a deterministic
        straggler. Returns the seconds slept (0.0 when not scheduled)."""
        secs = self.slow_req_ids.get(int(req_id), 0.0)
        if secs and self._once(f"slow_req@{req_id}"):
            self._count("slow_req")
            time.sleep(secs)
            return secs
        return 0.0

    def drop_req_due(self, req_id: int) -> bool:
        """True exactly once when request ``req_id``'s computed result
        is scheduled to be lost post-execution (the drop itself lives in
        the serving scheduler, which must still terminate the request)."""
        return (int(req_id) in self.drop_req_ids
                and self._once(f"drop_req@{req_id}"))

    def storm_deadline(self, req_id: int) -> Optional[float]:
        """The near-zero deadline (seconds) request ``req_id`` should be
        submitted with when it falls inside an injected deadline storm;
        None otherwise."""
        if int(req_id) in self.storm_req_ids \
                and self._once(f"deadline_storm@{req_id}"):
            self._count("deadline_storm")
            return self.storm_deadline_s
        return None

    def corrupt_ckpt_due(self, generation: int) -> bool:
        """True exactly once when committed generation ``generation`` is
        scheduled for post-commit corruption (the byte flip itself lives
        in ``resilience.cluster.corrupt_one_shard``)."""
        return (int(generation) in self.corrupt_ckpt_gens
                and self._once(f"corrupt_ckpt@{generation}"))

    @staticmethod
    def _count(kind: str):
        from ..profiler.telemetry import get_telemetry

        get_telemetry().counter(f"resilience/injected_{kind}")


_active: Optional[FaultInjector] = None
_env_checked = False


def install_injector(injector: Optional[FaultInjector]) -> None:
    """Set the process-wide injector consulted by StepGuard/DataLoader."""
    global _active, _env_checked
    _active = injector
    _env_checked = True  # explicit install wins over the env spec


def active_injector() -> Optional[FaultInjector]:
    """The installed injector; lazily constructed from PADDLE_TPU_INJECT
    the first time anything asks. Returns None in un-injected runs (the
    overwhelmingly common case — callers must treat None as 'off')."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        _active = FaultInjector.from_env()
    return _active


def clear_injector() -> None:
    global _active, _env_checked
    _active = None
    _env_checked = False
