"""ServingEngine — counterpart of ``paddle_tpu.inference.serving.engine``:
the overload-safe request-serving runtime over one
``inference.Predictor``.

    client threads ──submit()──▶ AdmissionQueue ──take()──▶ BatchScheduler
                        │ explicit shed                        │ bucketed
                        ▼                                      ▼ step
                  REJECTED status                   OK / DEADLINE_EXCEEDED

Past capacity the server says no (``REJECTED`` at submit) instead of
buffering; expired work is shed at every stage; a drain stops admission,
lets queued work finish within a grace window and terminates the rest as
``DRAINED``. SIGTERM (``install_preemption``) triggers that drain, and
``exit_if_preempted`` then leaves with exit code 77 for the launch
supervisor to relaunch. Every submitted request reaches exactly one
terminal status — ``accounting()`` proves it. The token engine
(``decode.TokenServingEngine``) shares this lifecycle and brings its own
scheduler and ``submit``.

Telemetry (``serve/*``): counters ``requests accepted completed
admission_rejects deadline_exceeded drained errors batches
double_terminal drains``; gauges ``queue_depth queue_capacity draining
dtype_bits``; histograms ``latency_ms batch_ms[.b<N>] batch_occupancy``.
The reference's ops server, request traces and compile cache are not
ported.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ...profiler.telemetry import get_telemetry
from ...resilience.inject import active_injector
from .admission import ADMIT, REJECT_EXPIRED, AdmissionQueue
from .request import Request, RequestStatus
from .scheduler import BatchScheduler

__all__ = ["ServeConfig", "ServingEngine"]

_WAIT_SLICE_S = 0.05  # longest single wait of ``wait_drained``


class ServeConfig:
    """Serving knobs. ``buckets`` are batch-size buckets.

    Args:
        capacity: admission queue bound — past it submits are REJECTED.
        buckets: ascending batch sizes.
        max_batch: most requests packed per dispatch (default: largest
            bucket).
        default_deadline_s: deadline for requests that carry none.
        drain_grace_s: on drain, how long queued work may keep running
            before the remainder is DRAINED.
        idle_poll_s: scheduler wait per empty take().
    """

    def __init__(self, capacity: int = 64,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 max_batch: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 drain_grace_s: float = 5.0,
                 idle_poll_s: float = 0.01):
        self.capacity = int(capacity)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {buckets}")
        self.max_batch = (self.buckets[-1] if max_batch is None
                          else int(max_batch))
        if self.max_batch > self.buckets[-1]:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the largest bucket "
                f"{self.buckets[-1]} — a batch that fits no bucket cannot "
                "be dispatched")
        self.default_deadline_s = default_deadline_s
        self.drain_grace_s = float(drain_grace_s)
        self.idle_poll_s = float(idle_poll_s)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")


class ServingEngine:
    """Continuous-batching server over one ``inference.Predictor``: each
    dispatch packs the queued requests into the smallest batch bucket
    that fits and runs the predictor's ``serving_fn`` on the predictor's
    device."""

    def __init__(self, predictor, config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self._predictor = predictor
        self._serving_fn = predictor.serving_fn()
        self._sample_specs = predictor.sample_specs()
        self._init_runtime()

    def _make_scheduler(self):
        """The device loop (the token engine substitutes its own)."""
        return BatchScheduler(self)

    def _init_runtime(self) -> None:
        self._queue = AdmissionQueue(self.config.capacity)
        self._scheduler = self._make_scheduler()
        self._tel = get_telemetry()
        self._id_lock = threading.Lock()
        self._next_id = 0
        # the engine holds a request only while it is PENDING; the ledger
        # keeps counts, so memory is O(in-flight)
        self._pending: Dict[int, Request] = {}
        self._status_counts: Dict[str, int] = {}
        self._submitted_total = 0
        self._double_terminal = 0
        self._started = False
        self._drain_reason: Optional[str] = None
        self._drained = threading.Event()
        self._drain_latch_lock = threading.Lock()
        self._on_drain: Optional[Callable[[], None]] = None
        self._grace_timer: Optional[threading.Timer] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup: bool = True) -> "ServingEngine":
        """Start the scheduler thread; with ``warmup`` (default) after
        running every step shape once (kernel build, allocator, library
        handles), so the first request pays none of that. ``warmup_ms``
        holds each shape's wall time."""
        if self._started:
            return self
        self._tel.gauge("serve/queue_capacity", self.config.capacity)
        self._tel.gauge("serve/draining", 0)
        self._publish_start_gauges()
        self.warmup_ms = self._scheduler.warmup() if warmup else {}
        self._started = True
        self._scheduler.start()
        return self

    def _publish_start_gauges(self) -> None:
        self._tel.gauge("serve/dtype_bits",
                        getattr(self._predictor, "serving_dtype_bits", 32))

    # -- client side -------------------------------------------------------
    def submit(self, inputs: Sequence[np.ndarray],
               deadline_s: Optional[float] = None) -> Request:
        """Admit or shed one request (per-sample inputs, WITHOUT the
        batch axis). ALWAYS returns a ``Request``; a shed one is already
        terminal."""
        if not self._started:
            raise RuntimeError("ServingEngine.start() first")
        # validate before taking an id: a ValueError leaves the ledger
        if len(inputs) != len(self._sample_specs):
            raise ValueError(
                f"request has {len(inputs)} inputs, model takes "
                f"{len(self._sample_specs)}")
        arrays = []
        for a, (shape, dtype) in zip(inputs, self._sample_specs):
            a = np.asarray(a, dtype=dtype)
            if tuple(a.shape) != tuple(shape):
                raise ValueError(
                    f"request input shape {tuple(a.shape)} != per-sample "
                    f"spec {tuple(shape)} (submit WITHOUT the batch axis)")
            arrays.append(a)
        req_id = self._allocate_request_id()
        req = Request(req_id, arrays, self._resolve_deadline(req_id,
                                                             deadline_s))
        return self._admit(req)

    # -- admission funnel --------------------------------------------------
    def _allocate_request_id(self) -> int:
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
            self._submitted_total += 1
        return req_id

    def _resolve_deadline(self, req_id: int, deadline_s: Optional[float]
                          ) -> Optional[float]:
        inj = active_injector()
        if inj is not None:
            storm = inj.storm_deadline(req_id)
            if storm is not None:  # injected deadline storm
                return storm
        return (self.config.default_deadline_s if deadline_s is None
                else deadline_s)

    def _admit(self, req: Request) -> Request:
        """Register + enqueue-or-shed one constructed request."""
        with self._id_lock:
            self._pending[req.id] = req
        self._tel.counter("serve/requests")
        verdict = self._queue.submit(req)
        if verdict == ADMIT:
            self._tel.counter("serve/accepted")
            self._tel.gauge("serve/queue_depth", len(self._queue))
        elif verdict == REJECT_EXPIRED:
            self._finish(req, RequestStatus.DEADLINE_EXCEEDED,
                         detail="deadline expired before enqueue")
        else:  # capacity or draining: explicit shed
            self._finish(req, RequestStatus.REJECTED,
                         detail=f"admission rejected: {verdict}")
        return req

    # -- terminal accounting (single funnel) --------------------------------
    def _finish(self, req: Request, status: str, outputs=None,
                detail: str = "", error=None) -> None:
        if not req.finish(status, outputs=outputs, detail=detail,
                          error=error):
            with self._id_lock:
                self._double_terminal += 1
            self._tel.counter("serve/double_terminal")
            return
        with self._id_lock:
            self._pending.pop(req.id, None)
            self._status_counts[status] = \
                self._status_counts.get(status, 0) + 1
        if status == RequestStatus.OK:
            self._tel.counter("serve/completed")
            self._tel.observe("serve/latency_ms", req.latency_ms())
        elif status == RequestStatus.REJECTED:
            self._tel.counter("serve/admission_rejects")
        elif status == RequestStatus.DEADLINE_EXCEEDED:
            self._tel.counter("serve/deadline_exceeded")
        elif status == RequestStatus.DRAINED:
            self._tel.counter("serve/drained")
        elif status == RequestStatus.ERROR:
            self._tel.counter("serve/errors")

    def accounting(self) -> dict:
        """Status counts over every request ``submit`` returned, the ids
        (if any) lacking a terminal status, and the double-terminal
        count. A healthy drain shows ``unaccounted == []`` and
        ``double_terminal == 0``."""
        with self._id_lock:
            unaccounted = sorted(
                r.id for r in self._pending.values()
                if r.status not in RequestStatus.TERMINAL)
            return {"submitted": self._submitted_total,
                    "by_status": dict(self._status_counts),
                    "unaccounted": unaccounted,
                    "double_terminal": self._double_terminal}

    def debug_requests(self, limit: int = 256) -> list:
        """One row per pending request (age, phase, deadline left),
        oldest first, at most ``limit``."""
        with self._id_lock:
            reqs = sorted(self._pending.values(),
                          key=lambda r: r.submitted_at)
        now = time.monotonic()
        return [r.debug_state(now) for r in reqs
                if r.status == RequestStatus.PENDING][:int(limit)]

    # -- batch formation (scheduler-facing) ---------------------------------
    def _stack_batch(self, reqs: List[Request], bucket: int
                     ) -> List[np.ndarray]:
        """The requests' inputs stacked, padded with zero rows to
        ``bucket`` (their results are sliced off after the run)."""
        arrays = []
        n = len(reqs)
        for i in range(len(self._sample_specs)):
            arr = np.stack([r.inputs[i] for r in reqs])
            if bucket > n:
                pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad])
            arrays.append(arr)
        return arrays

    def _zero_batch(self, bucket: int) -> List[np.ndarray]:
        return [np.zeros((bucket,) + tuple(shape), dtype)
                for shape, dtype in self._sample_specs]

    # -- drain / shutdown ---------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._queue.draining

    @property
    def drain_reason(self) -> Optional[str]:
        return self._drain_reason

    def _begin_drain(self, reason: str) -> None:
        # atomic check-and-latch: only one caller arms the grace timer
        with self._drain_latch_lock:
            if self._queue.draining:
                return
            self._drain_reason = reason
            self._queue.start_drain()
        self._tel.gauge("serve/draining", 1)
        self._tel.counter("serve/drains")
        self._grace_timer = threading.Timer(self.config.drain_grace_s,
                                            self._grace_expired)
        self._grace_timer.daemon = True
        self._grace_timer.start()
        threading.Thread(target=self._watch_drain, name="ServingDrain",
                         daemon=True).start()

    def _grace_expired(self) -> None:
        for r in self._queue.pop_all():
            self._finish(r, RequestStatus.DRAINED,
                         detail="unfinished at drain-grace expiry")

    def _watch_drain(self) -> None:
        self._scheduler.join(timeout=self.config.drain_grace_s + 30.0)
        if self._grace_timer is not None:
            self._grace_timer.cancel()
        for r in self._queue.pop_all():  # scheduler died mid-drain
            self._finish(r, RequestStatus.DRAINED,
                         detail="unfinished at drain completion")
        self._tel.gauge("serve/draining", 0)
        self._tel.gauge("serve/queue_depth", 0)
        if self._on_drain is not None:
            try:
                self._on_drain()
            except Exception:
                pass  # the drain outcome outranks its hook
        self._drained.set()

    def drain(self, wait: bool = True, reason: str = "drain",
              timeout: Optional[float] = None) -> dict:
        """Stop admission, let queued work finish or deadline-out within
        the grace window, terminate the rest as DRAINED. Returns the
        accounting ledger (after completion when ``wait``)."""
        if not self._started:
            self._drained.set()
            return self.accounting()
        self._begin_drain(reason)
        if wait:
            self.wait_drained(timeout)
        return self.accounting()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Wait until the drain is over; False on ``timeout``. Waits in
        slices of ``_WAIT_SLICE_S``: Python runs a signal handler (the
        SIGTERM that starts a drain) in the main thread only between
        waits, so one long wait would sleep through a signal that arrived
        just before it began."""
        end = time.monotonic() + (self.config.drain_grace_s + 30.0
                                  if timeout is None else timeout)
        while not self._drained.wait(
                min(_WAIT_SLICE_S, max(0.0, end - time.monotonic()))):
            if time.monotonic() >= end:
                return False
        return True

    def shutdown(self) -> dict:
        """Clean teardown — same path as drain, then joins the scheduler.
        Safe to call even when ``start()`` never ran."""
        acct = self.drain(wait=True, reason="shutdown")
        if self._started:
            self._scheduler.join(timeout=5.0)
        return acct

    # -- preemption ---------------------------------------------------------
    def install_preemption(self, on_drain: Optional[Callable[[], None]] = None
                           ) -> "ServingEngine":
        """Arm SIGTERM/SIGINT handling: the scheduler loop checks the
        preemption flag and flips into drain. ``on_drain`` runs once every
        accepted request is terminal; then call ``exit_if_preempted()``
        from the main thread to take the exit-77 relaunch path."""
        from ...resilience.preemption import install_preemption_handler

        install_preemption_handler()
        self._on_drain = on_drain
        return self

    def exit_if_preempted(self, save_fn: Optional[Callable[[], None]] = None,
                          timeout: Optional[float] = None) -> bool:
        """When a preemption drained the engine (or the preemption flag is
        set: a SIGTERM that raced an already-latched drain): wait for the
        drain, then ``resilience.preemption.exit_for_relaunch`` (raises
        ``SystemExit(77)``). Returns False when there was no preemption."""
        from ...resilience.preemption import (exit_for_relaunch,
                                              preemption_requested)

        if self._drain_reason != "preempted" and not preemption_requested():
            return False
        self.wait_drained(timeout)
        exit_for_relaunch(save_fn)
        return True  # unreachable: exit_for_relaunch raises
