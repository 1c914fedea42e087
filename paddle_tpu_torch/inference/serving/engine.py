"""ServingEngine — counterpart of ``paddle_tpu.inference.serving.engine``,
kept to the request-lifecycle core the token engine
(``decode.TokenServingEngine``) builds on: submit → admit-or-shed, the
single terminal funnel ``_finish`` with its accounting ledger, drain and
shutdown.

Past capacity the server says no (``REJECTED`` at submit) instead of
buffering; expired work is shed at every stage; a drain stops admission,
lets queued work finish within a grace window and terminates the rest as
``DRAINED``. Every submitted request reaches exactly one terminal status
— ``accounting()`` proves it.

The one-shot predictor engine (``BatchScheduler``), the ops server,
request tracing, the compile cache and the preemption exit come with
later slices; here ``ServingEngine`` is the base whose subclass supplies
the scheduler (``_make_scheduler``) and ``submit``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from ...profiler.telemetry import get_telemetry
from .admission import ADMIT, REJECT_EXPIRED, AdmissionQueue
from .request import Request, RequestStatus

__all__ = ["ServeConfig", "ServingEngine"]


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
    """Request-lifecycle core shared by the engine variants. Subclasses
    set ``self.config``, implement ``_make_scheduler`` (an object with
    ``warmup()``, ``start()`` and ``join(timeout)``) and ``submit``, and
    call ``_init_runtime()``."""

    def _make_scheduler(self):
        raise NotImplementedError

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
        self._grace_timer: Optional[threading.Timer] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Start the scheduler thread after running every step shape
        once (kernel build, allocator, library handles), so the first
        request pays none of that."""
        if self._started:
            return self
        self._tel.gauge("serve/queue_capacity", self.config.capacity)
        self._tel.gauge("serve/draining", 0)
        self.warmup_ms = self._scheduler.warmup()
        self._started = True
        self._scheduler.start()
        return self

    # -- admission funnel --------------------------------------------------
    def _allocate_request_id(self) -> int:
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
            self._submitted_total += 1
        return req_id

    def _resolve_deadline(self, deadline_s: Optional[float]
                          ) -> Optional[float]:
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
        return self._drained.wait(
            self.config.drain_grace_s + 30.0 if timeout is None else timeout)

    def shutdown(self) -> dict:
        """Clean teardown — same path as drain, then joins the scheduler.
        Safe to call even when ``start()`` never ran."""
        acct = self.drain(wait=True, reason="shutdown")
        if self._started:
            self._scheduler.join(timeout=5.0)
        return acct
