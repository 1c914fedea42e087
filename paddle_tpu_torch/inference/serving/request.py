"""Request model for the serving runtime — counterpart of
``paddle_tpu.inference.serving.request``: every request ends terminal.

Every submitted request reaches EXACTLY ONE terminal status, whatever the
load, the deadlines or a drain do. ``Request.finish`` is the single
transition point: the first terminal status wins, a second attempt
returns False (the engine counts it as ``serve/double_terminal``,
expected to stay 0). Request-scoped traces come with the profiler's
ops-server port.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RequestStatus", "Request"]


class RequestStatus:
    """Terminal statuses (plus PENDING, the only non-terminal state).

    - ``OK``: executed, result delivered within its deadline.
    - ``REJECTED``: shed at admission — queue at capacity or the server
      draining.
    - ``DEADLINE_EXCEEDED``: accepted but its deadline passed.
    - ``DRAINED``: accepted, still unfinished when the drain grace
      expired.
    - ``ERROR``: execution failed.
    """

    PENDING = "pending"
    OK = "ok"
    REJECTED = "rejected"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    DRAINED = "drained"
    ERROR = "error"

    TERMINAL = frozenset({OK, REJECTED, DEADLINE_EXCEEDED, DRAINED, ERROR})


class Request:
    """One request: per-sample inputs plus an optional deadline
    (``submitted_at`` and the absolute ``deadline`` are monotonic
    seconds)."""

    def __init__(self, req_id: int, inputs: Sequence[np.ndarray],
                 deadline_s: Optional[float] = None):
        self.id = int(req_id)
        self.inputs: Tuple[np.ndarray, ...] = tuple(
            np.asarray(a) for a in inputs)
        self.submitted_at = time.monotonic()
        self.deadline = (None if deadline_s is None
                         else self.submitted_at + float(deadline_s))
        self.status = RequestStatus.PENDING
        self.detail = ""
        self.outputs: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.finished_at: Optional[float] = None
        self._done = threading.Event()
        self._lock = threading.Lock()

    def finish(self, status: str, outputs=None, detail: str = "",
               error: Optional[BaseException] = None) -> bool:
        """Transition to a terminal status. Returns True iff THIS call
        performed the transition."""
        if status not in RequestStatus.TERMINAL:
            raise ValueError(f"{status!r} is not a terminal status")
        with self._lock:
            if self.status != RequestStatus.PENDING:
                return False
            self.status = status
            self.outputs = outputs
            self.detail = detail
            self.error = error
            self.finished_at = time.monotonic()
        self._done.set()
        return True

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until terminal. Returns False on timeout."""
        return self._done.wait(timeout)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def latency_ms(self) -> float:
        """Submit→terminal wall time (→now while still pending)."""
        end = self.finished_at if self.finished_at is not None \
            else time.monotonic()
        return (end - self.submitted_at) * 1e3

    def phase(self) -> str:
        """``inflight`` while pending (queued or in a running batch: the
        engine does not track which), else the terminal status."""
        return "inflight" if self.status == RequestStatus.PENDING \
            else self.status

    def debug_state(self, now: Optional[float] = None) -> dict:
        """One row of ``ServingEngine.debug_requests``: the request's age,
        its deadline left and what it is doing."""
        now = time.monotonic() if now is None else now
        return {"id": self.id, "status": self.status, "phase": self.phase(),
                "age_ms": (now - self.submitted_at) * 1e3,
                "deadline_remaining_ms": (
                    None if self.deadline is None
                    else (self.deadline - now) * 1e3)}

    def __repr__(self):
        return (f"Request(id={self.id}, status={self.status!r}"
                f"{', ' + self.detail if self.detail else ''})")
