"""Bounded admission queue with explicit load shedding — counterpart of
``paddle_tpu.inference.serving.admission``.

The queue is the only buffer between clients and the device: crossing
its capacity is an explicit ``REJECTED`` at submit time, never an
unbounded backlog. Deadlines are enforced at enqueue and at take.
Many submitter threads, one scheduler thread calling ``take``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import List, Tuple

from .request import Request

__all__ = ["AdmissionQueue", "ADMIT", "REJECT_CAPACITY", "REJECT_DRAINING",
           "REJECT_EXPIRED"]

ADMIT = "admit"
REJECT_CAPACITY = "capacity"    # queue full: shed with REJECTED
REJECT_DRAINING = "draining"    # drain started: admission stopped
REJECT_EXPIRED = "expired"      # deadline already passed at enqueue


class AdmissionQueue:
    """FIFO with a hard bound, drain latch, and deadline-aware take."""

    def __init__(self, capacity: int):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._dq: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._draining = False

    def submit(self, req: Request) -> str:
        """Admit or shed ``req``; returns one of the verdict constants.
        Never blocks."""
        now = time.monotonic()
        with self._cond:
            if self._draining:
                return REJECT_DRAINING
            if req.expired(now):
                return REJECT_EXPIRED
            if len(self._dq) >= self.capacity:
                return REJECT_CAPACITY
            self._dq.append(req)
            self._cond.notify()
            return ADMIT

    def take(self, max_n: int, timeout: float
             ) -> Tuple[List[Request], List[Request]]:
        """Up to ``max_n`` admitted requests, split from those whose
        deadline expired while queued: ``(ready, expired)``."""
        with self._cond:
            if not self._dq:
                self._cond.wait(timeout)
            now = time.monotonic()
            ready: List[Request] = []
            expired: List[Request] = []
            while self._dq and len(ready) < max_n:
                req = self._dq.popleft()
                (expired if req.expired(now) else ready).append(req)
            return ready, expired

    def start_drain(self) -> None:
        """Latch: stop admitting. Queued work stays queued."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining

    def pop_all(self) -> List[Request]:
        with self._cond:
            out = list(self._dq)
            self._dq.clear()
            return out

    def __len__(self) -> int:
        with self._cond:
            return len(self._dq)
