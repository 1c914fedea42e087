"""Continuous-batching scheduler — counterpart of
``paddle_tpu.inference.serving.scheduler``: the device loop of the
one-shot ``ServingEngine``.

One thread owns the device: it pulls whatever is queued (up to
``max_batch``), packs it into the smallest batch-size bucket that fits
and runs the predictor's ``serving_fn`` on that bucket's shape. Padding
rows are zeros; their results are sliced off before delivery. The
reference compiles one executable per bucket; the port's step runs
eagerly, and the buckets bound the shapes the kernels and the caching
allocator see.

Per batch iteration:
- ``resilience.watchdog.heartbeat()`` — a hung step trips the watchdog;
- the preemption flag — SIGTERM flips the engine into drain;
- deadlines at completion — a batch that finished past a request's
  deadline discards that request's output (``DEADLINE_EXCEEDED``);
- fault injection (``resilience.inject``): ``slow_req@id:secs`` stalls
  the batch holding that request, ``drop_req@id`` loses its result
  (the request ends ``ERROR``), ``sigterm@n`` delivers a real SIGTERM at
  batch boundary ``n``.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List

import numpy as np

from .. import _to_numpy
from ...profiler.telemetry import get_telemetry
from ...resilience.inject import active_injector
from ...resilience.preemption import preemption_requested
from ...resilience.watchdog import heartbeat
from .request import Request, RequestStatus

__all__ = ["BatchScheduler"]


class BatchScheduler:
    """The engine's batch loop; one instance, one daemon thread."""

    def __init__(self, engine):
        self._engine = engine
        self._thread = threading.Thread(
            target=self._run, name="ServingScheduler", daemon=True)
        self.batch_index = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread.start()
        return self

    def join(self, timeout=None):
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _step(self, arrays) -> List[np.ndarray]:
        outs = self._engine._serving_fn(*arrays)
        outs = outs if isinstance(outs, (list, tuple)) else (outs,)
        return [_to_numpy(o) for o in outs]  # the copy syncs the device

    def warmup(self) -> Dict[int, float]:
        """Run every bucket's shape once on a zero batch before the first
        request. Returns ``{bucket: wall_ms}``."""
        out: Dict[int, float] = {}
        for b in self._engine.config.buckets:
            t0 = time.perf_counter()
            self._step(self._engine._zero_batch(b))
            out[b] = (time.perf_counter() - t0) * 1e3
        return out

    # -- the loop ----------------------------------------------------------
    def _run(self):
        eng = self._engine
        tel = get_telemetry()
        ready: List[Request] = []
        try:
            while True:
                ready = []
                heartbeat()  # a hung step below trips the watchdog
                if preemption_requested() and not eng.draining:
                    eng._begin_drain(reason="preempted")
                ready, expired = eng._queue.take(
                    eng.config.max_batch, timeout=eng.config.idle_poll_s)
                for r in expired:
                    eng._finish(r, RequestStatus.DEADLINE_EXCEEDED,
                                detail="deadline expired in queue")
                tel.gauge("serve/queue_depth", len(eng._queue))
                if not ready:
                    if eng.draining and len(eng._queue) == 0:
                        return  # drained dry; the engine finalizes
                    continue
                self._run_batch(ready)
                self.batch_index += 1
                inj = active_injector()
                if inj is not None:
                    inj.maybe_sigterm(self.batch_index)
        except BaseException:
            # a crash must not strand accepted requests: latch drain first
            # (later submits are shed REJECTED), then fail the batch in
            # hand and everything still queued
            tb = traceback.format_exc()
            eng._begin_drain(reason="scheduler crashed")
            for r in ready + eng._queue.pop_all():
                if not r.done():
                    eng._finish(r, RequestStatus.ERROR,
                                detail=f"scheduler crashed:\n{tb}")
            raise

    def _run_batch(self, reqs: List[Request]):
        eng = self._engine
        tel = get_telemetry()
        inj = active_injector()
        if inj is not None:
            for r in reqs:  # injected straggler: stall the whole batch
                inj.slow_req(r.id)
        n = len(reqs)
        bucket = eng.config.bucket_for(n)
        t0 = time.perf_counter()
        try:
            outs = self._step(eng._stack_batch(reqs, bucket))
        except BaseException as e:
            detail = f"batch execution failed: {e!r}"
            for r in reqs:
                eng._finish(r, RequestStatus.ERROR, detail=detail, error=e)
            return
        batch_ms = (time.perf_counter() - t0) * 1e3
        tel.counter("serve/batches")
        tel.observe("serve/batch_ms", batch_ms)
        tel.observe(f"serve/batch_ms.b{bucket}", batch_ms)
        tel.observe("serve/batch_occupancy", n / bucket)
        now = time.monotonic()
        for k, r in enumerate(reqs):
            if inj is not None and inj.drop_req_due(r.id):
                eng._finish(r, RequestStatus.ERROR,
                            detail="result dropped (injected)")
                continue
            if r.deadline is not None and now >= r.deadline:
                # the slot is burned, but a stale result is never
                # delivered as success
                eng._finish(r, RequestStatus.DEADLINE_EXCEEDED,
                            detail="completed past deadline")
                continue
            eng._finish(r, RequestStatus.OK, outputs=[o[k] for o in outs])
