"""Goodput ledger — counterpart of ``paddle_tpu.profiler.goodput``, the
whole module: every wall-clock second since process start lands in
exactly ONE category of a closed vocabulary:

    startup             process start until the first productive step
    productive_step     inside a train-step call
    compile             trace and compile of an unseen signature
    input_wait          the consumer blocked on the prefetch queue
    checkpoint_save     checkpoint write / emergency spill
    checkpoint_restore  checkpoint read / resume
    rollback_recovery   quarantine + snapshot rollback + replay
    eval                inside an evaluation call
    drain_shutdown      preemption / serving drain until exit
    restart_downtime    dead job gap between attempts (launcher-booked)
    unattributed        the honest remainder — nothing claimed it

The instrumentation points each wrap their timed region in
:func:`activity`, which claims the span for its category. Claims nest:
an inner claim suspends the outer one, so overlapping activities never
double-book. The ledger is a small state machine on the *owning thread*
(the first thread to claim an activity; claims from other threads are
no-ops, so a background prefetch thread overlapping a device step books
nothing). ``snapshot()`` computes ``unattributed = wall − Σ claimed``, so
the categories sum to the measured wall by construction.

In the port, ``io.prefetch.DevicePrefetcher`` claims ``input_wait`` and
``framework.io.save``/``load`` claim ``checkpoint_save`` and
``checkpoint_restore``. Everything here is host-side: two
``perf_counter`` reads and a dict add per transition, no device sync.
Disable with ``PADDLE_TPU_GOODPUT=0``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = [
    "CATEGORIES", "GoodputLedger", "ledger", "activity", "shutdown_begin",
    "publish", "jsonl_payload", "snapshot", "reset",
]

# The closed vocabulary. ``unattributed`` is computed, never claimed by
# instrumentation — claiming it would defeat its honesty.
CATEGORIES = (
    "startup",
    "productive_step",
    "compile",
    "input_wait",
    "checkpoint_save",
    "checkpoint_restore",
    "rollback_recovery",
    "eval",
    "drain_shutdown",
    "restart_downtime",
    "unattributed",
)


def _env_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_GOODPUT", "1").strip().lower() not in (
        "0", "false", "off")


class _Activity:
    """Context manager for one claimed span (see ``activity``). Cheap:
    allocation + two lock/clock pairs; safe to enter per batch."""

    __slots__ = ("_led", "_cat", "_live")

    def __init__(self, led: "GoodputLedger", cat: str):
        self._led = led
        self._cat = cat
        self._live = False

    def __enter__(self):
        led = self._led
        if led._enabled:
            with led._lock:
                if led._claims_here():
                    led._book_to_top(time.perf_counter())
                    if (self._cat == "productive_step"
                            and led._stack[0] == "startup"):
                        # training has begun: from here on, unclaimed
                        # time is honestly unaccounted, not "startup"
                        led._stack[0] = "unattributed"
                    led._stack.append(self._cat)
                    self._live = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._live:
            led = self._led
            with led._lock:
                led._book_to_top(time.perf_counter())
                if len(led._stack) > 1:
                    led._stack.pop()
        return False


class GoodputLedger:
    """Process-wide wall-clock ledger (one per process; see module doc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.started_at = time.time()
        self._mark = self._t0
        self._totals: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._stack = ["startup"]
        self._owner: Optional[int] = None
        self._enabled = _env_enabled()
        try:
            self.attempt = int(
                os.environ.get("PADDLE_TPU_LAUNCH_ATTEMPT", "0") or 0)
        except ValueError:
            self.attempt = 0

    # -- internals (lock held) ---------------------------------------------
    def _book_to_top(self, now: float) -> None:
        dt = now - self._mark
        if dt > 0:
            self._totals[self._stack[-1]] += dt
        self._mark = now

    def _claims_here(self) -> bool:
        # the first claiming thread becomes the owner; a background
        # stage thread overlapping the step loop must not double-book
        ident = threading.get_ident()
        if self._owner is None:
            self._owner = ident
        return self._owner == ident

    # -- claiming API -------------------------------------------------------
    def activity(self, category: str) -> _Activity:
        if category not in CATEGORIES or category == "unattributed":
            raise ValueError(f"unknown goodput category: {category!r}")
        return _Activity(self, category)

    def shutdown_begin(self) -> None:
        """Flip the base state to ``drain_shutdown`` (preemption exit,
        serving drain). Thread-agnostic — the latch may be flipped from a
        scheduler thread; open claims keep booking to themselves and the
        base change takes effect when they pop."""
        if not self._enabled:
            return
        with self._lock:
            if self._stack[0] == "drain_shutdown":
                return
            if len(self._stack) == 1:
                # the base IS the running span: close it first so the
                # pre-drain seconds stay with the old state
                self._book_to_top(time.perf_counter())
            self._stack[0] = "drain_shutdown"

    def reattribute(self, category: str, seconds: float,
                    source: Optional[str] = None) -> float:
        """Move up to ``seconds`` of already-booked wall time from
        ``source`` (default: the base state) into ``category`` — the
        launcher uses this to backdate restart downtime to the
        heartbeat-dated death, which precedes its own detection of it.
        Conservation-preserving by construction (a transfer, not an
        addition). Returns the seconds actually moved."""
        if category not in CATEGORIES or not self._enabled:
            return 0.0
        with self._lock:
            self._book_to_top(time.perf_counter())
            src = source or self._stack[0]
            take = min(max(0.0, float(seconds)), self._totals.get(src, 0.0))
            if take > 0:
                self._totals[src] -= take
                self._totals[category] += take
            return take

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Current totals including the pending span; ``unattributed`` is
        recomputed as the wall residual so categories sum to ``wall_s``
        exactly (the conservation contract)."""
        with self._lock:
            now = time.perf_counter()
            self._book_to_top(now)
            wall = now - self._t0
            cats = dict(self._totals)
            current = self._stack[-1]
        claimed = sum(v for c, v in cats.items() if c != "unattributed")
        cats["unattributed"] = max(0.0, wall - claimed)
        frac = min(1.0, cats["productive_step"] / wall) if wall > 0 else 0.0
        return {
            "wall_s": wall,
            "fraction": frac,
            "attempt": self.attempt,
            "current": current,
            "categories": cats,
        }


# -- module-level singleton ------------------------------------------------
# Created at import so the startup clock starts as early as the first
# import of the profiler; ``reset()`` swaps in a fresh ledger (a benchmark
# resets it per configuration, which then gets its own wall denominator).
_LEDGER = GoodputLedger()


def ledger() -> GoodputLedger:
    return _LEDGER


def activity(category: str) -> _Activity:
    """Claim the enclosed span for ``category`` on the owning thread.
    Nested claims suspend the outer one (no double-booking); claims from
    other threads are no-ops."""
    return _LEDGER.activity(category)


def shutdown_begin() -> None:
    _LEDGER.shutdown_begin()


def snapshot() -> dict:
    return _LEDGER.snapshot()


def reset() -> None:
    global _LEDGER
    _LEDGER = GoodputLedger()


def publish(tel=None) -> Optional[dict]:
    """Refresh ``gauge/goodput/*`` from the live ledger (called by
    ``Telemetry.to_jsonl``). Returns the snapshot."""
    if not _LEDGER._enabled:
        return None
    snap = _LEDGER.snapshot()
    if tel is None:
        from .telemetry import get_telemetry

        tel = get_telemetry()
    tel.gauge("goodput/wall_s", round(snap["wall_s"], 3))
    tel.gauge("goodput/fraction", round(snap["fraction"], 4))
    for cat, s in snap["categories"].items():
        # always publish the headline pair; others only once nonzero
        # (a closed vocabulary, not a mandatory one — a process that
        # never checkpointed should not advertise checkpoint_save=0)
        if s > 0 or cat in ("productive_step", "unattributed"):
            tel.gauge(f"goodput/{cat}_s", round(s, 3))
    return snap


def jsonl_payload() -> Optional[dict]:
    """Structured ``rec["goodput"]`` table for ``Telemetry.to_jsonl``
    (``rec["profile"]`` precedent): rounded snapshot keyed for the
    aggregator's cross-restart stitching."""
    if not _LEDGER._enabled:
        return None
    snap = _LEDGER.snapshot()
    return {
        "wall_s": round(snap["wall_s"], 3),
        "fraction": round(snap["fraction"], 4),
        "attempt": snap["attempt"],
        "current": snap["current"],
        "categories": {c: round(s, 3)
                       for c, s in snap["categories"].items()
                       if round(s, 3) > 0},
    }
