"""Preemption handling — SIGTERM/SIGINT → flag → emergency checkpoint →
designated exit code; counterpart of ``paddle_tpu.resilience.preemption``,
the whole module.

A preemptible machine gets SIGTERM and a grace window. The handler turns
the signal into a cooperative flag that training loops check at step
boundaries (``hapi.Model.fit`` does), save an emergency checkpoint, and
exit with ``EXIT_PREEMPTED`` so that a launcher relaunches the job
instead of failing it.

Signal handlers only set a flag: no I/O, no locks and no device calls
happen in signal context (Python runs handlers on the main thread between
bytecodes; real work there can deadlock against runtime threads holding
the same locks).
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Callable, Optional

__all__ = ["EXIT_PREEMPTED", "PreemptionHandler",
           "install_preemption_handler", "uninstall_preemption_handler",
           "preemption_requested", "exit_for_relaunch"]

# Exit code a launcher recognizes as "relaunch me":
# the job checkpointed cleanly and wants to resume, as opposed to a crash
# (fail-fast) or a clean finish (0). Distinct from EXIT_WATCHDOG.
EXIT_PREEMPTED = 77


class PreemptionHandler:
    """Owns the SIGTERM/SIGINT → flag wiring for one process."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._previous = {}
        self._installed = False
        self.received_signum: Optional[int] = None

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self

        def _on_signal(signum, frame):
            self.received_signum = signum
            self._flag.set()

        for s in self._signals:
            self._previous[s] = signal.signal(s, _on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        self._installed = False

    def requested(self) -> bool:
        return self._flag.is_set()

    def clear(self) -> None:
        self._flag.clear()
        self.received_signum = None


_handler: Optional[PreemptionHandler] = None


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)
                               ) -> PreemptionHandler:
    """Install (or return) the process-wide handler. Idempotent."""
    global _handler
    if _handler is None:
        _handler = PreemptionHandler(signals).install()
    return _handler


def uninstall_preemption_handler() -> None:
    global _handler
    if _handler is not None:
        _handler.uninstall()
        _handler = None


def preemption_requested() -> bool:
    """Step-boundary check: has a SIGTERM/SIGINT arrived? False when no
    handler is installed (loops may call this unconditionally)."""
    h = _handler
    return h is not None and h.requested()


def clear_preemption_request() -> None:
    """Drop a pending request WITHOUT exiting. For in-process resume
    (tests, notebooks): a real relaunch is a fresh process whose flag
    starts clear, so production code never needs this."""
    h = _handler
    if h is not None:
        h.clear()


def exit_for_relaunch(save_fn: Optional[Callable[[], None]] = None) -> None:
    """Run the emergency-checkpoint callback (if any) and exit with
    ``EXIT_PREEMPTED``. Raises SystemExit — ``finally`` blocks run, so
    in-flight telemetry sinks and log handles flush."""
    from ..profiler.telemetry import get_telemetry

    # counter BEFORE the callback: save_fn is the only flush hook (it
    # typically ends with a telemetry JSONL append), so an increment
    # after it could never reach any sink before the exit
    get_telemetry().counter("resilience/preempt_exits")
    if save_fn is not None:
        save_fn()
    sys.exit(EXIT_PREEMPTED)
