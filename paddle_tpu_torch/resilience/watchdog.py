"""Watchdog — a heartbeat deadline over train-step boundaries;
counterpart of ``paddle_tpu.resilience.watchdog``, the whole module.

A hung collective, a stuck host-to-device copy, or a deadlocked input
pipeline does not crash a job — it parks it forever, burning the
reservation while monitoring shows a healthy process. Watching
*processes* cannot see a process that is alive but stuck. The Watchdog
watches *step progress*:
engines feed it a heartbeat at every step boundary, and when no beat
arrives within the deadline it dumps every Python thread's stack plus a
telemetry snapshot (the post-mortem a hang otherwise never yields) and
aborts with ``EXIT_WATCHDOG`` — distinct from both a crash and
``EXIT_PREEMPTED``, so the launch watcher and schedulers can tell
"hung and self-killed" from "preempted, relaunch me".

``heartbeat()`` is called from hot loops (engine/executor step
boundaries): it is a read of one module global plus a float store when a
watchdog is armed, and a no-op read when not.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["EXIT_WATCHDOG", "Watchdog", "install_watchdog",
           "uninstall_watchdog", "heartbeat", "current_watchdog",
           "last_beat_age_s"]

# Distinct exit code for "step deadline exceeded, self-aborted with a
# stack dump" (see module docstring; EXIT_PREEMPTED = 77 is the
# relaunch-me code).
EXIT_WATCHDOG = 113


def dump_stacks(extra: str = "") -> str:
    """All Python thread stacks + a telemetry snapshot, as one report."""
    lines = [f"== watchdog dump pid={os.getpid()} ts={time.time():.3f} =="]
    if extra:
        lines.append(extra)
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        lines.append(f"-- thread {names.get(tid, '?')} ({tid}) --")
        lines.append("".join(traceback.format_stack(frame)))
    try:
        from ..profiler.telemetry import get_telemetry

        import json

        lines.append("-- telemetry --")
        lines.append(json.dumps(get_telemetry().scalars(), sort_keys=True))
    except Exception:
        pass  # a dump must never fail because telemetry did
    try:
        from ..profiler.spans import flight_recorder

        # the event history BEFORE the hang: which fit/epoch/step was
        # open, whether the process died in h2d, compute, a callback, or
        # a checkpoint — the question a bare thread-stack dump can't
        # answer ("B" with no matching "E" = still open at dump time)
        lines.append("-- flight recorder (last span events, newest last) --")
        lines.append(flight_recorder().format_tail())
    except Exception:
        pass  # ditto: the dump outranks its decorations
    return "\n".join(lines)


class Watchdog:
    """Deadline monitor over step-boundary heartbeats.

    Args:
        deadline_s: max seconds between heartbeats before firing. Size it
            to cover the SLOWEST legitimate gap — including the first
            step's kernel build (engines beat at step entry, so a long
            compile counts against the deadline).
        dump_dir: where to write ``watchdog-<pid>.txt``; None → stderr
            only.
        abort: fire → ``os._exit(exit_code)`` after the dump. ``False``
            runs ``on_timeout(report)`` instead and disarms (for tests
            and embedders that own process teardown). ``os._exit`` — not
            sys.exit — because the main thread is by definition stuck;
            SystemExit raised on this watcher thread would kill only the
            watcher.
        on_timeout: callback receiving the dump text when ``abort=False``.
    """

    def __init__(self, deadline_s: float, dump_dir: Optional[str] = None,
                 abort: bool = True, exit_code: int = EXIT_WATCHDOG,
                 on_timeout: Optional[Callable[[str], None]] = None,
                 poll_s: Optional[float] = None):
        self.deadline_s = float(deadline_s)
        self.dump_dir = dump_dir
        self.abort = abort
        self.exit_code = int(exit_code)
        self.on_timeout = on_timeout
        self._poll_s = poll_s if poll_s is not None else max(
            min(self.deadline_s / 4.0, 1.0), 0.01)
        self._last = time.monotonic()
        self.last_step: Optional[int] = None
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._run, name="Watchdog",
                                        daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    @property
    def fired(self) -> bool:
        return self._fired

    # -- heartbeat ---------------------------------------------------------
    def beat(self, step: Optional[int] = None) -> None:
        self._last = time.monotonic()
        if step is not None:
            self.last_step = step

    # -- watcher loop ------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if time.monotonic() - self._last <= self.deadline_s:
                continue
            self._fired = True
            from ..profiler.telemetry import get_telemetry

            # counter FIRST so the dump's own telemetry snapshot (and a
            # JSONL sink) can still observe it before an abort discards
            # this process's in-memory state
            get_telemetry().counter("resilience/watchdog_dumps")
            report = dump_stacks(
                extra=f"no heartbeat for > {self.deadline_s:.3f}s "
                      f"(last step: {self.last_step})")
            self._write_report(report)
            sink = os.environ.get("PADDLE_TPU_TELEMETRY_JSONL")
            if sink:
                try:
                    get_telemetry().to_jsonl(sink, tag="watchdog")
                except Exception:
                    pass  # the abort must not be blocked by a bad sink
            if self.abort:
                sys.stderr.write(report + "\n")
                sys.stderr.flush()
                os._exit(self.exit_code)
            if self.on_timeout is not None:
                try:
                    self.on_timeout(report)
                except Exception:
                    pass
            return  # non-abort mode disarms after one dump

    def _write_report(self, report: str) -> None:
        if not self.dump_dir:
            return
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir, f"watchdog-{os.getpid()}.txt")
            with open(path, "w") as f:
                f.write(report)
        except OSError:
            pass  # the dump still reaches stderr in abort mode


_active: Optional[Watchdog] = None

# -- cross-process heartbeat file -------------------------------------------
# The launch supervisor watches a per-rank heartbeat FILE
# (PADDLE_TPU_HEARTBEAT_FILE, exported by distributed.launch) so it can
# tell a hung rank from a slow one without any in-process cooperation
# beyond the beats the engines already emit. Touches are rate-limited:
# the supervisor's staleness threshold is seconds, so sub-second mtime
# resolution buys nothing and a touch-per-step would put filesystem
# metadata traffic on the hot path.
_HB_ENV = "PADDLE_TPU_HEARTBEAT_FILE"
_HB_MIN_INTERVAL_S = 0.5
_UNSET = object()
_hb_path = _UNSET
_hb_last = 0.0


def _touch_heartbeat_file() -> None:
    global _hb_path, _hb_last
    if _hb_path is _UNSET:  # resolve the env contract once
        _hb_path = os.environ.get(_HB_ENV) or None
    if _hb_path is None:
        return
    now = time.monotonic()
    if now - _hb_last < _HB_MIN_INTERVAL_S:
        return
    _hb_last = now
    try:
        with open(_hb_path, "a"):
            pass
        os.utime(_hb_path, None)
    except OSError:
        pass  # a beat must never crash the step that emitted it


def _reset_heartbeat_file_cache() -> None:
    """Re-read PADDLE_TPU_HEARTBEAT_FILE on the next beat (tests)."""
    global _hb_path, _hb_last
    _hb_path = _UNSET
    _hb_last = 0.0


def install_watchdog(deadline_s: float, **kwargs) -> Watchdog:
    """Create, start, and register the process-wide watchdog the engines'
    step boundaries feed. Replaces any previous one."""
    global _active
    if _active is not None:
        _active.stop()
    _active = Watchdog(deadline_s, **kwargs).start()
    return _active


def uninstall_watchdog() -> None:
    global _active
    if _active is not None:
        _active.stop()
        _active = None


def current_watchdog() -> Optional[Watchdog]:
    return _active


# monotonic stamp of the last heartbeat() call, armed watchdog or not —
# the ops plane's /healthz judges liveness from it even on processes
# that never installed an in-process watchdog (serving schedulers beat
# every loop iteration)
_last_beat: Optional[float] = None


def last_beat_age_s() -> Optional[float]:
    """Seconds since the last ``heartbeat()`` in this process, or None
    when no beat has ever been emitted (a process with no step/serve
    loop has no liveness signal to judge)."""
    last = _last_beat
    return None if last is None else time.monotonic() - last


def heartbeat(step: Optional[int] = None) -> None:
    """Step-boundary beat — the one call sites use. Feeds the in-process
    watchdog (when armed) AND the per-rank heartbeat file the launch
    supervisor watches (when PADDLE_TPU_HEARTBEAT_FILE is exported).
    Near-no-op (three global reads/stores) when neither is configured."""
    global _last_beat
    _last_beat = time.monotonic()
    w = _active
    if w is not None:
        w.beat(step)
    _touch_heartbeat_file()
