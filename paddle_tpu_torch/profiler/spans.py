"""Structured hierarchical spans and the crash flight recorder —
counterpart of ``paddle_tpu.profiler.spans``, the whole module: it is
plain Python on the host's clock and has nothing of the device in it.

- **Spans**: scoped, nested, step-correlated. A span records its parent
  (the innermost open span on the same thread), a process-unique
  ``span_id``, and the training ``step`` it belongs to (inherited from
  the nearest enclosing span that set one). The hierarchy ``Model.fit``
  opens is ``fit → epoch → step → {callback, checkpoint}``;
  ``framework.io`` opens ``checkpoint``.
- **Window store**: completed spans recorded inside a profiling window,
  exported as nested chrome trace events (``chrome_events``). Bounded
  (``PADDLE_TPU_SPAN_WINDOW`` spans, FIFO) and drained by each export.
- **Flight recorder**: an always-on bounded ring of span enter/exit
  events (``PADDLE_TPU_FLIGHT_EVENTS``, default 512), two deque appends
  per span, whose tail says what the process was doing when it hung or
  failed.
- **Request traces**: ``ReqTrace`` and ``TraceStore``, one timeline per
  sampled serving request (``PADDLE_TPU_TRACE_SAMPLE``).

Names, categories, nesting and the chrome event layout are the
reference's, so one tool reads either package's traces.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = [
    "Span", "span", "mark", "current_span", "in_category", "FlightRecorder", "flight_recorder",
    "SpanStore", "window_store", "open_window", "close_window",
    "window_active", "chrome_events", "drain_window",
    "ReqTrace", "TraceStore", "trace_store", "trace_sample_rate",
    "should_trace", "trace_chrome_events",
    "rank_pid", "rank_process_metadata",
]


def rank_pid() -> int:
    """The ``pid`` every chrome export of this process stamps its events
    with: the global trainer RANK under a multi-process launch, else the
    OS pid. Per-rank exports used to all emit ``os.getpid()`` with no
    rank identity, so naively concatenated traces overlaid ranks on one
    track (and pids can genuinely collide across hosts); a rank-scoped
    pid makes every per-rank artifact merge-safe by construction
    (``profiler.cluster_trace`` and anyone hand-merging)."""
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    except ValueError:
        world = 1
    if world > 1:
        for var in ("PADDLE_TRAINER_ID", "PROCESS_ID"):
            raw = os.environ.get(var)
            if raw:
                try:
                    return int(raw)
                except ValueError:
                    pass
    return os.getpid()


def rank_process_metadata(pid: Optional[int] = None) -> List[dict]:
    """The chrome metadata events naming this process's track: a
    ``process_name`` of ``rank <r>`` (or ``pid <p>`` standalone) plus a
    ``process_sort_index`` so merged traces list ranks in order."""
    p = rank_pid() if pid is None else int(pid)
    label = f"rank {p}" if p != os.getpid() else f"pid {p}"
    return [
        {"name": "process_name", "ph": "M", "pid": p,
         "args": {"name": label}},
        {"name": "process_sort_index", "ph": "M", "pid": p,
         "args": {"sort_index": p}},
    ]

_ids = itertools.count(1)  # process-unique span ids (GIL-atomic next())
_tls = threading.local()   # per-thread stack of open spans


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional["Span"]:
    """Innermost open span on this thread (None outside any span)."""
    st = _stack()
    return st[-1] if st else None


def in_category(cat: str) -> bool:
    """True when any open span on this thread has category ``cat`` —
    engines use this to avoid double-opening a "step" span when a
    higher-level loop (hapi fit) already holds one."""
    return any(s.cat == cat for s in _stack())


class SpanStore:
    """Bounded FIFO of completed-span records for the profiling window.

    Each record is ``(name, cat, ts_us, dur_us, tid, span_id, parent_id,
    step)``. Bounded: when the window overflows, the OLDEST spans fall
    out — an export of a too-long window shows the most recent activity,
    and memory stays flat either way."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity or _env_int("PADDLE_TPU_SPAN_WINDOW", 65536)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=cap)
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._spans)

    def add(self, rec) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(rec)

    def drain(self) -> List[tuple]:
        """Return all records and clear — each export owns its window."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            self.dropped = 0
        return out

    def snapshot(self) -> List[tuple]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


class FlightRecorder:
    """Always-on bounded ring of span ENTER/EXIT events.

    Events are ``(phase, name, cat, ts_us, dur_us, tid, span_id,
    parent_id, step)`` with phase ``"B"``/``"E"``. Keeping both phases
    (not just completed spans) is the point: at crash time the tail
    shows which spans were OPEN — ``step#842 B, h2d B, h2d E, compute
    B`` and nothing after means the hang is inside the compiled step,
    not the input pipeline."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity or _env_int("PADDLE_TPU_FLIGHT_EVENTS", 512)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=cap)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, phase, name, cat, ts_us, dur_us, tid, span_id,
               parent_id, step) -> None:
        with self._lock:
            self._ring.append((phase, name, cat, ts_us, dur_us, tid,
                               span_id, parent_id, step))

    def tail(self, n: Optional[int] = None) -> List[tuple]:
        with self._lock:
            events = list(self._ring)
        return events if n is None else events[-n:]

    def dump(self, n: Optional[int] = None) -> List[dict]:
        keys = ("phase", "name", "cat", "ts_us", "dur_us", "tid",
                "span_id", "parent_id", "step")
        return [dict(zip(keys, ev)) for ev in self.tail(n)]

    def format_tail(self, n: Optional[int] = None) -> str:
        """Human-readable tail for crash reports, newest last."""
        events = self.tail(n)
        if not events:
            return "(flight recorder empty)"
        t_end = events[-1][3]
        lines = []
        for phase, name, cat, ts, dur, tid, sid, pid, step in events:
            dt = (ts - t_end) / 1e6
            stepinfo = f" step={step}" if step is not None else ""
            durinfo = f" {dur / 1e3:.3f}ms" if phase == "E" else ""
            lines.append(f"[{dt:+9.3f}s] {phase} {name} ({cat})"
                         f"{stepinfo} span={sid}"
                         + (f" parent={pid}" if pid else "") + durinfo)
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_window = SpanStore()
_flight = FlightRecorder()
_window_active = False


def window_store() -> SpanStore:
    return _window


def flight_recorder() -> FlightRecorder:
    return _flight


def window_active() -> bool:
    return _window_active


def open_window(clear: bool = True) -> None:
    """Start recording completed spans into the window store. With
    ``clear`` (the default for a FRESH window) previous leftovers are
    dropped; re-opening while a window is live must pass ``clear=False``
    so the outer window's spans survive."""
    global _window_active
    if clear:
        _window.clear()
    _window_active = True


def close_window() -> None:
    """Stop window recording. Does NOT drain: the spans stay available
    for an export after the window closed (exports drain)."""
    global _window_active
    _window_active = False


def drain_window() -> List[tuple]:
    return _window.drain()


class Span:
    """Scoped span. Context manager; re-entrant use is a fresh span.

    ``step`` is inherited from the nearest enclosing span that set one,
    so instrumented leaf operations (h2d, compute, checkpoint) are
    step-correlated without every call site threading the step through.
    """

    __slots__ = ("name", "cat", "step", "span_id", "parent_id", "tid",
                 "ts_us", "dur_us", "_t0")

    def __init__(self, name: str, cat: str = "host",
                 step: Optional[int] = None):
        self.name = name
        self.cat = cat
        self.step = step
        self.span_id = None
        self.parent_id = None
        self.tid = None
        self.ts_us = None
        self.dur_us = None

    def __enter__(self) -> "Span":
        st = _stack()
        parent = st[-1] if st else None
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        if self.step is None and parent is not None:
            self.step = parent.step
        self.tid = threading.get_ident()
        st.append(self)
        self._t0 = time.perf_counter()
        self.ts_us = self._t0 * 1e6
        _flight.record("B", self.name, self.cat, self.ts_us, 0.0, self.tid,
                       self.span_id, self.parent_id, self.step)
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.dur_us = (t1 - self._t0) * 1e6
        st = _stack()
        # tolerate a torn stack (an enclosing span leaked by an exception
        # path that bypassed __exit__): unwind to self so one bad scope
        # cannot corrupt parentage for the rest of the process
        while st and st[-1] is not self:
            st.pop()
        if st:
            st.pop()
        _flight.record("E", self.name, self.cat, t1 * 1e6, self.dur_us,
                       self.tid, self.span_id, self.parent_id, self.step)
        if _window_active:
            _window.add((self.name, self.cat, self.ts_us, self.dur_us,
                         self.tid, self.span_id, self.parent_id, self.step))
        return False


def span(name: str, cat: str = "host", step: Optional[int] = None) -> Span:
    """``with span("h2d", cat="h2d"): ...`` — the one-liner call sites use."""
    return Span(name, cat=cat, step=step)


def mark(name: str, cat: str = "host", step: Optional[int] = None) -> None:
    """Zero-duration marker span (``Profiler.step()`` boundaries)."""
    with Span(name, cat=cat, step=step):
        pass


# -- request-scoped tracing ---------------------------------------------------
# A sampled serving request carries ONE trace across its whole lifecycle
# (submit → admit → queue → prefill chunks → decode steps → terminal), so
# "p99 is slow" decomposes into queue wait vs prefill interleave vs decode
# stalls for a real request instead of being argued from aggregate
# histograms. Sampling is deterministic on the request id
# (PADDLE_TPU_TRACE_SAMPLE: a fraction; 1 traces everything, 0.01 traces
# every 100th id) so a replayed load plan samples the same requests.


class ReqTrace:
    """The timeline of one sampled request. Events are appended by the
    submit path, the admission funnel, and the scheduler thread; each is
    ``(name, t0_seconds_perf_counter, dur_seconds)``. Appends are plain
    list appends (GIL-atomic) — the trace is written by at most one
    thread per lifecycle stage and only read after the terminal
    transition publishes it to the store."""

    __slots__ = ("trace_id", "req_id", "events")

    def __init__(self, req_id: int, trace_id: Optional[str] = None):
        self.req_id = int(req_id)
        self.trace_id = trace_id or f"{os.getpid()}-{req_id}"
        self.events: list = []

    def event(self, name: str, dur_s: float = 0.0) -> None:
        """Record an event that ENDED now and lasted ``dur_s`` (0 for an
        instant mark) — call sites measure a duration then stamp it."""
        now = time.perf_counter()
        self.events.append((str(name), now - float(dur_s), float(dur_s)))

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "req_id": self.req_id,
            "events": [{"name": n, "ts_us": t0 * 1e6, "dur_us": d * 1e6}
                       for n, t0, d in self.events],
        }

    def chrome_events(self, pid: Optional[int] = None) -> List[dict]:
        """One self-contained catapult timeline: every event is a complete
        ("X") slice on a per-request track, all carrying the trace id."""
        pid = pid if pid is not None else os.getpid()
        return [{"name": n, "ph": "X", "ts": t0 * 1e6, "dur": d * 1e6,
                 "pid": pid, "tid": f"req {self.trace_id}", "cat": "request",
                 "args": {"trace_id": self.trace_id, "req_id": self.req_id}}
                for n, t0, d in self.events]


class TraceStore:
    """Bounded FIFO of COMPLETED request traces (terminal transition
    publishes them). Snapshots feed ``/debug/requests``; chrome exports
    drain (each export owns its window, like the span store)."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity or _env_int("PADDLE_TPU_TRACE_STORE", 256)
        self._lock = threading.Lock()
        self._traces: deque = deque(maxlen=cap)

    def __len__(self) -> int:
        return len(self._traces)

    def add(self, trace: ReqTrace) -> None:
        with self._lock:
            self._traces.append(trace)

    def snapshot(self, n: Optional[int] = None) -> List[ReqTrace]:
        with self._lock:
            out = list(self._traces)
        if n is None:
            return out
        # n <= 0 means "none": out[-0:] would slice the WHOLE store,
        # answering a request for the minimum with the maximum payload
        return out[-n:] if n > 0 else []

    def drain(self) -> List[ReqTrace]:
        with self._lock:
            out = list(self._traces)
            self._traces.clear()
        return out

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_traces = TraceStore()


def trace_store() -> TraceStore:
    return _traces


def trace_sample_rate() -> float:
    """PADDLE_TPU_TRACE_SAMPLE as a fraction in [0, 1] (0 = tracing off,
    the default; malformed values read as 0 — observability must never
    take the serving path down)."""
    raw = os.environ.get("PADDLE_TPU_TRACE_SAMPLE", "")
    if not raw:
        return 0.0
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def should_trace(req_id: int, rate: Optional[float] = None) -> bool:
    """Deterministic id-keyed sampling: rate 1 → every request, rate r →
    every round(1/r)-th id. Id-keyed (not random) so a replayed load plan
    samples the same requests and gates can assert on a specific one."""
    r = trace_sample_rate() if rate is None else rate
    if r <= 0.0:
        return False
    if r >= 1.0:
        return True
    return int(req_id) % max(1, int(round(1.0 / r))) == 0


def trace_chrome_events(pid: Optional[int] = None,
                        drain: bool = True) -> List[dict]:
    """Catapult events of every stored request trace (chrome-export hook)."""
    traces = _traces.drain() if drain else _traces.snapshot()
    events: List[dict] = []
    for t in traces:
        events.extend(t.chrome_events(pid=pid))
    return events


def chrome_events(records=None, pid: Optional[int] = None) -> List[dict]:
    """Convert window span records to chrome://tracing complete events.

    Nesting falls out of ts/dur scoping per tid; ``args`` carries the
    structured identity (span_id/parent_id/step) so downstream tools can
    rebuild the tree without re-deriving containment."""
    if records is None:
        records = drain_window()
    pid = pid if pid is not None else os.getpid()
    events = []
    for name, cat, ts, dur, tid, sid, par, step in records:
        args = {"span_id": sid, "parent_id": par}
        if step is not None:
            args["step"] = step
        events.append({"name": name, "ph": "X", "ts": ts, "dur": dur,
                       "pid": pid, "tid": tid, "cat": cat, "args": args})
    return events
