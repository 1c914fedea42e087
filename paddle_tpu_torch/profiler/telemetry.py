"""Telemetry core — counterpart of ``paddle_tpu.profiler.telemetry``,
kept to the surface the serving runtime uses: counters, gauges and
streaming histograms, read back through ``scalars()``.

Scalar names are namespaced as in the reference: ``counter/<name>``,
``gauge/<name>`` and ``hist/<name>/{count,sum,min,max,mean,ema,p50,p95,
p99}``. The JSONL sink, the schema gate and the attribution publishers
arrive with the profiler port.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

__all__ = ["Histogram", "Telemetry", "get_telemetry"]

_HIST_WINDOW = 1024  # sliding-window size backing the percentile estimates
_EMA_ALPHA = 0.1


class Histogram:
    """Streaming scalar distribution: running aggregates + EMA + windowed
    percentiles. Thread-safe; ``observe`` is O(1)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=_HIST_WINDOW)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.ema = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(v, self.min)
            self.max = max(v, self.max)
            self.ema = v if self.ema is None else (
                _EMA_ALPHA * v + (1.0 - _EMA_ALPHA) * self.ema)
            self._window.append(v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0}
            count, total, lo, hi, ema = (self.count, self.sum, self.min,
                                         self.max, self.ema)
            win = np.asarray(self._window)
        p50, p95, p99 = np.percentile(win, [50, 95, 99])
        return {"count": count, "sum": total, "min": lo, "max": hi,
                "mean": total / count, "ema": ema,
                "p50": float(p50), "p95": float(p95), "p99": float(p99)}


class Telemetry:
    """Process-wide metric hub. All mutators are cheap and thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(value)

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value) -> None:
        self.histogram(name).observe(value)

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def hist_summary(self, name: str) -> Optional[Dict[str, float]]:
        """Summary of an existing histogram, or None (never creates one)."""
        with self._lock:
            h = self._hists.get(name)
        return h.summary() if h is not None else None

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {"counters": counters, "gauges": gauges,
                "histograms": {k: h.summary() for k, h in hists.items()}}

    def scalars(self) -> Dict[str, float]:
        """Flat ``{namespaced_name: number}`` view."""
        snap = self.snapshot()
        out: Dict[str, float] = {}
        for k, v in snap["counters"].items():
            out[f"counter/{k}"] = int(v)
        for k, v in snap["gauges"].items():
            if math.isfinite(v):
                out[f"gauge/{k}"] = v
        for k, s in snap["histograms"].items():
            for field, v in s.items():
                if v is not None and math.isfinite(float(v)):
                    out[f"hist/{k}/{field}"] = float(v)
        return out

    def reset(self) -> None:
        """Drop every counter, gauge and histogram."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_telemetry: Optional[Telemetry] = None
_telemetry_lock = threading.Lock()


def get_telemetry() -> Telemetry:
    global _telemetry
    if _telemetry is None:
        with _telemetry_lock:
            if _telemetry is None:
                _telemetry = Telemetry()
    return _telemetry
