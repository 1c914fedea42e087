"""Telemetry core — counterpart of ``paddle_tpu.profiler.telemetry``,
kept to the surface the port uses: counters, gauges and streaming
histograms, read back through ``scalars()``, timers (``timer``), the JSONL
sink (``to_jsonl``, one record a call, with the goodput ledger's table)
and ``sample_device_memory``. Counters also add into ``core.monitor``'s
registry, as the reference's do.

Scalar names are namespaced as in the reference: ``counter/<name>``,
``gauge/<name>`` and ``hist/<name>/{count,sum,min,max,mean,ema,p50,p95,
p99}``. The schema gate and the cost-attribution publishers are not
ported.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..core import monitor

__all__ = ["Histogram", "Telemetry", "get_telemetry",
           "sample_device_memory"]

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


class _Timer:
    """Context manager feeding a histogram in milliseconds; a block that
    raises records nothing (its partial time is no sample)."""

    def __init__(self, telemetry: "Telemetry", name: str):
        self._tel = telemetry
        self._name = name
        self.elapsed_ms = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if exc_type is None:
            self._tel.observe(self._name, self.elapsed_ms)
        return False


def _coerce_scalar(v) -> Optional[float]:
    """A finite float of ``v``, or None."""
    try:
        f = float(np.asarray(v).ravel()[0])
    except (TypeError, ValueError, IndexError):
        return None
    return f if math.isfinite(f) else None


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
        monitor.stat_add(name, int(value))

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, value) -> None:
        """Set a gauge. A tensor is kept as it is and read when the gauges
        are (``snapshot``), so a device scalar costs no sync here."""
        if isinstance(value, torch.Tensor):
            value = value.detach()
        else:
            value = float(value)
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value) -> None:
        self.histogram(name).observe(value)

    def timer(self, name: str) -> _Timer:
        """``with tel.timer("checkpoint/write_ms"): ...``"""
        return _Timer(self, name)

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
        for k, v in gauges.items():
            if isinstance(v, torch.Tensor):
                f = _coerce_scalar(v.double().cpu())
                gauges[k] = f if f is not None else float("nan")
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

    def to_jsonl(self, path: str, step: Optional[int] = None,
                 tag: str = "telemetry", extra: Optional[dict] = None
                 ) -> str:
        """Append one record ``{"ts", "step", "tag", "scalars"}`` to
        ``path`` (the reference's layout): the flat scalars, ``extra``'s
        finite numbers on top, and the goodput ledger's table under
        ``"goodput"``."""
        from . import goodput

        goodput.publish(self)
        goodput_payload = goodput.jsonl_payload()
        scalars = self.scalars()
        for k, v in (extra or {}).items():
            f = _coerce_scalar(v)
            if f is not None:
                scalars[str(k)] = f
        rec = {"ts": time.time(),
               "step": int(step) if step is not None else None,
               "tag": str(tag), "scalars": scalars}
        if goodput_payload:
            rec["goodput"] = goodput_payload
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return path

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


def sample_device_memory(telemetry: Optional[Telemetry] = None) -> dict:
    """Device-memory gauges: ``device/bytes_in_use.d<i>`` and
    ``device/peak_bytes_in_use.d<i>`` for every CUDA device this process
    sees (``torch.cuda.memory_allocated`` and ``max_memory_allocated``,
    the caching allocator's counts), and their sums under the unsuffixed
    names. Returns the gauges; a no-op (``{}``) without CUDA."""
    tel = telemetry or get_telemetry()
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    totals = {"bytes_in_use": 0.0, "peak_bytes_in_use": 0.0}
    for i in range(torch.cuda.device_count()):
        for key, fn in (("bytes_in_use", torch.cuda.memory_allocated),
                        ("peak_bytes_in_use",
                         torch.cuda.max_memory_allocated)):
            v = float(fn(i))
            out[f"device/{key}.d{i}"] = v
            totals[key] += v
    out.update({f"device/{k}": v for k, v in totals.items()})
    for k, v in out.items():
        tel.gauge(k, v)
    return out
