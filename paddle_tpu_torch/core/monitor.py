"""Named runtime counters — a copy of ``paddle_tpu.core.monitor``.

Paddle's ``StatRegistry`` (``STAT_ADD`` / ``STAT_RESET``): process-level
int64 counters of host-side events (steps run, bytes fed, checkpoint
writes) with an add / get / reset surface. ``profiler.telemetry``'s
counters add into it as well. Thread-safe.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["StatRegistry", "stat_add", "stat_get", "stat_reset",
           "stat_sub", "all_stats"]


class StatRegistry:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, int] = {}

    @classmethod
    def instance(cls) -> "StatRegistry":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def add(self, name: str, value: int = 1) -> int:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + int(value)
            return self._stats[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._stats.get(name, 0)

    def reset(self, name: str) -> None:
        with self._lock:
            self._stats[name] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)


def stat_add(name: str, value: int = 1) -> int:
    """Add ``value`` to ``name`` (``STAT_ADD``); returns the new count."""
    return StatRegistry.instance().add(name, value)


def stat_sub(name: str, value: int = 1) -> int:
    return StatRegistry.instance().add(name, -value)


def stat_get(name: str) -> int:
    return StatRegistry.instance().get(name)


def stat_reset(name: str) -> None:
    StatRegistry.instance().reset(name)


def all_stats() -> Dict[str, int]:
    return StatRegistry.instance().snapshot()
