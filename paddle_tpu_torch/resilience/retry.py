"""Deterministic exponential backoff for transient-failure I/O —
counterpart of ``paddle_tpu.resilience.retry``, the whole module.

One helper owns the retry policy, so checkpoint I/O and the prefetcher's
host-to-device staging cannot drift apart. Backoff is deterministic (no
jitter): every schedule is exactly reproducible from ``(base, factor,
max_delay)``, so a test can assert a recovery timeline.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple, Type

__all__ = ["backoff_delays", "retry_call"]


def backoff_delays(retries: int, base: float = 0.25, factor: float = 2.0,
                   max_delay: float = 30.0) -> List[float]:
    """The full deterministic delay schedule: ``retries`` sleeps of
    ``base * factor**i`` seconds, each capped at ``max_delay``."""
    return [min(float(base) * float(factor) ** i, float(max_delay))
            for i in range(max(0, int(retries)))]


def retry_call(fn: Callable, *args,
               retries: int = 3, base: float = 0.25, factor: float = 2.0,
               max_delay: float = 30.0,
               retry_on: Sequence[Type[BaseException]] = (OSError,),
               should_retry: Optional[Callable[[BaseException], bool]] = None,
               counter: Optional[str] = "resilience/io_retries",
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on an exception matching ``retry_on``
    (and ``should_retry(exc)`` when given), sleep the next deterministic
    backoff delay and try again, up to ``retries`` extra attempts.

    Each retry bumps the ``counter`` telemetry counter (pass ``None`` to
    disable) and invokes ``on_retry(attempt, exc)``. The final failure
    re-raises the last exception unchanged.
    """
    delays = backoff_delays(retries, base=base, factor=factor,
                            max_delay=max_delay)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except tuple(retry_on) as e:
            if attempt >= len(delays) or (should_retry is not None
                                          and not should_retry(e)):
                raise
            if counter:
                from ..profiler.telemetry import get_telemetry

                get_telemetry().counter(counter)
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delays[attempt])
            attempt += 1
