"""Deterministic load generators — counterpart of
``paddle_tpu.inference.serving.loadgen``: offered load as an experiment
knob.

- ``run_load`` paces submissions open-loop at a fixed offered rate (what
  independent clients do: arrivals do not slow down when the server
  struggles, which is what makes overload);
- ``run_streams`` runs N closed-loop streams (submit → wait → submit)
  against the one-shot ``ServingEngine``;
- ``run_generation_streams`` does the same against a
  ``TokenServingEngine``, each request waiting for its full generation.

Each returns a summary built from the request objects themselves
(status counts and latency percentiles of the OK requests, or TTFT/TPOT
for generation), independent of telemetry.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .request import Request, RequestStatus

__all__ = ["run_load", "run_streams", "summarize", "run_generation_streams",
           "summarize_generation"]


def summarize(requests: Sequence[Request]) -> Dict:
    """Status counts and the OK requests' latency percentiles (each
    request stamps its own terminal time)."""
    by_status: Dict[str, int] = {}
    ok_lat: List[float] = []
    for r in requests:
        by_status[r.status] = by_status.get(r.status, 0) + 1
        if r.status == RequestStatus.OK:
            ok_lat.append(r.latency_ms())
    out = {"submitted": len(requests), "by_status": by_status}
    out.update(_percentiles(ok_lat))
    return out


def _percentiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {}
    arr = np.sort(np.asarray(values, dtype=np.float64))

    def pct(q):
        idx = min(len(arr) - 1, max(0, int(round(q * (len(arr) - 1)))))
        return float(arr[idx])

    return {"p50_ms": pct(0.50), "p90_ms": pct(0.90), "p99_ms": pct(0.99),
            "max_ms": float(arr[-1])}


def summarize_generation(requests: Sequence) -> Dict:
    """Status counts, generated-token totals, and TTFT (submit → first
    token) and TPOT (steady-state inter-token time) as p50/p90/p99."""
    by_status: Dict[str, int] = {}
    ttft: List[float] = []
    tpot: List[float] = []
    n_tokens = 0
    for r in requests:
        by_status[r.status] = by_status.get(r.status, 0) + 1
        n_tokens += len(r.generated)
        t = r.ttft_ms()
        if t is not None:
            ttft.append(t)
        t = r.tpot_ms()
        if t is not None:
            tpot.append(t)
    out = {"submitted": len(requests), "by_status": by_status,
           "tokens_generated": n_tokens}
    out.update({f"ttft_{k}": v for k, v in _percentiles(ttft).items()})
    out.update({f"tpot_{k}": v for k, v in _percentiles(tpot).items()})
    return out


def run_generation_streams(engine, n_streams: int,
                           requests_per_stream: int,
                           prompt_fn: Callable[[int], Sequence[int]],
                           max_new_tokens: Optional[int] = None,
                           deadline_s: Optional[float] = None) -> Dict:
    """Closed-loop generation load at concurrency ``n_streams``. The
    headline is ``tokens_per_s`` (generated tokens / wall), plus the
    percentiles of ``summarize_generation``; ``requests`` holds every
    request in submission order per stream."""
    all_reqs: List[List] = [[] for _ in range(n_streams)]

    def stream(s: int):
        for k in range(requests_per_stream):
            req = engine.submit(prompt_fn(s * requests_per_stream + k),
                                max_new_tokens=max_new_tokens,
                                deadline_s=deadline_s)
            all_reqs[s].append(req)
            req.wait()

    threads = [threading.Thread(target=stream, args=(s,), daemon=True)
               for s in range(n_streams)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    reqs = [r for rs in all_reqs for r in rs]
    out = summarize_generation(reqs)
    out["streams"] = n_streams
    out["wall_s"] = wall
    out["tokens_per_s"] = out["tokens_generated"] / max(wall, 1e-9)
    out["requests"] = reqs
    return out


def run_load(engine, n_requests: int, rate_per_s: float,
             input_fn: Callable[[int], Sequence[np.ndarray]],
             deadline_s: Optional[float] = None,
             wait_timeout_s: float = 60.0, return_requests: bool = False):
    """Open loop: submit ``n_requests`` paced at ``rate_per_s`` (request
    k at ``t0 + k / rate``, so a slow submit does not lower the offered
    rate), then wait for every request to end. A drain mid-run is part
    of the outcome: later submissions come back REJECTED. With
    ``return_requests``: ``(summary, requests)``."""
    interval = 1.0 / float(rate_per_s)
    t0 = time.monotonic()
    reqs: List[Request] = []
    for k in range(int(n_requests)):
        delay = t0 + k * interval - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        reqs.append(engine.submit(input_fn(k), deadline_s=deadline_s))
    deadline = time.monotonic() + wait_timeout_s
    for r in reqs:
        r.wait(max(0.0, deadline - time.monotonic()))
    out = summarize(reqs)
    out["offered_rate_per_s"] = float(rate_per_s)
    out["wall_s"] = time.monotonic() - t0
    return (out, reqs) if return_requests else out


def run_streams(engine, n_streams: int, requests_per_stream: int,
                input_fn: Callable[[int], Sequence[np.ndarray]],
                deadline_s: Optional[float] = None) -> Dict:
    """Closed loop: ``n_streams`` threads each run submit → wait →
    submit, so the concurrency is ``n_streams``; ``ok_per_s`` is the OK
    requests over the wall time."""
    all_reqs: List[List[Request]] = [[] for _ in range(n_streams)]

    def stream(s: int):
        for k in range(requests_per_stream):
            req = engine.submit(input_fn(s * requests_per_stream + k),
                                deadline_s=deadline_s)
            all_reqs[s].append(req)
            req.wait()

    threads = [threading.Thread(target=stream, args=(s,), daemon=True)
               for s in range(n_streams)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    out = summarize([r for rs in all_reqs for r in rs])
    out["streams"] = n_streams
    out["wall_s"] = wall
    out["ok_per_s"] = out["by_status"].get(RequestStatus.OK, 0) \
        / max(wall, 1e-9)
    return out
