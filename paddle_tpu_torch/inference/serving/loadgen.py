"""Closed-loop generation load — counterpart of the generation half of
``paddle_tpu.inference.serving.loadgen``.

``run_generation_streams`` runs N client threads, each submit → wait for
the full generation → submit, against a ``TokenServingEngine``;
``summarize_generation`` builds the status counts and the TTFT/TPOT
percentiles from the request objects' own stamps, independent of
telemetry. The one-shot ``run_load``/``run_streams`` come with the
predictor engine.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["run_generation_streams", "summarize_generation"]


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
