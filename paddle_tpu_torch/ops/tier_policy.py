"""Measured attention tier selection — counterpart of
``paddle_tpu.ops.tier_policy``.

``ops.attention`` carries interchangeable tiers whose relative speed
depends on the shape, the dtype and the device: ``xla`` (the q-chunked
causal tier, or the materialized scores where no chunking exists),
``flash_tpu`` (the flash kernels #1-#3), ``blockwise`` (the streaming
online-softmax recurrence) and ``pallas`` (forcible only: on the card it
is the same flash kernels, so it is never timed against ``flash_tpu``).
This module picks one by measurement:

- **One micro-bench per (device, heads, L, d, dtype, causal)**: the first
  dispatch of an unseen shape times every feasible tier — forward and
  backward on fresh [1, h, L, d] leaves drawn from ``RandomState(0)``, one
  untimed call (which may build the kernels), then ``_BENCH_REPS`` timed
  calls (CUDA events on the card, ``time.perf_counter`` on the CPU) — and
  the fastest (by its minimum) wins. A tier that runs out of memory, or
  a flash tier that refuses the shape, is infeasible for that key,
  logged, never fatal; any other error (a kernel that does not build or
  launch) propagates and records no verdict.
  ``counter/attn/tier_bench`` counts benches run.
- **Outside the caller's state**: the first dispatch of a shape usually
  happens inside a training step — under a checkpoint region's
  saved-tensor hooks, a selective-checkpoint dispatch mode, a cost
  tracker, autocast or ``no_grad``. All of those are thread-local, so the
  bench runs in a worker thread that is joined before the call goes on
  (the counterpart of the reference's ``jax.ensure_compile_time_eval``).
- **Persistent verdicts** in a JSON file (``PADDLE_TPU_ATTN_TIER_CACHE``,
  else ``<PADDLE_TPU_COMPILE_CACHE_DIR>/attn_tiers.json``), committed by
  ``framework.io.atomic_replace``; a process restart re-selects without
  re-measuring. A corrupt file is warned about once, re-measured in memory
  and never deleted or overwritten.
- **Override**: ``PADDLE_TPU_ATTN_POLICY`` forces a tier (``xla``,
  ``flash_tpu``, ``pallas``, ``blockwise``, ``ring``), the heuristic
  (``heuristic``) or measurement (``bench``). Unset, it is ``heuristic``
  on every device: the port's dispatch rule (the flash kernels on the
  card, the plain path on the CPU). The reference measures by default on
  the TPU because of its rig's Mosaic compile service, which has no
  counterpart here.

The decode path's two tiers (``paged_gather``, ``paged_scan``) use the
same machinery (``select_paged``, ``PADDLE_TPU_ATTN_PAGED_POLICY``), with
the heuristic as the unset default on every device.

Telemetry: ``gauge/attn/tier.<key>`` (the tier in effect for a shape,
published by every dispatch), ``counter/attn/calls``,
``counter/attn/tier_bench``. The reference's ``counter/attn/tier_fallbacks``
counts silent reroutes; the port reroutes nothing (a call the chosen tier
cannot take raises), so it stays at zero.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("paddle_tpu_torch.ops")

__all__ = [
    "TIER_IDS", "PAGED_TIERS", "policy_mode", "forced_mode", "cache_path",
    "make_key", "gauge_key", "select", "select_paged", "publish_tier",
    "registry", "TierRegistry", "reset", "bench", "paged_policy_mode",
    "make_paged_key", "bench_paged",
]

# stable numeric ids for the gauge/attn/tier.* telemetry (the reference's)
TIER_IDS = {"xla": 0, "flash_tpu": 1, "pallas": 2, "blockwise": 3, "ring": 4,
            "paged_gather": 5, "paged_scan": 6}

_FORCIBLE = ("xla", "flash_tpu", "pallas", "blockwise", "ring")

PAGED_TIERS = ("paged_gather", "paged_scan")

# the bench's batch is 1 (every tier scales ~linearly in it); heads, L, d
# and dtype come from the call
_BENCH_BATCH = 1
_BENCH_REPS = 2

_warned_unknown_policy = None  # one warning per distinct bad value


def forced_mode() -> Optional[str]:
    """The explicit ``PADDLE_TPU_ATTN_POLICY`` when it is valid, else
    None."""
    v = os.environ.get("PADDLE_TPU_ATTN_POLICY", "").strip().lower()
    if v in _FORCIBLE or v in ("bench", "heuristic"):
        return v
    return None


def _warn_unknown(var: str, value: str) -> None:
    global _warned_unknown_policy
    if value != _warned_unknown_policy:
        _warned_unknown_policy = value
        logger.warning("tier_policy: unknown %s=%r — falling back to the "
                       "heuristic (warned once per value)", var, value)


def policy_mode() -> str:
    """'bench' | 'heuristic' | a forced tier name, read at every call;
    unset (or unknown) is 'heuristic'."""
    forced = forced_mode()
    if forced is not None:
        return forced
    value = os.environ.get("PADDLE_TPU_ATTN_POLICY", "").strip()
    if value:
        _warn_unknown("PADDLE_TPU_ATTN_POLICY", value)
    return "heuristic"


def cache_path() -> Optional[str]:
    """The verdict file, or None (verdicts stay in memory)."""
    p = os.environ.get("PADDLE_TPU_ATTN_TIER_CACHE")
    if p:
        return p
    d = os.environ.get("PADDLE_TPU_COMPILE_CACHE_DIR")
    return os.path.join(d, "attn_tiers.json") if d else None


def _backend_key(device=None) -> str:
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return f"{dev.type}:{dev.type}"
    return "cuda:" + torch.cuda.get_device_name(dev).replace(" ", "_")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def make_key(h: int, L: int, d: int, dtype, causal: bool,
             device=None) -> str:
    return (f"{_backend_key(device)}:h{h}:L{L}:d{d}:{_dtype_name(dtype)}:"
            f"{'causal' if causal else 'full'}")


def gauge_key(L: int, d: int, causal: bool) -> str:
    """The per-shape suffix of ``gauge/attn/tier.<key>``."""
    return f"L{L}.d{d}.{'c' if causal else 'f'}"


def publish_tier(L: int, d: int, causal: bool, tier: str) -> None:
    """Record the tier in effect for a shape (every dispatch, any mode)."""
    from ..profiler.telemetry import get_telemetry

    get_telemetry().gauge(f"attn/tier.{gauge_key(L, d, causal)}",
                          TIER_IDS.get(tier, -1))


class TierRegistry:
    """In-memory verdicts and the persistent JSON file behind them."""

    def __init__(self):
        self._lock = threading.RLock()
        self._verdicts: Dict[str, dict] = {}
        self._loaded_path: Optional[str] = None
        self._poisoned = False  # the file is unreadable: never write it

    def _load(self, path: str) -> None:
        if self._loaded_path == path:
            return
        self._loaded_path = path
        self._poisoned = False
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(data).__name__}")
        except (OSError, ValueError) as e:
            # left exactly as found: it may be the only evidence of what
            # corrupted it
            self._poisoned = True
            logger.warning(
                "tier_policy: attention tier cache %s is unreadable (%s) — "
                "re-measuring in memory; the file is left untouched, "
                "remove it to re-enable persistence", path, e)
            return
        for k, v in data.items():
            if isinstance(v, dict) and v.get("tier") in TIER_IDS:
                self._verdicts.setdefault(k, v)

    def _persist(self, path: str) -> None:
        if self._poisoned:
            return
        from ..framework.io import atomic_replace

        persistable = {k: v for k, v in self._verdicts.items()
                       if not v.get("volatile")}
        # merge on write: verdicts another process persisted since our
        # load survive (ours win on a key both hold, except volatile ones)
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                for k, v in data.items():
                    if isinstance(v, dict) and v.get("tier") in TIER_IDS:
                        self._verdicts.setdefault(k, v)
                        persistable.setdefault(k, v)
        except (OSError, ValueError):
            pass  # absent, or corrupted since the load: _load decides
        payload = json.dumps(persistable, indent=1, sort_keys=True)

        def write(tmp):
            with open(tmp, "w") as f:
                f.write(payload)

        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            atomic_replace(path, write)
        except OSError as e:
            logger.warning("tier_policy: could not persist tier cache to "
                           "%s: %s", path, e)

    def verdict(self, key: str) -> Optional[dict]:
        with self._lock:
            path = cache_path()
            if path:
                self._load(path)
            return self._verdicts.get(key)

    def record(self, key: str, verdict: dict, persist: bool = True) -> None:
        """Store a verdict; ``persist=False`` keeps it in this process
        (marked volatile: never written, not even beside a later one)."""
        with self._lock:
            if not persist:
                verdict = dict(verdict, volatile=True)
            self._verdicts[key] = verdict
            path = cache_path()
            if path:
                self._load(path)
                if persist:
                    self._persist(path)

    def reset(self) -> None:
        with self._lock:
            self._verdicts.clear()
            self._loaded_path = None
            self._poisoned = False


_registry = TierRegistry()


def registry() -> TierRegistry:
    return _registry


def reset() -> None:
    """Forget every in-memory verdict (the file stays)."""
    _registry.reset()


# -- the micro-bench -------------------------------------------------------

def _isolated(fn: Callable):
    """``fn()`` in a fresh thread, joined before returning its result:
    grad mode, autocast, the AMP state, dispatch modes and saved-tensor
    hooks are thread-local, so none of the caller's reaches it."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised in the caller's thread
            box["err"] = e

    worker = threading.Thread(target=run, name="attn-tier-bench")
    worker.start()
    worker.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def _tier_callable(tier: str, causal: bool):
    """A [b, h, L, d] -> [b, h, L, d] callable for one tier."""
    from . import attention as att

    if tier == "xla":
        return lambda q, k, v: att.xla_attention(q, k, v, causal=causal)
    if tier == "blockwise":
        return lambda q, k, v: att.blockwise_attention(q, k, v, causal=causal)
    if tier in ("flash_tpu", "pallas"):
        return lambda q, k, v: att.flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown tier {tier!r}")


def _clock(fn: Callable, device: torch.device) -> float:
    """Seconds of the fastest of ``_BENCH_REPS`` calls, after one untimed
    call."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(_BENCH_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(_BENCH_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    # the minimum: noise only adds time, and a verdict persists
    return min(times)


def _infeasible(what: str, e: Exception, device: torch.device) -> None:
    logger.info("tier_policy: %s infeasible for this shape (%s: %s)", what,
                type(e).__name__, e)
    if device.type == "cuda":
        torch.cuda.empty_cache()


# a flash wrapper refuses a shape with one of these; its build and launch
# failures are RuntimeErrors and propagate
_SHAPE_REFUSALS = (ValueError, TypeError, NotImplementedError)


def _time_tier(tier: str, q, k, v, causal: bool) -> Optional[float]:
    """Seconds of one forward and backward of ``tier`` on leaves q, k, v,
    or None when the tier runs out of memory or (a flash tier) refuses
    the shape. Any other error — a kernel that fails to build or launch —
    propagates: it is never a verdict."""
    fn = _tier_callable(tier, causal)
    infeasible = (torch.cuda.OutOfMemoryError,) + (
        _SHAPE_REFUSALS if tier in ("flash_tpu", "pallas") else ())

    def step():
        out = fn(q, k, v)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    try:
        return _clock(step, q.device)
    except infeasible as e:
        _infeasible(f"tier {tier!r}", e, q.device)
        return None


def _record(key: str, timings: Dict[str, float], persist: bool
            ) -> Optional[dict]:
    from ..profiler.telemetry import get_telemetry

    if not timings:
        return None
    best = min(timings, key=timings.get)
    verdict = {"tier": best,
               "timings_ms": {t: round(s * 1e3, 3)
                              for t, s in timings.items()},
               "ts": time.time()}
    _registry.record(key, verdict, persist=persist)
    get_telemetry().counter("attn/tier_bench")
    logger.info("tier_policy: %s -> %s (%s)", key, best,
                ", ".join(f"{t}={ms:.2f}ms"
                          for t, ms in verdict["timings_ms"].items()))
    return verdict


def bench(key: str, h: int, L: int, d: int, dtype, causal: bool,
          candidates: List[str], persist: bool = True,
          device=None) -> Optional[dict]:
    """Time ``candidates`` at [1, h, L, d] on ``device`` (default the CPU)
    and record the winner; None when no candidate is feasible."""
    device = torch.device("cpu" if device is None else device)

    def measure():
        rng = np.random.RandomState(0)
        mk = lambda: torch.from_numpy(
            rng.randn(_BENCH_BATCH, h, L, d).astype(np.float32)).to(
                device=device, dtype=dtype).requires_grad_()
        q, k, v = mk(), mk(), mk()
        timings = {}
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            for tier in candidates:
                t = _time_tier(tier, q, k, v, causal)
                if t is not None:
                    timings[tier] = t
        return timings

    return _record(key, _isolated(measure), persist)


def select(h: int, L: int, d: int, dtype, causal: bool,
           candidates: List[str], device=None) -> Optional[str]:
    """The measured tier for this shape, benching once per key; None when
    no candidate is feasible. A cache hit is one dict lookup."""
    if not candidates:
        return None
    key = make_key(h, L, d, dtype, causal, device)
    verdict = _registry.verdict(key)
    if verdict is None:
        verdict = bench(key, h, L, d, dtype, causal, candidates,
                        device=device)
    elif verdict.get("tier") not in candidates:
        # the cached winner is not a candidate of this call: an env knob
        # shrank the set; re-measure for this process only
        verdict = bench(key, h, L, d, dtype, causal, candidates,
                        persist=False, device=device)
    if verdict is None:
        return None
    return verdict["tier"]


# -- the paged (decode) tiers ----------------------------------------------

def paged_policy_mode() -> str:
    """'bench' | 'heuristic' | a forced paged tier
    (``PADDLE_TPU_ATTN_PAGED_POLICY``); unset is 'heuristic'."""
    v = os.environ.get("PADDLE_TPU_ATTN_PAGED_POLICY", "").strip().lower()
    if v in PAGED_TIERS or v in ("bench", "heuristic"):
        return v
    if v:
        _warn_unknown("PADDLE_TPU_ATTN_PAGED_POLICY", v)
    return "heuristic"


def make_paged_key(t: int, h: int, d: int, m: int, bs: int, dtype,
                   quantized: bool, device=None) -> str:
    """Decode-shape key: query chunk length, heads, head dim, table width
    x block size, storage dtype; batch is left out (both tiers scale ~
    linearly in it)."""
    q = "int8" if quantized else _dtype_name(dtype)
    return f"{_backend_key(device)}:paged:t{t}:h{h}:d{d}:m{m}x{bs}:{q}"


def _paged_heuristic(m: int, bs: int) -> str:
    # the materialized gather while the gathered context is
    # score-tensor-small, the page-streaming scan past it
    return "paged_gather" if m * bs <= 4096 else "paged_scan"


def bench_paged(key: str, t: int, h: int, d: int, m: int, bs: int, dtype,
                quantized: bool, persist: bool = True,
                device=None) -> Optional[dict]:
    """Time both paged tiers' forward at [1, t, h, d] queries over an
    [m * bs]-token paged context (int8 pages with their scales when
    ``quantized``) and record the winner."""
    from . import attention as att
    from ..quant import quantize_kv

    device = torch.device("cpu" if device is None else device)

    def measure():
        rng = np.random.RandomState(0)
        mk = lambda *shape: torch.from_numpy(
            rng.randn(*shape).astype(np.float32)).to(device=device)
        q = mk(1, t, h, d).to(dtype)
        k_pages, v_pages = mk(m + 1, bs, h, d), mk(m + 1, bs, h, d)
        scales = (None, None)
        if quantized:
            (k_pages, ks), (v_pages, vs) = (quantize_kv(k_pages),
                                            quantize_kv(v_pages))
            scales = (ks, vs)
        else:
            k_pages, v_pages = k_pages.to(dtype), v_pages.to(dtype)
        ints = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
        args = (q, k_pages, v_pages, ints(np.arange(1, m + 1)[None, :]),
                ints(np.arange(m * bs - t, m * bs)[None, :]),
                ints(np.asarray([m * bs])), *scales)
        timings = {}
        for tier in PAGED_TIERS:
            impl = (att._paged_gather_impl if tier == "paged_gather"
                    else att._paged_scan_impl)
            try:
                with torch.no_grad():
                    timings[tier] = _clock(lambda: impl(*args), device)
            except torch.cuda.OutOfMemoryError as e:
                _infeasible(f"paged tier {tier!r}", e, device)
        return timings

    return _record(key, _isolated(measure), persist)


def select_paged(t: int, h: int, d: int, m: int, bs: int, dtype,
                 quantized: bool, device=None) -> str:
    """The paged tier for this decode shape: forced > cached verdict >
    a fresh micro-bench (bench mode) > the heuristic."""
    mode = paged_policy_mode()
    if mode in PAGED_TIERS:
        return mode
    if mode == "bench":
        key = make_paged_key(t, h, d, m, bs, dtype, quantized, device)
        verdict = _registry.verdict(key)
        if verdict is None or verdict.get("tier") not in PAGED_TIERS:
            verdict = bench_paged(key, t, h, d, m, bs, dtype, quantized,
                                  device=device)
        if verdict is not None:
            return verdict["tier"]
    return _paged_heuristic(m, bs)
