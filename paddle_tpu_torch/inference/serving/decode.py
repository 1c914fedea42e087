"""Token-level LLM serving — counterpart of
``paddle_tpu.inference.serving.decode``: decode-step continuous batching
over a paged KV cache with chunked-prefill admission.

- Every scheduler iteration advances ALL running sequences by one decode
  step (packed into the smallest decode bucket) and runs at most ONE
  prefill chunk, so a newly admitted long prompt costs running decodes at
  most one chunk of latency.
- Paged KV cache (``kv_cache.KVCachePool``): blocks allocate as sequences
  grow and free at EVERY terminal transition (the engine's ``_finish``
  funnel owns the release). Pool pressure evicts the youngest running
  sequence back to re-prefill (``serve/kv_evictions``).
- The step is ``gpt_decode_fns(...)`` plus an argmax on the device: only
  the [B, T] int32 greedy tokens come back to the host.
- Speculative decoding (``spec_k > 0`` and a ``draft_model``): the draft
  proposes ``spec_k`` greedy tokens (k cheap steps over its own pool),
  the target verifies the pending token and all k proposals in ONE
  (k+1)-token step; the longest agreeing prefix plus the target's own
  next token advance the sequence 1..k+1 tokens a round, and the output
  is the target's greedy text. A sequence within k tokens of
  ``max_seq_len`` finishes on the plain decode path.
- int8 KV pages (``kv_dtype='int8'``): K/V quantize on write, one scale
  per token-head (``kv_cache``).
- Lifecycle (admission, deadlines, drain, SIGTERM → drain → exit 77, the
  exactly-one-terminal ledger) is ``engine.ServingEngine``'s; each round
  calls the watchdog's heartbeat, checks the preemption flag and runs
  the injector's ``slow_req`` and ``sigterm@n`` faults.

Telemetry: counters ``serve/kv_blocks_{alloc,free}``,
``serve/decode_steps``, ``serve/prefill_chunks``, ``serve/kv_evictions``,
``serve/tokens_generated``, ``serve/spec_{proposed,accepted}``; gauges
``serve/kv_occupancy``, ``serve/kv_blocks_{total,used}``,
``serve/running``, ``serve/queue_depth``, ``serve/spec_accept_rate``;
histograms ``serve/ttft_ms``, ``serve/tpot_ms``,
``serve/decode_ms[.b<N>]``, ``serve/prefill_ms[.c<N>]``,
``serve/verify_ms[.b<N>]``, ``serve/draft_ms[.b<N>]``,
``serve/draft_prefill_ms.c<N>``, ``serve/batch_occupancy``.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...core.place import resolve_device
from ...jit.functionalize import get_params
from ...profiler.telemetry import get_telemetry
from ...resilience.inject import active_injector
from ...resilience.preemption import preemption_requested
from ...resilience.watchdog import heartbeat
from ...text.models.gpt import gpt_decode_fns
from .engine import ServeConfig, ServingEngine
from .kv_cache import KVCacheConfig, KVCachePool
from .request import Request, RequestStatus

__all__ = ["TokenServeConfig", "GenRequest", "TokenServingEngine",
           "DecodeScheduler", "dense_greedy_reference"]


class TokenServeConfig(ServeConfig):
    """Knobs of the token-level runtime. ``decode_buckets`` are the
    inherited ``buckets`` and ``max_running`` the inherited ``max_batch``.

    Args:
        decode_buckets: ascending batch sizes for the decode step.
            ``max_running`` (default: largest bucket) bounds concurrent
            sequences.
        prefill_chunk: tokens per prefill chunk — the admission quantum.
        max_new_tokens: default generation budget per request.
        kv_blocks / kv_block_size / kv_dtype: pool geometry + storage
            ('float32' | 'bfloat16' | 'int8'; int8 stores per-token-head
            scales via ``quant.quantize_kv``). The draft model's pool
            has the same geometry.
        max_seq_len: per-sequence cap (prompt + generation); defaults to
            the model's position table.
        spec_k: speculative tokens proposed a round (0 = off; needs a
            draft model on the engine).
    """

    def __init__(self, capacity: int = 64,
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 max_running: Optional[int] = None,
                 prefill_chunk: int = 32,
                 max_new_tokens: int = 64,
                 default_deadline_s: Optional[float] = None,
                 drain_grace_s: float = 5.0,
                 idle_poll_s: float = 0.01,
                 kv_blocks: int = 64,
                 kv_block_size: int = 16,
                 kv_dtype: str = "float32",
                 max_seq_len: Optional[int] = None,
                 spec_k: int = 0):
        super().__init__(capacity=capacity, buckets=decode_buckets,
                         max_batch=max_running,
                         default_deadline_s=default_deadline_s,
                         drain_grace_s=drain_grace_s,
                         idle_poll_s=idle_poll_s)
        self.prefill_chunk = int(prefill_chunk)
        self.max_new_tokens = int(max_new_tokens)
        self.kv_blocks = int(kv_blocks)
        self.kv_block_size = int(kv_block_size)
        self.kv_dtype = kv_dtype
        self.max_seq_len = max_seq_len
        self.spec_k = int(spec_k)

    @property
    def decode_buckets(self):
        return self.buckets

    @property
    def max_running(self) -> int:
        return self.max_batch


class GenRequest(Request):
    """One generation request; the generation state lives on the request
    so the scheduler, the terminal funnel and the ledger see one object.
    ``first_token_at`` (TTFT) and ``last_token_at`` stamp token times."""

    def __init__(self, req_id: int, prompt: np.ndarray,
                 max_new_tokens: int, deadline_s: Optional[float] = None,
                 eos_id: Optional[int] = None):
        super().__init__(req_id, [prompt], deadline_s)
        self.max_new = int(max_new_tokens)
        self.eos_id = eos_id
        self.toks: List[int] = [int(t) for t in prompt]
        self.n_prompt = len(self.toks)
        self.generated: List[int] = []
        self.ncache = 0          # tokens whose K/V are in the cache
        self.draft_ncache = 0    # ditto, the draft's cache (speculative)
        self.evictions = 0
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None

    @property
    def pending(self) -> int:
        """Known tokens not yet in cache — 1 means decode-eligible, >1
        means (re)prefilling."""
        return len(self.toks) - self.ncache

    def ttft_ms(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1e3

    def tpot_ms(self) -> Optional[float]:
        if (self.first_token_at is None or self.last_token_at is None
                or len(self.generated) < 2):
            return None
        return ((self.last_token_at - self.first_token_at)
                / (len(self.generated) - 1)) * 1e3

    def phase(self) -> str:
        """queued (nothing cached yet), prefill (known tokens still
        entering the cache) or decode; the status once terminal."""
        if self.status != RequestStatus.PENDING:
            return self.status
        if self.ncache == 0 and not self.generated:
            return "queued"
        return "prefill" if self.pending > 1 else "decode"

    def debug_state(self, now=None) -> dict:
        out = super().debug_state(now)
        out.update({"prompt_tokens": self.n_prompt,
                    "tokens_generated": len(self.generated),
                    "max_new_tokens": self.max_new,
                    "kv_cached_tokens": self.ncache,
                    "evictions": self.evictions,
                    "ttft_ms": self.ttft_ms()})
        return out


class DecodeScheduler:
    """The decode loop — one thread owns the device and the pools.

    Each iteration: heartbeat → drain/preemption check → admission (pop
    waiting prompts into the running set while slots exist) → deadline
    shedding → ONE prefill chunk for the oldest prefilling sequence →
    ONE decode (or speculative) round for every decode-eligible sequence
    → retire finished sequences.
    """

    def __init__(self, engine: "TokenServingEngine"):
        self._engine = engine
        self._thread = threading.Thread(
            target=self._run, name="DecodeScheduler", daemon=True)
        self.batch_index = 0
        self._running: List[GenRequest] = []
        self._spec_proposed = 0
        self._spec_accepted = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread.start()
        return self

    def join(self, timeout=None):
        self._thread.join(timeout)

    # -- the step ----------------------------------------------------------
    def _step(self, tokens, qpos, tables, kv_lens, draft: bool = False
              ) -> np.ndarray:
        """Forward a chunk through the target's (or the draft's) cache;
        return the greedy token per position. Argmax stays on the device:
        the copy back is [B, T] int32, not [B, T, V] logits."""
        eng = self._engine
        fwd, params, pool = ((eng._draft_fwd, eng._draft_params,
                              eng._draft_pool) if draft else
                             (eng._fwd, eng._params, eng._pool))
        with torch.no_grad():
            logits, _ = fwd(params, tokens, qpos, pool.pages, tables,
                            kv_lens)
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    def _to_device(self, *arrays: np.ndarray):
        dev = self._engine.device
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def warmup(self) -> Dict[str, float]:
        """Run every step shape once with a zero batch (all writes land
        on the scratch page, all attention is masked) before the first
        request: the kernels build and the allocator settles here."""
        eng = self._engine
        cfg = eng.config
        out: Dict[str, float] = {}

        def run(label, B, T, draft=False):
            z = np.zeros((B, T), np.int32)
            arrays = self._to_device(
                z, z, np.zeros((B, eng._table_width), np.int32),
                np.zeros((B,), np.int32))
            t0 = time.perf_counter()
            self._step(*arrays, draft=draft)
            out[label] = (time.perf_counter() - t0) * 1e3

        for b in cfg.decode_buckets:
            run(f"decode.b{b}", b, 1)
        run(f"prefill.c{cfg.prefill_chunk}", 1, cfg.prefill_chunk)
        if eng.spec_enabled:
            for b in cfg.decode_buckets:
                run(f"verify.b{b}", b, cfg.spec_k + 1)
                run(f"draft.b{b}", b, 1, draft=True)
            run(f"draft_prefill.c{cfg.prefill_chunk}", 1, cfg.prefill_chunk,
                draft=True)
        return out

    # -- the loop ----------------------------------------------------------
    def _run(self):
        eng = self._engine
        cfg = eng.config
        tel = get_telemetry()
        running = self._running
        drain_deadline = None
        try:
            while True:
                heartbeat()  # a hung step trips the watchdog
                if preemption_requested() and not eng.draining:
                    eng._begin_drain(reason="preempted")
                if eng.draining:
                    if drain_deadline is None:
                        drain_deadline = (time.monotonic()
                                          + cfg.drain_grace_s)
                    # in-flight generation may keep decoding inside the
                    # grace window; at expiry — or once nothing runs —
                    # everything left goes DRAINED with partial text
                    if not running or time.monotonic() >= drain_deadline:
                        for r in running:
                            self._retire(r, RequestStatus.DRAINED,
                                         detail="drained mid-generation")
                        running.clear()
                        for r in eng._queue.pop_all():
                            eng._finish(r, RequestStatus.DRAINED,
                                        detail="drained before prefill")
                        return
                while not eng.draining and len(running) < cfg.max_running:
                    ready, expired = eng._queue.take(
                        1, timeout=0.0 if running else cfg.idle_poll_s)
                    for r in expired:
                        eng._finish(r, RequestStatus.DEADLINE_EXCEEDED,
                                    detail="deadline expired in queue")
                    if not ready:
                        break
                    running.append(ready[0])
                tel.gauge("serve/queue_depth", len(eng._queue))
                tel.gauge("serve/running", len(running))
                if not running:
                    continue
                # mid-generation deadline shedding: stale results are
                # never delivered as success
                now = time.monotonic()
                for r in list(running):
                    if r.deadline is not None and now >= r.deadline:
                        self._retire(r, RequestStatus.DEADLINE_EXCEEDED,
                                     detail="deadline expired "
                                            "mid-generation")
                        running.remove(r)
                if not running:
                    continue
                inj = active_injector()
                if inj is not None:
                    for r in running:  # injected straggler stalls the round
                        inj.slow_req(r.id)
                prefilling = [r for r in running if r.pending > 1]
                decoding = [r for r in running if r.pending == 1]
                if prefilling:
                    self._prefill_chunk(prefilling[0])
                if decoding:
                    if eng.spec_enabled:
                        self._spec_round(decoding)
                    else:
                        self._decode_round(decoding)
                for r in list(running):
                    if self._done_generating(r):
                        self._retire(r, RequestStatus.OK)
                        running.remove(r)
                self.batch_index += 1
                if inj is not None:
                    inj.maybe_sigterm(self.batch_index)
        except BaseException:
            # a crash must not strand accepted requests: latch drain
            # first, then fail everything in flight (the finish funnel
            # releases their KV blocks)
            tb = traceback.format_exc()
            eng._begin_drain(reason="scheduler crashed")
            for r in running + eng._queue.pop_all():
                if not r.done():
                    eng._finish(r, RequestStatus.ERROR,
                                detail=f"scheduler crashed:\n{tb}")
            running.clear()
            raise

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _budget_spent(r: GenRequest) -> bool:
        return len(r.generated) >= r.max_new or (
            r.eos_id is not None and bool(r.generated)
            and r.generated[-1] == r.eos_id)

    def _done_generating(self, r: GenRequest) -> bool:
        return not r.done() and self._budget_spent(r)

    def _retire(self, r: GenRequest, status: str, detail: str = "") -> None:
        tel = get_telemetry()
        for name, t in (("serve/ttft_ms", r.ttft_ms()),
                        ("serve/tpot_ms", r.tpot_ms())):
            if t is not None:
                tel.observe(name, t)
        self._engine._finish(
            r, status, outputs=[np.asarray(r.generated, np.int32)],
            detail=detail)

    def _append_token(self, r: GenRequest, tok: int) -> bool:
        """Record one generated token; False (nothing recorded) once the
        request's budget or EOS is reached — a speculative round may
        produce more than the request still takes."""
        if self._budget_spent(r):
            return False
        now = time.monotonic()
        if r.first_token_at is None:
            r.first_token_at = now
        r.last_token_at = now
        r.generated.append(int(tok))
        r.toks.append(int(tok))
        get_telemetry().counter("serve/tokens_generated")
        return True

    def _evict(self, victim: GenRequest) -> None:
        """Recompute-style preemption: free the victim's blocks (in both
        pools); it re-enters chunked prefill over its full known token
        sequence."""
        eng = self._engine
        eng._pool.release(victim.id)
        victim.ncache = 0
        if eng.spec_enabled:
            eng._draft_pool.release(victim.id)
            victim.draft_ncache = 0
        victim.evictions += 1
        get_telemetry().counter("serve/kv_evictions")

    def _ensure_blocks(self, r: GenRequest, n_tokens: int,
                       draft: bool = False, exclude=()) -> bool:
        """Grow ``r``'s allocation (in the draft's pool with ``draft``),
        evicting the YOUNGEST other running sequence under pool pressure.
        ``exclude`` protects sequences already accepted into the round's
        batch: evicting one would zero its cache cursor after its feed
        was decided. False = no capacity even after evictions (r waits a
        round)."""
        eng = self._engine
        pool = eng._draft_pool if draft else eng._pool
        while not pool.ensure(r.id, n_tokens):
            victim = next((v for v in reversed(self._running)
                           if v is not r and v not in exclude
                           and v.ncache > 0), None)
            if victim is None:
                return False
            self._evict(victim)
        return True

    def _batch_arrays(self, reqs: List[GenRequest], bucket: int, T: int,
                      tokens: List[List[int]], draft: bool = False):
        """Stack per-sequence feeds, padding rows to ``bucket``: padded
        rows carry kv_len 0, so their writes go to the scratch page and
        their attention rows are fully masked."""
        eng = self._engine
        pool = eng._draft_pool if draft else eng._pool
        toks = np.zeros((bucket, T), np.int32)
        qpos = np.zeros((bucket, T), np.int32)
        lens = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, eng._table_width), np.int32)
        for i, r in enumerate(reqs):
            nc = r.draft_ncache if draft else r.ncache
            toks[i] = tokens[i]
            qpos[i] = nc + np.arange(T, dtype=np.int32)
            lens[i] = nc + T
            tables[i] = pool.block_table(r.id, eng._table_width)
        return self._to_device(toks, qpos, tables, lens)

    def _chunk_arrays(self, r: GenRequest, start: int, real: int,
                      draft: bool = False):
        """One prefill chunk of ``r``'s known tokens from ``start``
        (``real`` of them, zero-padded to the chunk size)."""
        eng = self._engine
        C = eng.config.prefill_chunk
        pool = eng._draft_pool if draft else eng._pool
        chunk = r.toks[start:start + real] + [0] * (C - real)
        return self._to_device(
            np.asarray(chunk, np.int32)[None],
            (start + np.arange(C, dtype=np.int32))[None],
            pool.block_table(r.id, eng._table_width)[None],
            np.asarray([start + real], np.int32))

    # -- prefill -----------------------------------------------------------
    def _prefill_chunk(self, r: GenRequest) -> None:
        eng = self._engine
        tel = get_telemetry()
        C = eng.config.prefill_chunk
        real = min(C, r.pending)
        if not self._ensure_blocks(r, r.ncache + real):
            return  # pool exhausted even after evictions; retry next round
        if eng.spec_enabled and not self._ensure_blocks(
                r, r.draft_ncache + real, draft=True):
            return
        t0 = time.perf_counter()
        g = self._step(*self._chunk_arrays(r, r.ncache, real))
        ms = (time.perf_counter() - t0) * 1e3
        tel.counter("serve/prefill_chunks")
        tel.observe("serve/prefill_ms", ms)
        tel.observe(f"serve/prefill_ms.c{C}", ms)
        if eng.spec_enabled:
            # the draft's cache follows the target's chunk schedule, so
            # proposing never needs a separate prompt pass
            t0 = time.perf_counter()
            self._step(*self._chunk_arrays(r, r.draft_ncache, real,
                                           draft=True), draft=True)
            tel.observe(f"serve/draft_prefill_ms.c{C}",
                        (time.perf_counter() - t0) * 1e3)
            r.draft_ncache += real
        r.ncache += real
        if r.pending == 0:
            # the chunk covered every known token: the last position's
            # greedy output IS the first generated token
            self._append_token(r, int(g[0, real - 1]))

    # -- plain decode ------------------------------------------------------
    def _decode_round(self, decoding: List[GenRequest],
                      protect=()) -> None:
        """One decode step for every decode-eligible sequence.
        ``protect`` extends the eviction exclusion past this round's own
        batch: the speculative round passes its group, whose feeds were
        decided from blocks this round must not take."""
        eng = self._engine
        tel = get_telemetry()
        group = []
        for r in decoding:
            if r.pending != 1:
                continue  # evicted by a neighbor's allocation this round
            if len(group) >= eng.config.max_running:
                break
            if self._ensure_blocks(r, r.ncache + 1,
                                   exclude=group + list(protect)):
                group.append(r)
        if not group:
            return
        bucket = eng.config.bucket_for(len(group))
        arrays = self._batch_arrays(group, bucket, 1,
                                    [[r.toks[-1]] for r in group])
        t0 = time.perf_counter()
        g = self._step(*arrays)
        ms = (time.perf_counter() - t0) * 1e3
        tel.counter("serve/decode_steps")
        tel.observe("serve/decode_ms", ms)
        tel.observe(f"serve/decode_ms.b{bucket}", ms)
        tel.observe("serve/batch_occupancy", len(group) / bucket)
        for i, r in enumerate(group):
            r.ncache += 1
            self._append_token(r, int(g[i, 0]))

    # -- speculative decode ------------------------------------------------
    def _draft_step(self, reqs, bucket, feed) -> np.ndarray:
        """One batched T=1 draft step (timed into ``serve/draft_ms``);
        advances each request's draft cursor."""
        tel = get_telemetry()
        arrays = self._batch_arrays(reqs, bucket, 1, feed, draft=True)
        t0 = time.perf_counter()
        g = self._step(*arrays, draft=True)
        ms = (time.perf_counter() - t0) * 1e3
        tel.observe("serve/draft_ms", ms)
        tel.observe(f"serve/draft_ms.b{bucket}", ms)
        for r in reqs:
            r.draft_ncache += 1
        return g

    def _spec_round(self, decoding: List[GenRequest]) -> None:
        """The draft proposes k tokens per sequence (k cheap steps), the
        target verifies the pending token and all k proposals in ONE
        (k+1)-token step; the longest proposal prefix matching the
        target's greedy choice is accepted, plus the target's own next
        token."""
        eng = self._engine
        cfg = eng.config
        tel = get_telemetry()
        k = cfg.spec_k
        group = []
        tail = []  # too close to max_seq_len for k-ahead writes
        for r in decoding:
            if r.pending != 1:
                continue
            if len(group) >= cfg.max_running:
                break
            # the verify step writes positions ncache..ncache+k: a
            # sequence within k tokens of max_seq_len finishes its last
            # tokens on the plain decode path instead
            if r.ncache + 1 + k > eng.max_seq_len:
                tail.append(r)
                continue
            # the target writes k+1 entries; the draft catches up and
            # writes k
            if not self._ensure_blocks(r, r.ncache + 1 + k, exclude=group):
                continue
            if not self._ensure_blocks(r, len(r.toks) - 1 + k, draft=True,
                                       exclude=group):
                continue
            group.append(r)
        if tail:
            # the tail's allocations must not evict spec-group members
            # whose feeds were decided from their ensured blocks
            self._decode_round(tail, protect=group)
        if not group:
            return
        # draft catch-up, gap 1 (the steady state after a fully accepted
        # round): ONE batched T=1 step for all of them
        gap1 = [r for r in group if len(r.toks) - 1 - r.draft_ncache == 1]
        if gap1:
            self._draft_step(gap1, cfg.bucket_for(len(gap1)),
                             [[r.toks[r.draft_ncache]] for r in gap1])
        # chunked catch-up for larger gaps (re-prefill after an eviction)
        for r in group:
            while len(r.toks) - 1 - r.draft_ncache > 0:
                real = min(cfg.prefill_chunk,
                           len(r.toks) - 1 - r.draft_ncache)
                t0 = time.perf_counter()
                self._step(*self._chunk_arrays(r, r.draft_ncache, real,
                                               draft=True), draft=True)
                tel.observe(f"serve/draft_prefill_ms.c{cfg.prefill_chunk}",
                            (time.perf_counter() - t0) * 1e3)
                r.draft_ncache += real
        bucket = cfg.bucket_for(len(group))
        # phase 1: k sequential draft steps propose greedily
        proposals = [[] for _ in group]
        feed = [[r.toks[-1]] for r in group]
        for _ in range(k):
            g = self._draft_step(group, bucket, feed)
            for i in range(len(group)):
                proposals[i].append(int(g[i, 0]))
            feed = [[p[-1]] for p in proposals]
        # phase 2: one batched (k+1)-token target verification
        arrays = self._batch_arrays(
            group, bucket, k + 1,
            [[r.toks[-1]] + proposals[i] for i, r in enumerate(group)])
        t0 = time.perf_counter()
        g = self._step(*arrays)
        ms = (time.perf_counter() - t0) * 1e3
        tel.counter("serve/decode_steps")
        tel.observe("serve/verify_ms", ms)
        tel.observe(f"serve/verify_ms.b{bucket}", ms)
        tel.observe("serve/batch_occupancy", len(group) / bucket)
        # phase 3: accept the longest matching prefix + the correction
        round_accepted = 0
        for i, r in enumerate(group):
            len_old = len(r.toks)
            a = 0
            while a < k and proposals[i][a] == int(g[i, a]):
                a += 1
            for t in proposals[i][:a] + [int(g[i, a])]:
                if not self._append_token(r, t):
                    break
            # the target's cache advanced over the pending token and the
            # a accepted proposals; rejected entries are overwritten when
            # their positions are fed again (and masked until then)
            r.ncache = min(r.ncache + 1 + a, len(r.toks) - 1)
            # the draft's entries past the accepted prefix roll back the
            # same way (a == k leaves the draft one token behind: the
            # next round's catch-up covers it)
            r.draft_ncache = min(len_old + min(a, k - 1), r.draft_ncache)
            self._spec_proposed += k
            self._spec_accepted += a
            round_accepted += a
        tel.counter("serve/spec_proposed", k * len(group))
        tel.counter("serve/spec_accepted", round_accepted)
        tel.gauge("serve/spec_accept_rate",
                  self._spec_accepted / max(self._spec_proposed, 1))


def dense_greedy_reference(model, prompt: Sequence[int], max_new: int,
                           eos_id: Optional[int] = None) -> List[int]:
    """Greedy decode by FULL-PREFIX recompute through the model's eval
    forward — the reference the paged decode path is held against.
    Runs on the device of the model's parameters."""
    dev = next(model.parameters()).device
    toks = [int(t) for t in prompt]
    out: List[int] = []
    with torch.no_grad():
        for _ in range(int(max_new)):
            ids = torch.tensor([toks], dtype=torch.long, device=dev)
            t = int(model(ids)[0, -1].argmax())
            toks.append(t)
            out.append(t)
            if eos_id is not None and t == eos_id:
                break
    return out


class TokenServingEngine(ServingEngine):
    """Token-level serving over a ``GPTForCausalLM``::

        eng = TokenServingEngine(model, TokenServeConfig(
            decode_buckets=(1, 2, 4, 8), prefill_chunk=128,
            kv_blocks=513, kv_dtype="bfloat16"))
        eng.start()
        req = eng.submit(prompt_ids, max_new_tokens=32)
        req.wait()
        req.outputs[0]          # generated token ids

    ``device`` defaults to ``"cuda"``; the model's parameters (and the
    draft model's) must already live there (they are served in place,
    never copied). With ``spec_k > 0`` a ``draft_model`` (a smaller
    ``GPTForCausalLM`` with the same vocabulary) proposes the tokens the
    model verifies; it gets a pool of its own with the same geometry.
    """

    def __init__(self, model, config: Optional[TokenServeConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 draft_model=None):
        self.config = config or TokenServeConfig()
        cfg = self.config
        if cfg.spec_k > 0 and draft_model is None:
            raise ValueError("spec_k > 0 needs a draft_model")
        self.device = resolve_device(device)
        for m in (model, draft_model):
            p_dev = None if m is None else next(m.parameters()).device
            if p_dev is not None and (p_dev.type != self.device.type or (
                    self.device.index is not None
                    and p_dev.index != self.device.index)):
                raise ValueError(f"model parameters are on {p_dev}, engine "
                                 f"device is {self.device}")
        mcfg = model.config
        head_dim = mcfg.hidden_size // mcfg.num_heads
        self._params = get_params(model)
        self._fwd = gpt_decode_fns(mcfg, cfg.kv_dtype)
        pool_cfg = KVCacheConfig(
            mcfg.num_layers, mcfg.num_heads, head_dim,
            num_blocks=cfg.kv_blocks, block_size=cfg.kv_block_size,
            dtype=cfg.kv_dtype)
        max_seq = cfg.max_seq_len or mcfg.max_position_embeddings
        max_seq = min(max_seq, mcfg.max_position_embeddings)
        if pool_cfg.blocks_for(max_seq) > pool_cfg.usable_blocks:
            raise ValueError(
                f"KV pool ({pool_cfg.usable_blocks} usable blocks of "
                f"{cfg.kv_block_size}) cannot hold ONE max-length sequence "
                f"({max_seq} tokens) — raise kv_blocks or lower max_seq_len")
        self.max_seq_len = max_seq
        self._pool = KVCachePool(pool_cfg, device=self.device)
        self._table_width = pool_cfg.blocks_for(max_seq)
        self.spec_enabled = draft_model is not None and cfg.spec_k > 0
        self._draft_params = self._draft_fwd = self._draft_pool = None
        if self.spec_enabled:
            dcfg = draft_model.config
            if dcfg.vocab_size != mcfg.vocab_size:
                raise ValueError(f"draft vocabulary {dcfg.vocab_size} != "
                                 f"the model's {mcfg.vocab_size}")
            self._draft_params = get_params(draft_model)
            self._draft_fwd = gpt_decode_fns(dcfg, cfg.kv_dtype)
            self._draft_pool = KVCachePool(KVCacheConfig(
                dcfg.num_layers, dcfg.num_heads,
                dcfg.hidden_size // dcfg.num_heads,
                num_blocks=cfg.kv_blocks, block_size=cfg.kv_block_size,
                dtype=cfg.kv_dtype), device=self.device)
        self._init_runtime()

    def _make_scheduler(self):
        return DecodeScheduler(self)

    @property
    def pool(self) -> KVCachePool:
        return self._pool

    def _publish_start_gauges(self) -> None:
        pass  # no predictor, so no serving-dtype gauge

    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None) -> GenRequest:
        """Admit or shed one generation request. ALWAYS returns a
        request; a shed one is already terminal."""
        if not self._started:
            raise RuntimeError("TokenServingEngine.start() first")
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 1 or prompt.size < 1 \
                or not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError("prompt_ids must be a non-empty 1-D integer "
                             f"array, got shape {prompt.shape} "
                             f"{prompt.dtype}")
        max_new = (self.config.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds max_seq_len {self.max_seq_len}")
        req_id = self._allocate_request_id()
        req = GenRequest(req_id, prompt.astype(np.int32), max_new,
                         self._resolve_deadline(req_id, deadline_s),
                         eos_id=eos_id)
        return self._admit(req)

    def _finish(self, req, status, outputs=None, detail="", error=None):
        # the single terminal funnel also owns KV release, whatever path
        # terminates the request (release is idempotent)
        self._pool.release(req.id)
        if self.spec_enabled:
            self._draft_pool.release(req.id)
        super()._finish(req, status, outputs=outputs, detail=detail,
                        error=error)

    def kv_accounting(self) -> dict:
        """The pool's leak ledger (and the draft pool's as ``draft``)."""
        out = self._pool.accounting()
        if self.spec_enabled:
            out["draft"] = self._draft_pool.accounting()
        return out
