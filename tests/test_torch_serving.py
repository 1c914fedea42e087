"""Port token serving (paddle_tpu_torch.inference.serving) against the
reference: KV-pool accounting, greedy outputs token-identical to the
reference `TokenServingEngine` and to `dense_greedy_reference` with the
same weights and prompts, parity under eviction, the
exactly-one-terminal-status ledger, speculative decoding (the reference
engine's tokens with the same target and draft, the reference's
eviction rules for the spec group), int8 KV pools, and SIGTERM
mid-decode (in a child process: exit 77, no leaked block).

Every engine a test makes is shut down by the autouse fixture, which
fails the test if a serving thread outlives it."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.resilience.inject import clear_injector as jclear_injector
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.serving import (GenRequest, KVCacheConfig,
                                                KVCachePool, RequestStatus,
                                                TokenServeConfig,
                                                TokenServingEngine,
                                                dense_greedy_reference,
                                                run_generation_streams)
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.profiler.telemetry import Telemetry, get_telemetry
from paddle_tpu_torch.resilience.inject import clear_injector
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THREADS = ("ServingScheduler", "DecodeScheduler", "ServingDrain")
_ENGINES = []

_SMALL = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
              max_position_embeddings=128, hidden_dropout=0.0,
              attention_dropout=0.0)
_ENGINE = dict(capacity=16, decode_buckets=(1, 2, 4), prefill_chunk=8,
               kv_blocks=48, kv_block_size=8, max_seq_len=96)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Telemetry and injectors reset; afterwards every engine the test
    made is shut down (its scheduler joined with a timeout), and the
    test fails if a serving thread is still alive."""
    get_telemetry().reset()
    clear_injector()
    jclear_injector()
    yield
    try:
        for eng in _ENGINES:
            eng.shutdown()
            if eng._started:  # a never-started thread cannot be joined
                eng._scheduler.join(10.0)
    finally:
        _ENGINES.clear()
        clear_injector()
        jclear_injector()
    deadline = time.monotonic() + 10.0
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.name in _THREADS]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not alive, f"serving threads outlived the test: {alive}"


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**_SMALL))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_SMALL), device="cpu").eval()
    load_jax_params(tm, {k: np.asarray(v)
                         for k, v in jget_params(jm).items()})
    return jm, tm


def make_engine(model, draft=None, **kw):
    cfg = dict(_ENGINE)
    cfg.update(kw)
    eng = TokenServingEngine(model, TokenServeConfig(**cfg), device="cpu",
                             draft_model=draft)
    _ENGINES.append(eng)
    return eng


def ref_engine(model, draft=None, **kw):
    cfg = dict(_ENGINE)
    cfg.update(kw)
    eng = jserving.TokenServingEngine(model, jserving.TokenServeConfig(
        **cfg), draft_model=draft)
    _ENGINES.append(eng)
    return eng


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 96, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# KV cache pool
# ---------------------------------------------------------------------------
def _pool(**kw):
    d = dict(num_layers=2, num_heads=2, head_dim=8, num_blocks=8,
             block_size=4)
    d.update(kw)
    return KVCachePool(KVCacheConfig(**d), device="cpu")


def test_pool_alloc_free_accounting():
    pool = _pool()
    assert pool.config.usable_blocks == 7  # page 0 is scratch
    assert pool.ensure(1, 9) and pool.used_blocks == 3
    assert pool.ensure(1, 9) and pool.used_blocks == 3  # idempotent
    assert pool.ensure(2, 4) and pool.used_blocks == 4
    assert pool.release(1) == 3 and pool.release(1) == 0
    assert pool.release(2) == 1
    acct = pool.accounting()
    assert acct["leaked_blocks"] == 0 and acct["owners"] == []
    tel = get_telemetry()
    assert tel.counter_value("serve/kv_blocks_alloc") == 4
    assert tel.counter_value("serve/kv_blocks_free") == 4


def test_pool_no_partial_grab_on_exhaustion():
    pool = _pool(num_blocks=4)  # 3 usable
    assert pool.ensure(1, 8)
    assert not pool.ensure(2, 8)  # needs 2, 1 free: all-or-nothing
    assert pool.used_blocks == 2 and pool.owned(2) == []
    assert pool.ensure(2, 4)


def test_pool_scratch_never_allocated_and_tables_pad_with_it():
    pool = _pool()
    pool.ensure(1, 28)  # every usable block
    assert 0 not in pool.owned(1)
    assert not pool.ensure(2, 1)
    pool.release(1)
    pool.ensure(9, 5)
    t = pool.block_table(9, 6)
    assert t.shape == (6,) and (t[2:] == 0).all() and (t[:2] > 0).all()
    assert pool.pages["k"].shape == (2, 8, 4, 2, 8)
    assert pool.pages["k"].device.type == "cpu"


def test_pool_int8_waits_for_quant():
    """int8 pools, which used to wait for the quant port: int8 pages with
    one f32 scale per token-head; an unknown storage dtype is refused."""
    pool = _pool(dtype="int8")
    assert pool.pages["k"].dtype == torch.int8
    assert pool.pages["k_scale"].dtype == torch.float32
    assert pool.pages["k_scale"].shape == pool.pages["k"].shape[:-1]
    assert set(pool.pages) == {"k", "v", "k_scale", "v_scale"}
    with pytest.raises(ValueError, match="int4"):
        KVCacheConfig(2, 2, 8, dtype="int4")


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------
def test_greedy_outputs_match_reference_engine_and_dense(models):
    jm, tm = models
    prompts = _prompts(7, (5, 19, 11, 3))
    jeng = ref_engine(jm)
    jeng.start()
    try:
        jreqs = [jeng.submit(p, max_new_tokens=10) for p in prompts]
        for r in jreqs:
            assert r.wait(120)
    finally:
        jeng.shutdown()
    eng = make_engine(tm)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for r in reqs:
            assert r.wait(120)
    finally:
        acct = eng.shutdown()
    for p, r, jr in zip(prompts, reqs, jreqs):
        assert r.status == jr.status == RequestStatus.OK
        got = [int(t) for t in r.outputs[0]]
        assert got == [int(t) for t in jr.outputs[0]]
        # (the reference engine's own parity with its dense reference is
        # the reference suite's test; its eager dense recompute is slow)
        assert got == dense_greedy_reference(tm, p, 10)
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    assert eng.kv_accounting()["leaked_blocks"] == 0


def test_eviction_under_pool_pressure_keeps_parity(models):
    _, tm = models
    eng = make_engine(tm, kv_blocks=9, kv_block_size=8, max_seq_len=48)
    eng.start()
    try:
        prompts = _prompts(7, (20, 20, 20))
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        for r in reqs:
            assert r.wait(120)
        for p, r in zip(prompts, reqs):
            assert r.status == RequestStatus.OK
            assert [int(t) for t in r.outputs[0]] \
                == dense_greedy_reference(tm, p, 16)
    finally:
        eng.shutdown()
    tel = get_telemetry()
    assert tel.counter_value("serve/kv_evictions") >= 1
    assert eng.kv_accounting()["leaked_blocks"] == 0
    assert tel.counter_value("serve/kv_blocks_alloc") \
        == tel.counter_value("serve/kv_blocks_free")


def test_eos_stops_generation(models):
    _, tm = models
    p = _prompts(11, (6,))[0]
    ref = dense_greedy_reference(tm, p, 12)
    eos = ref[2]
    eng = make_engine(tm)
    eng.start()
    try:
        r = eng.submit(p, max_new_tokens=12, eos_id=eos)
        assert r.wait(60)
    finally:
        eng.shutdown()
    assert [int(t) for t in r.outputs[0]] == ref[:ref.index(eos) + 1]


# ---------------------------------------------------------------------------
# lifecycle: every request terminal exactly once
# ---------------------------------------------------------------------------
def test_every_request_reaches_exactly_one_terminal_status(models):
    _, tm = models
    eng = make_engine(tm, capacity=2, max_running=1, decode_buckets=(1,),
                      drain_grace_s=0.0)
    eng.start()
    prompts = _prompts(3, (4,) * 6)
    reqs = [eng.submit(p, max_new_tokens=40) for p in prompts]
    expired = eng.submit(prompts[0], max_new_tokens=2, deadline_s=0.0)
    acct = eng.shutdown()
    reqs.append(expired)
    assert expired.status == RequestStatus.DEADLINE_EXCEEDED
    assert any(r.status == RequestStatus.REJECTED for r in reqs)
    for r in reqs:
        assert r.done() and r.status in RequestStatus.TERMINAL
        assert not r.finish(RequestStatus.ERROR)  # second claim refused
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    assert sum(acct["by_status"].values()) == acct["submitted"] == len(reqs)
    assert eng.kv_accounting()["leaked_blocks"] == 0
    assert eng.drain_reason == "shutdown"
    late = eng.submit(prompts[0], max_new_tokens=1)
    assert late.status == RequestStatus.REJECTED  # draining: shed


def test_submit_validation(models):
    _, tm = models
    eng = make_engine(tm)
    with pytest.raises(RuntimeError):
        eng.submit(np.arange(3))  # not started
    eng.start()
    try:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((2, 2), np.int32))
        with pytest.raises(ValueError):
            eng.submit(np.arange(3), max_new_tokens=0)
        with pytest.raises(ValueError):
            eng.submit(np.arange(90), max_new_tokens=10)  # > max_seq_len
    finally:
        acct = eng.shutdown()
    assert acct["submitted"] == 0


def test_speculative_decoding_is_a_later_slice(models):
    """Speculative decoding, which used to be a later slice: spec_k > 0
    needs a draft model, a draft of another vocabulary is refused, and a
    draft turns the speculative rounds on."""
    _, tm = models
    with pytest.raises(ValueError, match="draft_model"):
        make_engine(tm, spec_k=2)
    other = tgpt.GPTForCausalLM(tgpt.GPTConfig(**{**_DRAFT,
                                                  "vocab_size": 64}),
                                device="cpu").eval()
    with pytest.raises(ValueError, match="vocabulary"):
        make_engine(tm, draft=other, spec_k=2)
    eng = make_engine(tm, draft=tm, spec_k=2)
    assert eng.spec_enabled and set(eng.kv_accounting()) >= {"draft"}
    assert not make_engine(tm, draft=tm).spec_enabled  # spec_k 0: off


def test_run_generation_streams_summary(models):
    _, tm = models
    eng = make_engine(tm)
    eng.start()
    prompts = _prompts(5, (3, 9, 14, 6))
    try:
        res = run_generation_streams(eng, n_streams=2,
                                     requests_per_stream=2,
                                     prompt_fn=lambda i: prompts[i],
                                     max_new_tokens=5)
    finally:
        eng.shutdown()
    assert res["by_status"] == {"ok": 4}
    assert res["tokens_generated"] == 20 and res["tokens_per_s"] > 0
    assert res["ttft_p50_ms"] <= res["ttft_p99_ms"]
    assert "tpot_p50_ms" in res and len(res["requests"]) == 4
    s = tserving.summarize_generation(res["requests"])
    assert s["tokens_generated"] == 20


def test_telemetry_surface():
    tel = Telemetry()
    tel.counter("serve/x")
    tel.counter("serve/x", 2)
    tel.gauge("serve/g", 0.5)
    for v in (1.0, 2.0, 3.0):
        tel.observe("serve/h", v)
    s = tel.scalars()
    assert s["counter/serve/x"] == 3 and s["gauge/serve/g"] == 0.5
    assert s["hist/serve/h/count"] == 3 and s["hist/serve/h/p50"] == 2.0
    tel.reset()
    assert tel.scalars() == {}


def test_model_runs_where_its_parameters_are(models):
    _, tm = models
    assert next(tm.parameters()).device.type == "cpu"
    with pytest.raises(ValueError):
        TokenServingEngine(tm, TokenServeConfig(**_ENGINE),
                           device=torch.device("meta"))


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------
_DRAFT = dict(_SMALL, hidden_size=16, num_layers=1)


@pytest.fixture(scope="module")
def drafts():
    paddle.seed(3)
    jd = jgpt.GPTForCausalLM(jgpt.GPTConfig(**_DRAFT))
    jd.eval()
    td = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_DRAFT), device="cpu").eval()
    load_jax_params(td, {k: np.asarray(v)
                         for k, v in jget_params(jd).items()})
    return jd, td


def _serve(eng, prompts, n):
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    for r in reqs:
        assert r.wait(120)
    acct = eng.shutdown()
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    return [[int(t) for t in r.outputs[0]] for r in reqs], reqs


def test_spec_output_equals_the_reference_engine_and_greedy(models, drafts):
    jm, tm = models
    jd, td = drafts
    prompts = _prompts(7, (5, 13))
    got, reqs = _serve(make_engine(tm, draft=td, spec_k=3), prompts, 10)
    snap = get_telemetry().snapshot()
    want, _ = _serve(ref_engine(jm, draft=jd, spec_k=3), prompts, 10)
    assert got == want
    for p, toks, r in zip(prompts, got, reqs):
        assert r.status == RequestStatus.OK
        assert toks == dense_greedy_reference(tm, p, 10)
    proposed = snap["counters"]["serve/spec_proposed"]
    assert 0 < snap["counters"]["serve/spec_accepted"] <= proposed
    assert snap["gauges"]["serve/spec_accept_rate"] == pytest.approx(
        snap["counters"]["serve/spec_accepted"] / proposed)
    kv = _ENGINES[0].kv_accounting()
    assert kv["leaked_blocks"] == 0 and kv["draft"]["leaked_blocks"] == 0


def test_self_draft_accepts_everything(models):
    """Draft == target: every proposal verifies, acceptance 1.0, and the
    12 tokens take far fewer verify steps than 12."""
    _, tm = models
    eng = make_engine(tm, draft=tm, spec_k=3)
    (toks,), _ = _serve(eng, [np.arange(7, dtype=np.int32)], 12)
    assert toks == dense_greedy_reference(tm, np.arange(7), 12)
    snap = get_telemetry().snapshot()
    assert snap["gauges"]["serve/spec_accept_rate"] == 1.0
    assert snap["counters"]["serve/decode_steps"] <= 5


def test_spec_at_max_seq_len_boundary(models, drafts):
    """prompt + budget lands exactly on max_seq_len: the tail falls back
    to the plain decode path and the output stays greedy-exact."""
    _, tm = models
    _, td = drafts
    eng = make_engine(tm, draft=td, spec_k=3, max_seq_len=32, kv_blocks=16,
                      kv_block_size=8)
    prompt = np.arange(16, dtype=np.int32)
    (toks,), (r,) = _serve(eng, [prompt], 16)
    assert r.status == RequestStatus.OK, (r.status, r.detail)
    assert toks == dense_greedy_reference(tm, prompt, 16)
    kv = eng.kv_accounting()
    assert kv["leaked_blocks"] == 0 and kv["draft"]["leaked_blocks"] == 0


def test_eviction_respects_batch_exclusion(models):
    """A sequence already in the round's batch is never evicted by a later
    member's allocation; a merely running one may be."""
    _, tm = models
    eng = make_engine(tm, kv_blocks=5, kv_block_size=8, max_seq_len=32)
    sched = eng._scheduler
    a = GenRequest(1, np.arange(4, dtype=np.int32), 4)
    b = GenRequest(2, np.arange(4, dtype=np.int32), 4)
    assert eng._pool.ensure(a.id, 32)  # a holds every usable block
    a.ncache = 16
    sched._running.extend([a, b])
    assert not sched._ensure_blocks(b, 8, exclude=[a])
    assert a.ncache == 16 and eng._pool.owned(a.id)
    assert sched._ensure_blocks(b, 8)
    assert a.ncache == 0 and not eng._pool.owned(a.id) and a.evictions == 1


def test_tail_decode_protects_spec_group(models, drafts):
    """The plain round the spec path runs for its near-max_seq_len tail
    must not evict the already-ensured spec group."""
    _, tm = models
    _, td = drafts
    eng = make_engine(tm, draft=td, spec_k=3, kv_blocks=5, kv_block_size=8,
                      max_seq_len=32)
    sched = eng._scheduler
    a = GenRequest(1, np.arange(4, dtype=np.int32), 4)
    a.ncache = 16
    b = GenRequest(2, np.arange(4, dtype=np.int32), 4)
    b.ncache = 3  # pending == 1: a decode-eligible tail member
    assert eng._pool.ensure(a.id, 32)
    sched._running.extend([a, b])
    sched._decode_round([b], protect=[a])
    assert a.ncache == 16 and eng._pool.owned(a.id)
    assert b.ncache == 3 and not eng._pool.owned(b.id)


# ---------------------------------------------------------------------------
# int8 pools
# ---------------------------------------------------------------------------
def test_int8_engine_matches_the_reference_int8_engine(models, drafts):
    jm, tm = models
    jd, td = drafts
    prompts = _prompts(9, (6, 17, 11))
    got, _ = _serve(make_engine(tm, kv_dtype="int8"), prompts, 8)
    want, _ = _serve(ref_engine(jm, kv_dtype="int8"), prompts, 8)
    assert got == want
    spec, _ = _serve(make_engine(tm, draft=td, spec_k=2, kv_dtype="int8"),
                     prompts, 8)
    assert spec == got  # the draft changes the speed, never the text
    assert _ENGINES[0].kv_accounting()["leaked_blocks"] == 0


def test_debug_requests_rows(models):
    _, tm = models
    eng = make_engine(tm, capacity=4, max_running=1, decode_buckets=(1,))
    eng.start()
    first = eng.submit(_prompts(1, (40,))[0], max_new_tokens=30)
    queued = eng.submit(_prompts(2, (4,))[0], max_new_tokens=2)
    rows = {row["id"]: row for row in eng.debug_requests()}
    assert rows[queued.id]["phase"] == "queued"
    assert rows[queued.id]["prompt_tokens"] == 4
    assert rows[first.id]["phase"] in ("queued", "prefill", "decode")
    for r in (first, queued):
        assert r.wait(60) and r.status == RequestStatus.OK
    assert eng.debug_requests() == []


_DRAIN_WORKER = textwrap.dedent("""
    import json, os, signal, sys, threading
    import numpy as np
    from paddle_tpu_torch.inference.serving import (TokenServeConfig,
                                                    TokenServingEngine)
    from paddle_tpu_torch.text.models import gpt as tgpt

    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
        max_position_embeddings=256, hidden_dropout=0.0,
        attention_dropout=0.0), device="cpu").eval()
    eng = TokenServingEngine(model, TokenServeConfig(
        capacity=16, decode_buckets=(1, 2, 4), max_running=4,
        prefill_chunk=8, kv_blocks=130, kv_block_size=8, max_seq_len=256,
        drain_grace_s=0.05), device="cpu")
    eng.install_preemption().start()
    rng = np.random.RandomState(0)
    reqs = [eng.submit(rng.randint(0, 96, 12).astype(np.int32),
                       max_new_tokens=200) for _ in range(6)]
    # SIGTERM from a side thread once a stream is observably mid-decode
    # (state-triggered): the short grace then leaves partial generations
    # whatever the host's speed
    def fire():
        while not any(3 <= len(r.generated) < 150 for r in reqs):
            threading.Event().wait(0.002)
        os.kill(os.getpid(), signal.SIGTERM)
    threading.Thread(target=fire, daemon=True).start()
    eng.wait_drained(60.0)
    with open(os.environ["OUT"], "w") as f:
        json.dump({"acct": eng.accounting(), "kv": eng.kv_accounting(),
                   "drain_reason": eng.drain_reason,
                   "statuses": {str(r.id): r.status for r in reqs},
                   "n_generated": {str(r.id): len(r.generated)
                                   for r in reqs},
                   "outputs_present": {str(r.id): r.outputs is not None
                                       for r in reqs}}, f)
    eng.exit_if_preempted()
    sys.exit(3)  # no preemption drain happened
""")


def test_sigterm_mid_decode_exits_77_no_leaks(tmp_path):
    """In a child process: SIGTERM while streams are mid-decode → every
    request terminal exactly once (OK, or DRAINED with its partial text),
    exit 77, zero leaked KV blocks."""
    out_path = str(tmp_path / "out.json")
    worker = tmp_path / "worker.py"
    worker.write_text(_DRAIN_WORKER)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OUT": out_path,
           "PYTHONPATH": _REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("PADDLE_TPU_INJECT", None)
    r = subprocess.run([sys.executable, str(worker)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 77, (r.returncode, r.stderr[-2000:])
    with open(out_path) as f:
        out = json.load(f)
    acct = out["acct"]
    assert out["drain_reason"] == "preempted"
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    assert acct["submitted"] == 6
    assert set(out["statuses"].values()) <= {"ok", "drained"}
    partial = [rid for rid, st in out["statuses"].items()
               if st == "drained" and out["n_generated"][rid] > 0]
    assert partial
    for rid in partial:
        assert out["outputs_present"][rid]
        assert out["n_generated"][rid] < 200
    assert out["kv"]["leaked_blocks"] == 0 and out["kv"]["owners"] == []
