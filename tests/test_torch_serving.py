"""Port token serving (paddle_tpu_torch.inference.serving) against the
reference: KV-pool accounting, greedy outputs token-identical to the
reference `TokenServingEngine` and to `dense_greedy_reference` with the
same weights and prompts, parity under eviction, and the
exactly-one-terminal-status ledger."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.serving import (KVCacheConfig, KVCachePool,
                                                RequestStatus,
                                                TokenServeConfig,
                                                TokenServingEngine,
                                                dense_greedy_reference,
                                                run_generation_streams)
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.profiler.telemetry import Telemetry, get_telemetry
from paddle_tpu_torch.text.models import gpt as tgpt

_SMALL = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
              max_position_embeddings=128, hidden_dropout=0.0,
              attention_dropout=0.0)
_ENGINE = dict(capacity=16, decode_buckets=(1, 2, 4), prefill_chunk=8,
               kv_blocks=48, kv_block_size=8, max_seq_len=96)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    get_telemetry().reset()
    yield


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**_SMALL))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_SMALL), device="cpu").eval()
    load_jax_params(tm, {k: np.asarray(v)
                         for k, v in jget_params(jm).items()})
    return jm, tm


def make_engine(model, **kw):
    cfg = dict(_ENGINE)
    cfg.update(kw)
    return TokenServingEngine(model, TokenServeConfig(**cfg), device="cpu")


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
    with pytest.raises(NotImplementedError):
        KVCacheConfig(2, 2, 8, dtype="int8")


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------
def test_greedy_outputs_match_reference_engine_and_dense(models):
    jm, tm = models
    prompts = _prompts(7, (5, 19, 11, 3))
    jeng = jserving.TokenServingEngine(jm, jserving.TokenServeConfig(
        **_ENGINE))
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
    _, tm = models
    with pytest.raises(NotImplementedError):
        make_engine(tm, spec_k=2)


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
