"""Port int8 KV pages (paddle_tpu_torch.quant, the KV part, and the int8
pools of inference.serving) against the reference: `quantize_kv` gives
the reference's int8 values and scales bit for bit on the same inputs
(the same absmax rule), `dequantize_kv` and `quant_dequant` its values,
an int8 pool carries the scale planes, a paged prefill into an int8 pool
writes the reference's pages and logits on the same weights, and stays
as close to a bf16 pool as the reference's own rule asks. Small shapes
only (2 layers, hidden 32)."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quant as jquant
from paddle_tpu.inference.serving import kv_cache as jkv
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import quant as tquant
from paddle_tpu_torch.inference.serving import KVCacheConfig, KVCachePool
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.text.models import gpt as tgpt

_SMALL = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
              max_position_embeddings=128, hidden_dropout=0.0,
              attention_dropout=0.0)
_THREADS = ("ServingScheduler", "DecodeScheduler", "ServingDrain")


@pytest.fixture(autouse=True)
def _no_thread_outlives_the_test():
    """This file starts no engine; the check holds it to that."""
    get_telemetry().reset()
    yield
    alive = [t.name for t in threading.enumerate() if t.name in _THREADS]
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


def _slab(seed, shape=(4, 3, 2, 16), scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 300.0)])
def test_quantize_kv_is_the_references_bits(seed, scale):
    x = _slab(seed, scale=scale)
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tquant.dequantize_kv(tq, ts).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jquant.dequantize_kv(jq, js)))
    # per-head absmax int8: the error is at most half a step
    assert (np.abs(back - x) <= ts.numpy()[..., None] * 0.51).all()


def test_quantize_kv_bf16_input_and_zero_slab():
    x = _slab(3)
    jq, js = jquant.quantize_kv(jnp.asarray(x, jnp.bfloat16))
    tq, ts = tquant.quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    q, s = tquant.quantize_kv(torch.zeros(2, 2, 4))
    assert float(s.min()) > 0  # the 1e-8 floor: no zero scale
    assert float(tquant.dequantize_kv(q, s).abs().max()) == 0
    assert tquant.dequantize_kv(q, s, torch.bfloat16).dtype == torch.bfloat16


def test_quant_dequant_values_and_straight_through_gradient():
    x = np.linspace(-1.3, 1.3, 23, dtype=np.float32)
    for scale in (1.0 / 127, 0.01):
        want = np.asarray(jquant.quant_dequant(jnp.asarray(x), scale))
        got = tquant.quant_dequant(torch.from_numpy(x), scale)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    t = torch.ones(4, requires_grad=True)
    tquant.quant_dequant(t, 0.01).sum().backward()
    jg = jax.grad(lambda v: jquant.quant_dequant(v, 0.01).sum())(
        jnp.ones((4,), jnp.float32))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-6)
    w = _slab(4, (8, 5))
    np.testing.assert_allclose(
        float(tquant._absmax_scale(torch.from_numpy(w))),
        float(jquant._absmax_scale(jnp.asarray(w))), rtol=1e-7)


def test_int8_pool_carries_scales():
    geo = dict(num_layers=2, num_heads=2, head_dim=8, num_blocks=8,
               block_size=4)
    pool = KVCachePool(KVCacheConfig(**geo, dtype="int8"), device="cpu")
    ref = jkv.KVCachePool(jkv.KVCacheConfig(**geo, dtype="int8"))
    assert sorted(pool.pages) == sorted(ref.pages)
    for name, t in pool.pages.items():
        assert tuple(t.shape) == ref.pages[name].shape
        assert str(t.dtype).replace("torch.", "") \
            == str(ref.pages[name].dtype)
    bf16 = KVCachePool(KVCacheConfig(**geo, dtype="bfloat16"), device="cpu")
    # int8 values plus one f32 scale per token-head: (8 + 4) / 16 of bf16
    assert pool.nbytes() / bf16.nbytes() == (8 + 4) / 16


def _prefill(fwd, pool_pages, params, prompt, table, C, to_dev, run):
    """Chunked paged prefill of ``prompt``; the logits of its real rows."""
    n = len(prompt)
    rows = []
    pages = pool_pages
    for c0 in range(0, n, C):
        part = prompt[c0:c0 + C]
        pad = C - len(part)
        toks = np.concatenate([part, np.zeros(pad, np.int32)])[None]
        qpos = (c0 + np.arange(C, dtype=np.int32))[None]
        lens = np.asarray([min(c0 + C, n)], np.int32)
        logits, pages = run(fwd, params, *(to_dev(a) for a in (
            toks, qpos)), pages, to_dev(table), to_dev(lens))
        rows.append(np.asarray(logits)[0, :C - pad])
    return np.concatenate(rows, axis=0), pages


def _paged_prefill_both(models, prompt, kv_dtype, C=8):
    jm, tm = models
    mcfg = dict(num_layers=2, num_heads=2, head_dim=16, num_blocks=16,
                block_size=8, dtype=kv_dtype)
    jpool = jkv.KVCachePool(jkv.KVCacheConfig(**mcfg))
    tpool = KVCachePool(KVCacheConfig(**mcfg), device="cpu")
    for pool in (jpool, tpool):
        pool.ensure(1, len(prompt))
    table = tpool.block_table(1, 8)[None]
    assert (table == jpool.block_table(1, 8)[None]).all()
    jfwd = jax.jit(jgpt.gpt_decode_fns(jm.config, kv_dtype))
    jlog, jpages = _prefill(
        jfwd, jpool.pages, jget_params(jm), prompt, table, C, jnp.asarray,
        lambda f, *a: f(*a))

    def trun(f, *a):
        with torch.no_grad():
            logits, pages = f(*a)
        return logits.numpy(), pages

    tlog, tpages = _prefill(
        tgpt.gpt_decode_fns(tm.config, kv_dtype), tpool.pages,
        get_params(tm), prompt, table, C,
        lambda a: torch.from_numpy(a), trun)
    return (jlog, jpages), (tlog, tpages)


def test_int8_paged_prefill_matches_the_reference(models):
    prompt = np.random.RandomState(2).randint(0, 96, 17).astype(np.int32)
    (jlog, jpages), (tlog, tpages) = _paged_prefill_both(models, prompt,
                                                         "int8")
    # the K/V entering the quantizer differ by float rounding between the
    # two stacks, so a value on a rounding boundary may land one step
    # apart; the scales are f32 absmax over 127
    for name in ("k", "v"):
        diff = np.abs(tpages[name].numpy().astype(np.int32)
                      - np.asarray(jpages[name]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name
        np.testing.assert_allclose(tpages[name + "_scale"].numpy(),
                                   np.asarray(jpages[name + "_scale"]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tlog, jlog, atol=1e-3, rtol=0)
    assert np.array_equal(tlog.argmax(-1), jlog.argmax(-1))


def test_int8_kv_close_to_bf16_reference(models):
    """The reference's rule (`test_int8_kv_close_to_bf16_reference`): the
    int8 pool's logits stay within 5% of the bf16 pool's logit range."""
    prompt = np.random.RandomState(2).randint(0, 96, 17).astype(np.int32)
    _, (ref16, _) = _paged_prefill_both(models, prompt, "bfloat16")
    _, (got8, _) = _paged_prefill_both(models, prompt, "int8")
    span = ref16.max() - ref16.min()
    assert np.max(np.abs(got8 - ref16)) < 0.05 * float(span)


def test_bench_paged_times_int8_pages(monkeypatch, tmp_path):
    from paddle_tpu_torch.ops import tier_policy

    monkeypatch.setenv("PADDLE_TPU_ATTN_PAGED_POLICY", "bench")
    monkeypatch.setenv("PADDLE_TPU_ATTN_TIER_CACHE",
                       str(tmp_path / "cache.json"))
    tier_policy.reset()
    try:
        t0 = time.perf_counter()
        tier = tier_policy.select_paged(1, 2, 8, 3, 4, torch.float32, True)
        assert tier in tier_policy.PAGED_TIERS
        assert time.perf_counter() - t0 < 30
    finally:
        tier_policy.reset()
