"""The attention tier policy of the port (paddle_tpu_torch.ops.tier_policy
and the dispatch of ops.attention) against the reference's:

- the verdict cache (the reference's TestTierCache cases): one bench per
  key, restart-warm from the JSON file, a corrupt file re-measured in
  memory and never touched, a forced tier never benched, a restricted
  candidate set never written over the full set's verdict, one bench
  across calls;
- the reference's fallback accounting in the port's form: where the
  reference reroutes and counts ``attn/tier_fallbacks``, the port raises
  and the counter stays 0;
- parity with the JAX functions, forward and gradients:
  ``blockwise_attention`` (causal and full, with and without a bias, a
  ragged Lk, f32 and bf16) and the q-chunked causal ``xla_attention`` in
  both layouts with the exp-weight recompute on and off;
- the bench runs outside the caller's thread-local state: first
  triggered inside a ``remat='dots'`` step it leaves the loss and every
  gradient bit of the step equal to a step whose verdict was cached;
- the paged tiers' policy; the longctx model (``bench.longctx_config``'s
  smoke size) trained 3 steps through both engines under the forced
  ``blockwise`` and ``xla`` tiers.
"""
import importlib
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.ops import attention as jatt
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import bench
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import tier_policy
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32: the same f32 math in another order
F32_TOL = 1e-5
# bf16 against the reference's own hand-written rule (_causal_chunked) or
# its blockwise scan under autodiff: both round the same bf16 operands;
# an output element may land one bf16 ulp apart (2^-7 of its magnitude,
# bounded by the tensor's largest)
BF16_SHARE = 2.0 ** -7
# bf16 chunked tier against the reference's default, autodiff of the same
# forward: autodiff rounds its own intermediates (the normalized P, the
# saved exp weights' cotangents) to bf16 at other places
BF16_AUTODIFF_SHARE = 2.0 ** -4
# longctx smoke model, f32: 3 Adam steps on the same weights, the port's
# two-pass LayerNorm against the reference's one-pass
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PADDLE_TPU_ATTN_POLICY", "PADDLE_TPU_ATTN_TIER_CACHE",
                "PADDLE_TPU_COMPILE_CACHE_DIR",
                "PADDLE_TPU_ATTN_PAGED_POLICY"):
        monkeypatch.delenv(var, raising=False)
    tier_policy.reset()
    yield
    tier_policy.reset()


def _stub_times(monkeypatch, times, calls=None):
    """Canned timings per tier (None = infeasible); ``calls`` collects the
    tiers timed."""
    def fake(tier, q, k, v, causal):
        if calls is not None:
            calls.append(tier)
        return times.get(tier)

    monkeypatch.setattr(tier_policy, "_time_tier", fake)


def _qkv(seed=0, b=2, h=2, L=32, d=8, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(b, h, L, d).astype(np.float32))
                 .to(dtype) for _ in range(3))


# ---------------------------------------------------------------------------
# the verdict cache
# ---------------------------------------------------------------------------
class TestTierCache:
    def test_same_shape_benches_exactly_once(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        monkeypatch.setenv("PADDLE_TPU_ATTN_TIER_CACHE",
                           str(tmp_path / "tiers.json"))
        calls = []
        _stub_times(monkeypatch, {"xla": 1.0, "blockwise": 2.0}, calls)
        cands = ["xla", "blockwise"]
        f32 = torch.float32
        assert tier_policy.select(4, 128, 32, f32, True, cands) == "xla"
        assert calls == ["xla", "blockwise"]
        assert tier_policy.select(4, 128, 32, f32, True, cands) == "xla"
        assert len(calls) == 2  # a cache hit
        tier_policy.select(4, 256, 32, f32, True, cands)
        assert len(calls) == 4  # another shape, another key

    def test_cache_hit_across_process_restart(self, monkeypatch, tmp_path):
        cache = tmp_path / "tiers.json"
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        monkeypatch.setenv("PADDLE_TPU_ATTN_TIER_CACHE", str(cache))
        _stub_times(monkeypatch, {"xla": 1.0, "blockwise": 2.0})
        assert tier_policy.select(4, 128, 32, torch.float32, True,
                                  ["xla", "blockwise"]) == "xla"
        (key, verdict), = json.loads(cache.read_text()).items()
        assert key == "cpu:cpu:h4:L128:d32:float32:causal"
        assert verdict["tier"] == "xla"
        assert verdict["timings_ms"] == {"xla": 1000.0, "blockwise": 2000.0}
        tier_policy.reset()  # "restart": memory gone, the file stays

        def boom(*a):
            raise AssertionError("a restart-warm select must not re-bench")

        monkeypatch.setattr(tier_policy, "_time_tier", boom)
        assert tier_policy.select(4, 128, 32, torch.float32, True,
                                  ["xla", "blockwise"]) == "xla"

    def test_corrupt_cache_remeasures_and_deletes_nothing(
            self, monkeypatch, tmp_path):
        cache = tmp_path / "tiers.json"
        garbage = "{not json" * 3
        cache.write_text(garbage)
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        monkeypatch.setenv("PADDLE_TPU_ATTN_TIER_CACHE", str(cache))
        _stub_times(monkeypatch, {"xla": 1.0, "blockwise": 2.0})
        assert tier_policy.select(4, 128, 32, torch.float32, True,
                                  ["xla", "blockwise"]) == "xla"
        assert cache.read_text() == garbage
        tier_policy.select(4, 256, 32, torch.float32, True,
                           ["xla", "blockwise"])
        assert cache.read_text() == garbage

    def test_env_override_wins_and_never_benches(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "blockwise")

        def boom(*a):
            raise AssertionError("a forced policy must not micro-bench")

        monkeypatch.setattr(tier_policy, "_time_tier", boom)
        q, k, v = _qkv()
        out = tatt.dot_product_attention(q, k, v, causal=True)
        ref = tatt.blockwise_attention(q, k, v, causal=True)
        assert torch.equal(out, ref)
        scal = get_telemetry().scalars()
        assert scal["gauge/attn/tier.L32.d8.c"] == \
            tier_policy.TIER_IDS["blockwise"]

    def test_unknown_policy_falls_back_to_heuristic(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "warp-drive")
        assert tier_policy.policy_mode() == "heuristic"
        monkeypatch.delenv("PADDLE_TPU_ATTN_POLICY")
        assert tier_policy.policy_mode() == "heuristic"  # the unset default

    def test_restricted_candidates_never_clobber_disk_verdict(
            self, monkeypatch, tmp_path):
        cache = tmp_path / "tiers.json"
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        monkeypatch.setenv("PADDLE_TPU_ATTN_TIER_CACHE", str(cache))
        _stub_times(monkeypatch,
                    {"flash_tpu": 1.0, "xla": 2.0, "blockwise": 3.0})
        f32 = torch.float32
        assert tier_policy.select(4, 128, 32, f32, True,
                                  ["flash_tpu", "xla", "blockwise"]) \
            == "flash_tpu"
        tier_policy.reset()
        assert tier_policy.select(4, 128, 32, f32, True,
                                  ["xla", "blockwise"]) == "xla"
        (_, verdict), = json.loads(cache.read_text()).items()
        assert verdict["tier"] == "flash_tpu"
        tier_policy.select(4, 256, 32, f32, True, ["xla", "blockwise"])
        data = json.loads(cache.read_text())
        assert {v["tier"] for v in data.values()} == {"flash_tpu", "xla"}
        tier_policy.reset()

        def boom(*a):
            raise AssertionError("a full-set select must not re-bench")

        monkeypatch.setattr(tier_policy, "_time_tier", boom)
        assert tier_policy.select(4, 128, 32, f32, True,
                                  ["flash_tpu", "xla", "blockwise"]) \
            == "flash_tpu"

    def test_bench_mode_dispatch_one_bench_across_calls(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        _stub_times(monkeypatch, {"xla": 1.0, "blockwise": 2.0})
        tel = get_telemetry()
        before = tel.counter_value("attn/tier_bench")
        q, k, v = _qkv(L=64)
        tatt.dot_product_attention(q, k, v, causal=True)
        tatt.dot_product_attention(q, k, v, causal=True) * 2.0
        assert tel.counter_value("attn/tier_bench") - before == 1
        assert tel.scalars()["gauge/attn/tier.L64.d8.c"] == \
            tier_policy.TIER_IDS["xla"]

    def test_real_bench_times_every_candidate(self, monkeypatch):
        """Unstubbed on the CPU: both candidates timed, the winner is the
        faster, and the bench's backward runs under the caller's
        ``no_grad`` (it runs in its own thread)."""
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        q, k, v = _qkv(L=256, d=16)
        with torch.no_grad():
            out = tatt.dot_product_attention(q, k, v, causal=True)
        verdict = tier_policy.registry().verdict(tier_policy.make_key(
            2, 256, 16, torch.float32, True))
        times = verdict["timings_ms"]
        assert set(times) == {"xla", "blockwise"}
        assert verdict["tier"] == min(times, key=times.get)
        ref = (tatt.xla_attention if verdict["tier"] == "xla"
               else tatt.blockwise_attention)(q, k, v, causal=True)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("err, infeasible", [
    (RuntimeError("nvcc failed for flash_attn_fwd.cu"), False),
    (RuntimeError("flash_attention_blhd: CUDA error 700"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (ValueError("flash_attention_blhd: head dim 8 not in (32, 64, 128)"),
     True)])
def test_only_memory_or_a_refused_shape_makes_a_tier_infeasible(
        monkeypatch, tmp_path, err, infeasible):
    # a flash kernel that does not build or launch is an error, never a
    # verdict for a plain tier
    path = tmp_path / "tiers.json"
    monkeypatch.setenv("PADDLE_TPU_ATTN_TIER_CACHE", str(path))

    def broken(*a, **k):
        raise err

    monkeypatch.setattr(tatt, "flash_attention", broken)
    args = (2, 32, 8, torch.float32, True, ["flash_tpu", "blockwise"])
    if infeasible:
        assert tier_policy.select(*args) == "blockwise"
        assert list(json.loads(path.read_text()).values())[0][
            "timings_ms"].keys() == {"blockwise"}
        return
    with pytest.raises(type(err), match=str(err)):
        tier_policy.select(*args)
    assert not path.exists()
    assert tier_policy.registry().verdict(
        tier_policy.make_key(2, 32, 8, torch.float32, True)) is None


def test_candidates_follow_the_references_gates():
    q = torch.zeros(1, 2, 64, 8)
    assert tatt._tier_candidates(q, q, q, True, False) == ["xla", "blockwise"]
    long = torch.zeros(1, 1, 16385, 8)
    assert tatt._tier_candidates(long, long, long, True, False) \
        == ["blockwise"]  # past twice the causal threshold
    full = torch.zeros(1, 1, 8193, 8)
    assert tatt._tier_candidates(full, full, full, False, False) \
        == ["blockwise"]
    # the card's flash kernels: causal shapes they take (the meta device
    # stands in for the card's tensors)
    m = torch.empty(1, 64, 2, 64, device="meta")
    assert "flash_tpu" not in tatt._tier_candidates(m, m, m, True, True)


# ---------------------------------------------------------------------------
# the reference's fallback accounting, in the port's form: a raise
# ---------------------------------------------------------------------------
class TestNoSilentReroute:
    def _fallbacks(self):
        return get_telemetry().counter_value("attn/tier_fallbacks")

    def test_flash_tpu_policy_that_does_not_fit_raises(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "flash_tpu")
        before = self._fallbacks()
        q, k, v = _qkv(d=8)  # head dim 8: no kernel instance
        with pytest.raises(NotImplementedError, match="head dim 8"):
            tatt.dot_product_attention(q, k, v, causal=True)
        assert self._fallbacks() == before

    @pytest.mark.parametrize("knob", ["policy", "impl"])
    @pytest.mark.parametrize("tier", ["flash_tpu", "pallas"])
    def test_forced_flash_takes_what_the_kernels_take(self, monkeypatch,
                                                      knob, tier):
        # the reference reroutes a biased or non-causal call off a forced
        # flash impl (to blockwise or xla) and a non-causal flash_tpu
        # verdict to blockwise; the port runs the kernels (their plain
        # versions on the CPU) or raises
        if knob == "policy":
            monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", tier)
        else:
            monkeypatch.setattr(tatt, "_IMPL", tier)
        q, k, v = _qkv(d=64)
        for causal in (True, False):
            out = tatt.dot_product_attention(q, k, v, causal=causal)
            assert torch.equal(out, tatt.flash_attention(q, k, v, causal))
        if knob == "impl":  # the policy rules unbiased calls only
            bias = torch.from_numpy(np.random.RandomState(1).randn(
                2, 1, 1, 32).astype(np.float32))
            out = tatt.dot_product_attention(q, k, v, bias=bias)
            assert torch.equal(out, tatt.flash_attention(
                q, k, v, key_bias=tatt._key_bias(bias, 2, 32)))
            with pytest.raises(NotImplementedError, match="causal=True"):
                tatt.dot_product_attention(q, k, v, causal=True, bias=bias)
            with pytest.raises(NotImplementedError, match="no kernel"):
                tatt.dot_product_attention(q, k, v,
                                           bias=torch.zeros(2, 2, 32, 32))
        with pytest.raises(NotImplementedError, match="head dim 8"):
            tatt.dot_product_attention(*_qkv(d=8), causal=False)
        assert self._fallbacks() == 0

    def test_cached_flash_verdict_that_no_longer_fits_raises(
            self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
        q, k, v = _qkv(L=64, d=8)
        tier_policy.registry().record(
            tier_policy.make_key(2, 64, 8, torch.float32, True),
            {"tier": "flash_tpu", "timings_ms": {}}, persist=False)
        # a verdict outside this call's candidates is re-measured
        _stub_times(monkeypatch, {"xla": 1.0, "blockwise": 2.0})
        tatt.dot_product_attention(q, k, v, causal=True)
        # ... and a forced one that does not fit raises
        monkeypatch.setattr(tier_policy, "select",
                            lambda *a, **k: "flash_tpu")
        with pytest.raises(NotImplementedError, match="flash_tpu"):
            tatt.dot_product_attention(q, k, v, causal=True)
        assert self._fallbacks() == 0

    def test_ring_policy_raises(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "ring")
        q, k, v = _qkv()
        with pytest.raises(NotImplementedError, match="ring"):
            tatt.dot_product_attention(q, k, v, causal=True)
        assert self._fallbacks() == 0

    def test_use_flash_false_is_blockwise_not_a_fallback(self):
        q, k, v = _qkv(L=100)
        out = tatt.dot_product_attention(q, k, v, causal=True,
                                         use_flash=False)
        assert torch.equal(out, tatt.blockwise_attention(q, k, v, True))
        assert get_telemetry().scalars()["gauge/attn/tier.L100.d8.c"] == \
            tier_policy.TIER_IDS["blockwise"]
        assert self._fallbacks() == 0

    def test_unset_policy_keeps_the_plain_path_on_the_cpu(self):
        q, k, v = _qkv(L=256, d=16)  # chunkable: xla_attention would chunk
        out = tatt.dot_product_attention(q, k, v, causal=True)
        assert torch.equal(out, tatt._materialized(q, k, v, True))
        assert get_telemetry().scalars()["gauge/attn/tier.L256.d16.c"] == \
            tier_policy.TIER_IDS["xla"]

    def test_unset_policy_keeps_the_kernel_off_the_cpu(self):
        q = torch.empty(2, 64, 2, 64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tatt.dot_product_attention(q, q, q, causal=True, layout="blhd")


# ---------------------------------------------------------------------------
# parity with the JAX functions
# ---------------------------------------------------------------------------
def _compare(got, ref, dtype, share=BF16_SHARE):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    tol = F32_TOL if dtype == "f32" else share * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _ref_vjp(f, args, g):
    """The reference's output and gradients, ``jax.vjp`` of ``f`` compiled
    once (eager dispatch of the unrolled chunks is ~10x slower)."""
    def run(args, g):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)

    return jax.jit(run)(args, g)


def _jt(a, dtype):
    """The same values as a JAX and a torch leaf."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.tensor(np.asarray(j.astype(jnp.float32)),
                     dtype=torch.bfloat16 if dtype == "bf16"
                     else torch.float32, requires_grad=True)
    return j, t


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(200, 200), (130, 300)])
def test_blockwise_matches_reference(Lq, Lk, causal, bias, dtype):
    """Lk = 200 and 300 are no multiple of block_k = 64."""
    rng = np.random.RandomState(Lq + Lk)
    q, g = (rng.randn(2, 2, Lq, 16).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 2, Lk, 16).astype(np.float32) for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_jt(a, dtype)
                                              for a in (q, k, v, g))
    args, targs = [jq, jk, jv], [tq, tk, tv]
    if bias:
        b = (rng.randn(2, 2, Lq, Lk) * 0.5).astype(np.float32)
        args.append(jnp.asarray(b))
        targs.append(torch.tensor(b, requires_grad=True))
    f = lambda *a: jatt.blockwise_attention(
        *a[:3], causal=causal, block_k=64, bias=a[3] if bias else None)
    out, grads = _ref_vjp(f, args, jg)
    tout = tatt.blockwise_attention(*targs[:3], causal, block_k=64,
                                    bias=targs[3] if bias else None)
    tgrads = torch.autograd.grad(tout, targs, tg.detach())
    _compare(tout, out, dtype)
    for a, r in zip(tgrads, grads):
        _compare(a, r, dtype)


@pytest.mark.parametrize("remat_e", ["1", "0"])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_causal_tier_matches_the_references_rule(
        monkeypatch, dtype, layout, remat_e):
    """``xla_attention`` at L = 256 runs two causal chunks of 128 with the
    hand-written backward; against the reference's ``_causal_chunked``
    (the same rule as a custom_vjp). bf16 stores the scores and exp
    weights in bf16 on both sides."""
    monkeypatch.setenv("PADDLE_TPU_ATTN_REMAT_E", remat_e)
    assert tatt._causal_chunk_size(256) == 128
    rng = np.random.RandomState(3)
    shape = (2, 256, 2, 16) if layout == "blhd" else (2, 2, 256, 16)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _jt(rng.randn(*shape).astype(np.float32), dtype) for _ in range(4))
    out, grads = _ref_vjp(lambda *a: jatt._causal_chunked(
        *a, layout == "blhd"), (jq, jk, jv), jg)
    tout = tatt.xla_attention(tq, tk, tv, causal=True, layout=layout)
    assert tout.grad_fn.name() == "_CausalChunkedBackward"
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), tg.detach())
    _compare(tout, out, dtype)
    for a, r in zip(tgrads, grads):
        _compare(a, r, dtype)


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_causal_tier_matches_autodiff_of_xla_attention(
        dtype, layout):
    """Against the reference's default path at L = 512 (4 chunks):
    ``xla_attention``'s chunked forward under autodiff."""
    rng = np.random.RandomState(4)
    shape = (1, 512, 2, 32) if layout == "blhd" else (1, 2, 512, 32)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _jt(rng.randn(*shape).astype(np.float32), dtype) for _ in range(4))
    out, grads = _ref_vjp(lambda *a: jatt.xla_attention(
        *a, causal=True, layout=layout), (jq, jk, jv), jg)
    tout = tatt.xla_attention(tq, tk, tv, causal=True, layout=layout)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), tg.detach())
    _compare(tout, out, dtype)
    for a, r in zip(tgrads, grads):
        _compare(a, r, dtype, BF16_AUTODIFF_SHARE)


def test_chunk_sizes_and_knobs_follow_the_reference():
    for L in (64, 128, 256, 1000, 1024, 8192, 8193):
        assert tatt._causal_chunk_size(L) == jatt._causal_chunk_size(L), L
    assert tatt._causal_chunk_size(8192) == 256  # 32 chunks at longctx


def test_remat_e_saves_maxima_not_exp_weights(monkeypatch):
    q, k, v = (t.requires_grad_() for t in _qkv(L=256, d=16,
                                               dtype=torch.bfloat16))
    saved = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PADDLE_TPU_ATTN_REMAT_E", mode)
        out = tatt.xla_attention(q, k, v, causal=True)
        saved[mode] = sum(t.numel() for t in out.grad_fn.saved_tensors)
    # two chunks of [2, 2, 128, 128] and [2, 2, 128, 256] exp weights
    assert saved["0"] - saved["1"] >= 2 * 2 * 128 * (128 + 256) - 2 * 2 * 256


def test_blockwise_keeps_no_block_probabilities():
    """Autograd keeps q, k, v, the f32 output and lse: O(L), whatever the
    number of blocks."""
    q, k, v = (t.requires_grad_() for t in _qkv(L=1024, d=16))
    out = tatt.blockwise_attention(q, k, v, causal=True, block_k=64)
    kept = sum(t.numel() for t in out.grad_fn.saved_tensors
               if t is not None)
    assert kept == 4 * 2 * 2 * 1024 * 16 + 2 * 2 * 1024


# ---------------------------------------------------------------------------
# the bench runs outside the caller's state
# ---------------------------------------------------------------------------
def _dots_step_grads():
    """Loss and gradients of one forward and backward of a 1-layer GPT at
    L = 256 under remat='dots' (selective checkpointing's dispatch mode)."""
    from paddle_tpu_torch.jit.functionalize import functionalize
    from paddle_tpu_torch.ops import remat_policy

    cfg = tgpt.gpt2_tiny(num_layers=1)
    model = tgpt.GPTForCausalLM(cfg, device="cpu", seed=3)
    apply = remat_policy.apply_policy(functionalize(model, training=True),
                                      "dots", model)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 256))).long()
    loss = apply(ids, torch.roll(ids, -1, dims=1))
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def test_a_bench_inside_a_dots_step_changes_no_bit(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "bench")
    real, timed = tier_policy._time_tier, []

    def measured_then_pinned(tier, q, k, v, causal):
        # the real fwd+bwd runs (inside the step's first dispatch); the
        # verdict is pinned so that both steps take the same tier
        assert real(tier, q, k, v, causal) is not None
        timed.append(tier)
        return {"xla": 1.0, "blockwise": 2.0}[tier]

    monkeypatch.setattr(tier_policy, "_time_tier", measured_then_pinned)
    loss_a, grads_a = _dots_step_grads()  # the bench runs in here
    assert timed == ["xla", "blockwise"]
    loss_b, grads_b = _dots_step_grads()  # a cache hit
    assert timed == ["xla", "blockwise"]
    assert torch.equal(loss_a, loss_b)
    for name, g in grads_a.items():
        assert torch.equal(g, grads_b[name]), name


# ---------------------------------------------------------------------------
# the paged tiers
# ---------------------------------------------------------------------------
def test_paged_policy_forced_benched_and_heuristic(monkeypatch):
    f32 = torch.float32
    assert tier_policy.select_paged(1, 2, 8, 300, 16, f32, False) \
        == "paged_scan"  # the heuristic: 300·16 > 4096
    monkeypatch.setenv("PADDLE_TPU_ATTN_PAGED_POLICY", "paged_gather")
    assert tier_policy.select_paged(1, 2, 8, 300, 16, f32, False) \
        == "paged_gather"
    monkeypatch.setenv("PADDLE_TPU_ATTN_PAGED_POLICY", "bench")
    tier = tier_policy.select_paged(1, 2, 8, 4, 16, f32, False)
    verdict = tier_policy.registry().verdict(
        tier_policy.make_paged_key(1, 2, 8, 4, 16, f32, False))
    assert set(verdict["timings_ms"]) == set(tier_policy.PAGED_TIERS)
    assert verdict["tier"] == tier
    monkeypatch.setenv("PADDLE_TPU_ATTN_PAGED_POLICY", "warp-drive")
    assert tier_policy.paged_policy_mode() == "heuristic"


# ---------------------------------------------------------------------------
# the longctx model through both engines
# ---------------------------------------------------------------------------
def _longctx_reference(policy):
    cfg, b, L, _ = bench.longctx_config(smoke=True)
    paddle.seed(0)
    model = jgpt.GPTForCausalLM(jgpt.GPTConfig(**vars(cfg)))
    p0 = {k: np.asarray(v, np.float32)
          for k, v in jfunc.get_params(model).items()}
    opt = paddle.optimizer.Adam(learning_rate=1e-4,
                                parameters=model.parameters())
    step = JStep(model, loss_fn=model.loss_fn, optimizer=opt,
                 mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                 remat="full")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (b, L)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    os.environ["PADDLE_TPU_ATTN_POLICY"] = policy
    try:
        losses = [float(np.asarray(step((ids,), (labels,)).numpy()))
                  for _ in range(3)]
    finally:
        del os.environ["PADDLE_TPU_ATTN_POLICY"]
    return p0, losses


@pytest.mark.parametrize("policy", ["blockwise", "xla"])
def test_longctx_smoke_model_trains_as_the_reference(monkeypatch, policy):
    p0, ref = _longctx_reference(policy)
    monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", policy)
    cfg, b, L, _ = bench.longctx_config(smoke=True)
    engine = bench.longctx_engine(cfg, smoke=True, device="cpu")
    load_jax_params(engine._layer, p0)
    ids, labels = bench.longctx_batch(cfg, b, L, "cpu")
    got = [float(engine((ids,), (labels,))) for _ in range(3)]
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    assert got[2] < got[0]
    assert get_telemetry().scalars()[
        f"gauge/attn/tier.L{L}.d{cfg.hidden_size // cfg.num_heads}.c"] \
        == tier_policy.TIER_IDS[policy]


def test_longctx_smoke_bench_prints_the_references_keys(capsys, monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = bench.main(["longctx", "--smoke"])
    assert os.listdir(tmp_path) == []  # its verdict file went with it
    for key in ("metric", "value", "unit", "seq_len",
                "tokens_per_sec_forced_blockwise", "tier_ablation_speedup",
                "attn_tier_selected", "remat_off_peak_hbm_bytes",
                "remat_auto_policy", "remat_auto_peak_hbm_bytes",
                "tier_timings_ms"):
        assert key in out, key
    assert out["seq_len"] == 512
    assert out["attn_tier_selected"] in ("xla", "blockwise")
    assert out["remat_auto_peak_hbm_bytes"] <= out["remat_off_peak_hbm_bytes"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
