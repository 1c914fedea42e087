"""Port GPT (paddle_tpu_torch.text.models.gpt) against the reference with
the same weights, carried across by `load_jax_params`: the eval forward's
logits, and `forward_chunk` (a prefill chunk, then two decode steps) on
logits and on KV pages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import kv_cache as jkv
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.inference.serving import kv_cache as tkv
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

# the reference's dense forward uses a one-pass LayerNorm, the port a
# two-pass one; 1e-4 covers that difference over 4 layers
LOGITS_TOL = 1e-4
PAGES_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt2_tiny())
    jm.eval()
    np_params = {k: np.asarray(v) for k, v in jget_params(jm).items()}
    tm = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu", seed=7).eval()
    load_jax_params(tm, np_params)
    return jm, tm, np_params


def test_param_names_and_shapes_match(models):
    _, tm, np_params = models
    ours = get_params(tm)
    assert sorted(ours) == sorted(np_params)
    for k, v in np_params.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v)


def test_load_rejects_mismatched_names(models):
    _, tm, np_params = models
    bad = dict(np_params)
    bad["gpt.extra"] = bad.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("b,L", [(1, 17), (2, 64)])
def test_eval_forward_logits_match(models, b, L):
    jm, tm, _ = models
    ids = np.random.RandomState(L).randint(0, 1024, (b, L)).astype(np.int64)
    ref = np.asarray(jm(paddle.Tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (b, L, 1024)
    np.testing.assert_allclose(got, ref, atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("name", ["gpt2_tiny", "gpt2_small", "gpt2_medium"])
def test_config_presets_match(name):
    ours = dataclasses.asdict(getattr(tgpt, name)())
    ref = dataclasses.asdict(getattr(jgpt, name)())
    assert {k: ref[k] for k in ours} == ours


def test_forward_chunk_prefill_then_decode(models):
    _, tm, np_params = models
    cfg = tm.config
    hd = cfg.hidden_size // cfg.num_heads
    geo = (cfg.num_layers, cfg.num_heads, hd)
    jpool = jkv.KVCachePool(jkv.KVCacheConfig(*geo, num_blocks=10,
                                              block_size=8))
    tpool = tkv.KVCachePool(tkv.KVCacheConfig(*geo, num_blocks=10,
                                              block_size=8), device="cpu")
    jfwd = jgpt.gpt_decode_fns(jgpt.gpt2_tiny())
    tfwd = tgpt.gpt_decode_fns(cfg)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    tparams = get_params(tm)
    width = 4
    jpages, tpages = jpool.pages, tpool.pages

    def run(toks, qpos, tables, lens):
        nonlocal jpages
        jl, jpages = jfwd(jparams, *(jnp.asarray(a)
                                     for a in (toks, qpos)),
                          jpages, jnp.asarray(tables), jnp.asarray(lens))
        with torch.no_grad():
            tl, _ = tfwd(tparams, *(torch.from_numpy(a)
                                    for a in (toks, qpos)),
                         tpages, torch.from_numpy(tables),
                         torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_TOL, rtol=0)
        for key in ("k", "v"):  # page 0 is scratch: masked writes land there
            np.testing.assert_allclose(tpages[key][:, 1:].numpy(),
                                       np.asarray(jpages[key])[:, 1:],
                                       atol=PAGES_TOL, rtol=0)
        return np.asarray(jl)

    # prefill: 11 prompt tokens in a 16-token chunk (padded tail)
    prompt = np.random.RandomState(3).randint(0, 1024, 11).astype(np.int32)
    n = len(prompt)
    assert jpool.ensure(1, n) and tpool.ensure(1, n)
    table = jpool.block_table(1, width)
    np.testing.assert_array_equal(table, tpool.block_table(1, width))
    logits = run(np.concatenate([prompt, np.zeros(5, np.int32)])[None],
                 np.arange(16, dtype=np.int32)[None], table[None],
                 np.asarray([n], np.int32))
    tok = int(logits[0, n - 1].argmax())
    # two decode steps in a bucket of 2: row 1 is padding (kv_len 0)
    for step in range(2):
        pos = n + step
        assert jpool.ensure(1, pos + 1) and tpool.ensure(1, pos + 1)
        table = jpool.block_table(1, width)
        logits = run(np.asarray([[tok], [0]], np.int32),
                     np.asarray([[pos], [0]], np.int32),
                     np.stack([table, np.zeros(width, np.int32)]),
                     np.asarray([pos + 1, 0], np.int32))
        tok = int(logits[0, 0].argmax())
