"""The port's `nn.functional.loss.fused_linear_hard_ce` and GPT's
`fused_head_ce` switch against the reference's, on the CPU: the per-row
loss, the mask and the gradients of `h2` and `wT` (the joint backward)
on the same seeded inputs with ignored labels, in f32 and in bf16; the
fused path against the port's own split linear + cross entropy; and
`GPTForCausalLM(fused_head_ce=True)` against the reference's model with
the same weights, the loss and every gradient, and under bf16 AMP."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional import loss as jloss
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn.functional import loss as tloss
from paddle_tpu_torch.text.models import gpt as tgpt
from torch_parity import cotangent
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32: the same products and lse; dW sums N rows in another order
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16: the loss rounds to bf16 (2^-8 relative); dlogits is cast to bf16
# once in both packages, the products accumulate in f32
BF16_LOSS_TOL = dict(rtol=2 ** -7, atol=0)
BF16_GRAD_TOL = dict(rtol=2 ** -6, atol=2 ** -10)
# the GPT model: gpt2_tiny's f32 forward (the GPT tests' 1e-4 on logits)
GPT_LOSS_TOL = 1e-5
GPT_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _inputs(dtype, n=24, h=16, v=40, seed=7):
    r = np.random.RandomState(seed)
    h2 = r.randn(n, h).astype(np.float32)
    wT = (r.randn(h, v) * 0.3).astype(np.float32)
    lbl = r.randint(0, v, (n,)).astype(np.int64)
    lbl[[3, 11]] = -100
    if dtype == "bfloat16":  # values that bf16 holds exactly
        h2 = np.asarray(jnp.asarray(h2, jnp.bfloat16), np.float32)
        wT = np.asarray(jnp.asarray(wT, jnp.bfloat16), np.float32)
    return h2, wT, lbl


def _reference(h2, wT, lbl, dtype):
    jd = jnp.dtype(dtype)
    ct = jnp.asarray(cotangent((len(lbl),)), jd)

    def f(h, w):
        return jloss.fused_linear_hard_ce(h, w, jnp.asarray(lbl, jnp.int32),
                                          -100)

    (loss, mask), vjp = jax.vjp(f, jnp.asarray(h2, jd), jnp.asarray(wT, jd))
    dh, dw = vjp((ct, jnp.zeros_like(mask)))
    return [np.asarray(a.astype(jnp.float32)) for a in (loss, mask, dh, dw)]


def _port(h2, wT, lbl, dtype):
    td = getattr(torch, dtype)
    h = torch.from_numpy(h2).to(td).requires_grad_()
    w = torch.from_numpy(wT).to(td).requires_grad_()
    loss, mask = tloss.fused_linear_hard_ce(h, w, torch.from_numpy(lbl))
    assert loss.dtype == mask.dtype == td and not mask.requires_grad
    ct = torch.from_numpy(cotangent((len(lbl),))).to(td)
    (loss * ct).sum().backward()
    return [a.detach().float().numpy() for a in (loss, mask, h.grad, w.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_linear_hard_ce_matches_the_reference(dtype):
    h2, wT, lbl = _inputs(dtype)
    want = _reference(h2, wT, lbl, dtype)
    got = _port(h2, wT, lbl, dtype)
    np.testing.assert_array_equal(got[1], want[1])  # the mask
    assert (got[0][[3, 11]] == 0).all()
    loss_tol = F32_TOL if dtype == "float32" else BF16_LOSS_TOL
    grad_tol = F32_TOL if dtype == "float32" else BF16_GRAD_TOL
    np.testing.assert_allclose(got[0], want[0], **loss_tol)
    for g, w, what in zip(got[2:], want[2:], ("dh", "dW")):
        np.testing.assert_allclose(g, w, err_msg=what, **grad_tol)


def test_fused_matches_the_split_linear_and_cross_entropy():
    h2, wT, lbl = _inputs("float32", seed=8)
    out = []
    for fused in (True, False):
        h = torch.from_numpy(h2).requires_grad_()
        w = torch.from_numpy(wT).requires_grad_()
        lb = torch.from_numpy(lbl)
        if fused:
            loss, mask = tloss.fused_linear_hard_ce(h, w, lb)
            mean = loss.sum() / mask.sum()
        else:
            mean = tloss.cross_entropy(h @ w, lb)
        mean.backward()
        out.append([mean.detach().numpy(), h.grad.numpy(), w.grad.numpy()])
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _gpt_pair(seed=0):
    kw = dict(use_flash_attention=False, fused_head_ce=True)
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
        max_position_embeddings=32, hidden_dropout=0.0,
        attention_dropout=0.0, **kw))
    p0 = {k: np.asarray(v, np.float32)
          for k, v in jfunc.get_params(jm).items()}
    tcfg = tgpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=2, max_position_embeddings=32,
                          hidden_dropout=0.0, attention_dropout=0.0, **kw)
    tm = load_jax_params(tgpt.GPTForCausalLM(tcfg, device="cpu"), p0)
    return jm, tm, p0


def _gpt_batch():
    r = np.random.RandomState(0)
    ids = r.randint(0, 256, (2, 16)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[0, -3:] = -100
    return ids, labels


def test_gpt_fused_head_ce_matches_the_reference():
    jm, tm, p0 = _gpt_pair()
    ids, labels = _gpt_batch()
    apply = jfunc.functionalize(jm, training=True)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: apply(p, {}, ids, labels)[0]))(
        {k: jnp.asarray(v) for k, v in p0.items()})
    loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(want)) <= GPT_LOSS_TOL
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[n]),
                                   err_msg=n, **GPT_GRAD_TOL)
    # the split path of the same model gives the same loss
    tm.config.fused_head_ce = False
    with torch.no_grad():
        split = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert abs(float(split) - float(loss.detach())) <= GPT_LOSS_TOL


def test_gpt_fused_head_follows_the_linear_cast_rule():
    """Under bf16 AMP the head casts its input and the tied weight to
    bf16 (``maybe_cast_inputs("linear", ...)``), so the mean loss comes
    back in bf16, as the reference's does."""
    _, tm, _ = _gpt_pair(seed=1)
    ids, labels = _gpt_batch()
    with torch.no_grad():
        ref = tm(torch.from_numpy(ids), torch.from_numpy(labels))
        with amp.auto_cast(dtype="bfloat16"):
            low = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert ref.dtype == torch.float32 and low.dtype == torch.bfloat16
    assert abs(float(low) - float(ref)) <= 0.05 * float(ref)
