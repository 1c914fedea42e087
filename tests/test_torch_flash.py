"""Port flash attention (paddle_tpu_torch.ops.flash_tpu) against the
reference. Causal: the plain forward's (out, lse) against the Pallas
`_fwd_kernel` run in interpret mode, ragged L against `xla_attention`;
the plain backward against `_dq_kernel` + `_dkv_kernel` in interpret
mode, ragged L against `jax.vjp` of `xla_attention`. Causal or over every
key: the plain forward against `attention._flash_fwd_kernel` in interpret
mode, ragged L and the backward against the reference's `flash_attention`
(blockwise off the TPU) and its `jax.vjp`; with a key-padding bias, the
plain forward and backward against `blockwise_attention(..., bias=)` and
its `jax.vjp`. The plain backward with bf16-rounded P and dS
(`operand_dtype=torch.bfloat16`, the bf16 kernels' plain version) on bf16 inputs
against `_dq_kernel` + `_dkv_kernel` run in interpret mode on bf16
operands, and at a ragged L against `jax.vjp` of `xla_attention`; the
`flash_bwd_dq` entry's (dq, delta). The packed dK/dV experiment against
`tools/experiments/dkv_packed_kernel.py`'s `dkv_kernel` in interpret
mode, at d = 32, 64 and 128. The CUDA kernels against the plain path on a
card (marked `cuda`): the bf16 tensor-core forward and backward at GPT's
and BERT's shapes, with and without a key bias, the backward's delta, the
packed dK/dV at every head dim (also at a ragged L, and the same bits over
two calls), and the refusal of rows and operands that are not 16-byte
aligned."""
import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu.ops import attention as jatt
from paddle_tpu.ops import flash_tpu as jflash
from paddle_tpu_torch.experiments import dkv_packed as tdkv
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import flash_tpu as tflash
import torch_threads  # noqa: F401  (one torch thread a worker)

OUT_TOL = 2e-5   # f32 accumulation in both, different order
LSE_TOL = 1e-5
GRAD_TOL = 2e-5  # f32 on both sides; sums over up to L keys or queries


def _pallas_fwd(q, k, v, block):
    """The reference's own `_fwd_kernel`, launched as `_fwd_call` launches
    it, in interpret mode. q/k/v: [b, L, H, d] numpy f32."""
    b, L, H, d = q.shape
    r3 = lambda a: a.reshape(b, L, H * d)
    full = pl.BlockSpec((1, L, H * d), lambda ib, iq: (ib, 0, 0))
    with jax.enable_x64(False):
        out, lse = pl.pallas_call(
            functools.partial(jflash._fwd_kernel, H=H, d=d, bq=block,
                              bk=block, scale=1.0 / math.sqrt(d)),
            grid=(b, L // block),
            in_specs=[pl.BlockSpec((1, block, H * d),
                                   lambda ib, iq: (ib, iq, 0)), full, full],
            out_specs=[pl.BlockSpec((1, block, H * d),
                                    lambda ib, iq: (ib, iq, 0)),
                       pl.BlockSpec((1, H, block),
                                    lambda ib, iq: (ib, 0, iq))],
            out_shape=[jax.ShapeDtypeStruct((b, L, H * d), jnp.float32),
                       jax.ShapeDtypeStruct((b, H, L), jnp.float32)],
            interpret=True)(r3(q), r3(k), r3(v))
    return np.asarray(out).reshape(b, L, H, d), np.asarray(lse)


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _port(q, k, v):
    out, lse = tflash.flash_attention_blhd(
        *(torch.from_numpy(a) for a in (q, k, v)))
    return out.numpy(), lse.numpy()


def _np_lse(q, k):
    """log-sum-exp of each query row's scaled causal scores, [b, H, L]."""
    d, L = q.shape[-1], q.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(d)
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("b,L,H,d,block", [
    (1, 256, 2, 64, 128), (2, 128, 2, 32, 64), (1, 192, 3, 16, 64)])
def test_matches_pallas_kernel_in_interpret_mode(b, L, H, d, block):
    q, k, v = _qkv((b, L, H, d), seed=L + d)
    ref_out, ref_lse = _pallas_fwd(q, k, v, block)
    out, lse = _port(q, k, v)
    np.testing.assert_allclose(out, ref_out, atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(lse, ref_lse, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("b,L,H,d", [(1, 77, 2, 32), (2, 33, 3, 16),
                                     (1, 1, 2, 8)])
def test_ragged_length_matches_xla_attention(b, L, H, d):
    """Lengths the TPU kernel's L % 256 gate refused."""
    q, k, v = _qkv((b, L, H, d), seed=L)
    ref = np.asarray(jatt.xla_attention(q, k, v, causal=True, layout="blhd"))
    out, lse = _port(q, k, v)
    np.testing.assert_allclose(out, ref, atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(lse, _np_lse(q, k), atol=LSE_TOL, rtol=0)


def test_strided_views_of_a_fused_projection():
    """q/k/v as views of one [b, L, 3·H·d] projection — the layout the
    model hands the kernel — give the same result as contiguous copies."""
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(2, 40, 3 * 4 * 16).astype(np.float32))
    q, k, v = (t.view(2, 40, 4, 16) for t in qkv.split(64, dim=-1))
    out, lse = tflash.flash_attention_blhd(q, k, v)
    ref_out, ref_lse = tflash.flash_attention_blhd(
        q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_non_causal_is_not_this_kernel():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(NotImplementedError):
        tflash.flash_attention_blhd(q, q, q, causal=False)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention_blhd(q, q, q)


def _pallas_bwd(q, k, v, out, lse, dout, block, dtype=jnp.float32):
    """The reference's own `_dq_kernel` and `_dkv_kernel`, launched as
    `_flash_bwd_rule` launches them (delta as its einsum), in interpret
    mode, on operands of ``dtype``. All [b, L, H, d] numpy f32 (values of
    ``dtype``) but lse [b, H, L]; returns f32 numpy gradients."""
    b, L, H, d = q.shape
    r3 = lambda a: jnp.asarray(a.reshape(b, L, H * d), dtype)
    delta = np.einsum("blhd,blhd->bhl", dout, out).astype(np.float32)
    kw = dict(H=H, d=d, bq=block, bk=block, scale=1.0 / math.sqrt(d))
    act = pl.BlockSpec((1, block, H * d), lambda ib, i: (ib, i, 0))
    full = pl.BlockSpec((1, L, H * d), lambda ib, i: (ib, 0, 0))
    stats_blk = pl.BlockSpec((1, H, block), lambda ib, i: (ib, 0, i))
    stats_full = pl.BlockSpec((1, H, L), lambda ib, i: (ib, 0, 0))
    shape = jax.ShapeDtypeStruct((b, L, H * d), dtype)
    args = (r3(q), r3(k), r3(v), r3(dout), lse, delta)
    with jax.enable_x64(False):
        dq = pl.pallas_call(
            functools.partial(jflash._dq_kernel, **kw), grid=(b, L // block),
            in_specs=[act, full, full, act, stats_blk, stats_blk],
            out_specs=act, out_shape=shape, interpret=True)(*args)
        dk, dv = pl.pallas_call(
            functools.partial(jflash._dkv_kernel, nq=L // block, **kw),
            grid=(b, L // block),
            in_specs=[full, act, act, full, stats_full, stats_full],
            out_specs=[act, act], out_shape=[shape, shape],
            interpret=True)(*args)
    return [np.asarray(t, np.float32).reshape(b, L, H, d)
            for t in (dq, dk, dv)]


def _port_bwd(q, k, v, dout):
    """(dq, dk, dv) of the port's plain backward, and its out and lse."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = tflash._flash_reference(tq, tk, tv)
    grads = tflash._flash_bwd_reference(tq, tk, tv, out, lse, tdo)
    return [t.numpy() for t in grads], out.numpy(), lse.numpy()


@pytest.mark.parametrize("b,L,H,d,block", [(1, 256, 2, 64, 128),
                                           (2, 128, 2, 32, 64)])
def test_backward_matches_pallas_kernels_in_interpret_mode(b, L, H, d,
                                                           block):
    q, k, v, dout = _qkv((b, L, H, d), seed=L + d) + _qkv((b, L, H, d),
                                                          seed=1)[:1]
    grads, out, lse = _port_bwd(q, k, v, dout)
    ref = _pallas_bwd(q, k, v, out, lse, dout, block)
    for got, want, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("b,L,H,d", [(1, 77, 2, 32), (2, 33, 3, 16)])
def test_backward_ragged_length_matches_vjp_of_xla_attention(b, L, H, d):
    """Lengths the TPU kernels' L % 256 gate refused."""
    q, k, v = _qkv((b, L, H, d), seed=L + 1)
    dout = _qkv((b, L, H, d), seed=2)[0]
    _, vjp = jax.vjp(lambda q_, k_, v_: jatt.xla_attention(
        q_, k_, v_, causal=True, layout="blhd"), q, k, v)
    ref = vjp(dout)
    grads, _, _ = _port_bwd(q, k, v, dout)
    for got, want, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_gradients_through_strided_views_of_a_fused_projection():
    """Autograd through the Function with q/k/v as views of one
    [b, L, 3·H·d] projection, against autograd of `xla_attention`."""
    rng = np.random.RandomState(8)
    base = rng.randn(2, 40, 3 * 4 * 16).astype(np.float32)
    g = torch.from_numpy(rng.randn(2, 40, 4, 16).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: tflash.flash_attention_blhd(q, k, v)[0],
               lambda q, k, v: tatt.xla_attention(q, k, v, causal=True,
                                                  layout="blhd")):
        qkv = torch.from_numpy(base).requires_grad_()
        q, k, v = (t.view(2, 40, 4, 16) for t in qkv.split(64, dim=-1))
        assert q.stride(1) == 3 * 64
        grads.append(torch.autograd.grad(fn(q, k, v), qkv, g)[0])
    torch.testing.assert_close(grads[0], grads[1], atol=GRAD_TOL, rtol=0)


def test_lse_is_not_differentiable():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv((1, 8, 1, 8), seed=0))
    out, lse = tflash.flash_attention_blhd(q, k, v)
    assert out.requires_grad and not lse.requires_grad


def test_cpu_backward_launches_no_kernel():
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv((1, 16, 2, 8), seed=0))
    tflash.flash_attention_blhd(q, k, v)[0].sum().backward()
    assert q.grad is not None
    assert (tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("fn", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_kernels_on_other_devices_raise(fn):
    q = torch.empty(1, 4, 2, 64, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    last = q if fn == "flash_bwd_dq" else lse  # out, or delta
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tflash, fn)(q, q, q, q, lse, last)


# ---------------------------------------------------------------------------
# bf16 operands: the plain version of the bf16 tensor-core backward
# ---------------------------------------------------------------------------
# Against the reference's kernels in interpret mode, the same bf16 inputs
# and roundings: each side rounds its outputs to bf16 once (one ulp apart
# at most, 2^-7 of |ref|), and a rounded P or dS element may flip one bf16
# ulp between the two sum orders, which moves one term of a sum by 2^-8 of
# itself: 2^-12 of the tensor's largest magnitude covers a few flips (the
# default f32 P and dS miss it by 3x or more).
BF16_OPS_RTOL, BF16_OPS_REL_ATOL = 2.0 ** -7, 2.0 ** -12
# Against the exact f32 gradient of the same bf16 inputs: the roundings of
# P and dS themselves (2^-9 relative each, summed with both signs) and of
# the outputs: 2^-6 of the tensor's largest magnitude, as #8's check.
BF16_VS_F32_REL_TOL = 2.0 ** -6


def _bf16_inputs(shape, seed):
    """q, k, v, dO as bf16 tensors, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("b,L,H,d,block", [(1, 256, 2, 64, 128),
                                           (2, 128, 2, 64, 64)])
def test_bf16_operands_backward_matches_pallas_kernels_in_interpret_mode(
        b, L, H, d, block):
    tq, tk, tv, tdo = _bf16_inputs((b, L, H, d), seed=L + d)
    out, lse = tflash._flash_reference(tq, tk, tv)
    grads = tflash._flash_bwd_reference(tq, tk, tv, out, lse, tdo,
                                        operand_dtype=torch.bfloat16)
    f = lambda t: t.float().numpy()
    ref = _pallas_bwd(f(tq), f(tk), f(tv), f(out), lse.numpy(), f(tdo),
                      block, jnp.bfloat16)
    for got, want, name in zip(grads, ref, ("dq", "dk", "dv")):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            f(got), want, rtol=BF16_OPS_RTOL,
            atol=BF16_OPS_REL_ATOL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("b,L,H,d", [(1, 77, 2, 64), (2, 200, 2, 32)])
def test_bf16_operands_backward_ragged_length_matches_vjp_of_xla_attention(
        b, L, H, d):
    """Lengths the TPU kernels' L % 256 gate refused, against the exact
    f32 gradient of the same bf16 values."""
    tq, tk, tv, tdo = _bf16_inputs((b, L, H, d), seed=L + 1)
    out, lse = tflash._flash_reference(tq, tk, tv)
    grads = tflash._flash_bwd_reference(tq, tk, tv, out, lse, tdo,
                                        operand_dtype=torch.bfloat16)
    q, k, v, dout = (t.float().numpy() for t in (tq, tk, tv, tdo))
    _, vjp = jax.vjp(lambda q_, k_, v_: jatt.xla_attention(
        q_, k_, v_, causal=True, layout="blhd"), q, k, v)
    for got, want, name in zip(grads, vjp(dout), ("dq", "dk", "dv")):
        want = np.asarray(want)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= BF16_VS_F32_REL_TOL * float(np.abs(want).max()), \
            (name, err)


def test_bf16_operands_off_leaves_the_plain_backward_as_it_was():
    """The operand type's default (None) computes P and dS in f32
    throughout: on f32 inputs it is the unrounded backward, and rounding
    them moves it."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _qkv((1, 40, 2, 16), seed=3) + _qkv((1, 40, 2, 16),
                                                         seed=4)[:1])
    out, lse = tflash._flash_reference(q, k, v)
    plain = tflash._flash_bwd_reference(q, k, v, out, lse, dout)
    off = tflash._flash_bwd_reference(q, k, v, out, lse, dout,
                                      operand_dtype=None)
    on = tflash._flash_bwd_reference(q, k, v, out, lse, dout,
                                     operand_dtype=torch.bfloat16)
    for a, b_, c in zip(plain, off, on):
        assert torch.equal(a, b_) and not torch.equal(a, c)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_dq_returns_delta_on_the_cpu(causal, dtype):
    """`flash_bwd_dq(q, k, v, dout, lse, out)` gives (dq, delta): on the
    CPU the plain dQ and `_delta`; `flash_bwd_dkv` takes that delta, and
    the two together are the plain backward."""
    b, L, H, d = 2, 33, 2, 32
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in
                     _qkv((b, L, H, d), seed=5) + _qkv((b, L, H, d),
                                                       seed=6)[:1])
    bias = None if causal else torch.from_numpy(_key_bias(b, L, seed=7))
    out, lse = tflash._flash_reference(q, k, v, causal, bias)
    dq_fn = tflash.flash_bwd_dq if causal else functools.partial(
        tflash.flash_bwd_dq_full, key_bias=bias)
    dkv_fn = tflash.flash_bwd_dkv if causal else functools.partial(
        tflash.flash_bwd_dkv_full, key_bias=bias)
    counters = (tflash.flash_bwd_dq, tflash.flash_bwd_dkv,
                tflash.flash_bwd_dq_full, tflash.flash_bwd_dkv_full)
    before = [f.launches for f in counters]
    dq, delta = dq_fn(q, k, v, dout, lse, out)
    dk, dv = dkv_fn(q, k, v, dout, lse, delta)
    assert delta.dtype == torch.float32 and delta.shape == (b, H, L)
    assert torch.equal(delta, tflash._delta(out, dout))
    ref = tflash._flash_bwd_reference(q, k, v, out, lse, dout, causal, bias)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and torch.equal(got, want)
    assert [f.launches for f in counters] == before  # no kernel ran


@pytest.mark.parametrize("fn", ["flash_bwd_dq", "flash_bwd_dq_full"])
def test_flash_bwd_dq_takes_out_not_delta(fn):
    """The dQ entry's last operand is the forward's out ([b, L, H, d]),
    checked like dout before any launch (meta tensors stand in for the
    card's)."""
    q = torch.empty(1, 4, 2, 64, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="out shape"):
        getattr(tflash, fn)(q, q, q, q, lse, lse)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol):
    for shape in ((1, 256, 16, 64), (2, 77, 4, 128), (1, 100, 2, 32)):
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(shape, seed=shape[1]))
        before = tflash.flash_attention_blhd.launches
        out, lse = tflash.flash_attention_blhd(q, k, v)
        torch.cuda.synchronize()
        assert tflash.flash_attention_blhd.launches == before + 1
        ref_out, ref_lse = tflash._flash_reference(q, k, v)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


# The backward kernels against the plain path on the card. f32 (the
# scalar kernels): the same f32 FMAs, elementwise 1e-4. bf16 (the tensor-
# core kernels): against the plain version with bf16-rounded P and dS, the
# outputs one bf16 ulp apart at most (2^-7 of |ref|) and a few rounded P or
# dS elements flipped between the two sum orders (mma against einsum,
# ex2 on the folded scale against exp), each moving a term by 2^-8 of
# itself: 2^-9 of the tensor's largest magnitude; and against the f32
# plain version of the same bf16 inputs within 2^-6 of it (the roundings
# themselves). delta: f32 sums of d products in another order, within
# d·2^-23·Σ|dO·O| of `_delta`.
F32_BWD_TOL = 1e-4
CUDA_BF16_OPS_RTOL, CUDA_BF16_OPS_REL_ATOL = 2.0 ** -7, 2.0 ** -9


def _check_cuda_backward(q, k, v, dout, causal, bias=None):
    """One dQ (with delta) and one dK/dV launch against the plain
    versions, as the comment above states."""
    if causal:
        out, lse = tflash.flash_attention_blhd(q, k, v)
        dq_fn, dkv_fn = tflash.flash_bwd_dq, tflash.flash_bwd_dkv
        extra = {}
    else:
        out, lse = tflash.flash_attention_full(q, k, v, key_bias=bias)
        dq_fn, dkv_fn = tflash.flash_bwd_dq_full, tflash.flash_bwd_dkv_full
        extra = {"key_bias": bias}
    before = (dq_fn.launches, dkv_fn.launches)
    dq, delta = dq_fn(q, k, v, dout, lse, out, **extra)
    dk, dv = dkv_fn(q, k, v, dout, lse, delta, **extra)
    torch.cuda.synchronize()
    assert (dq_fn.launches, dkv_fn.launches) == (before[0] + 1,
                                                 before[1] + 1)
    d = q.shape[-1]
    bound = d * 2.0 ** -23 * torch.einsum(
        "blhd,blhd->bhl", dout.float().abs(), out.float().abs())
    assert bool(((delta - tflash._delta(out, dout)).abs() <= bound).all())
    got = (dq, dk, dv)
    if q.dtype == torch.float32:
        ref = tflash._flash_bwd_reference(q, k, v, out, lse, dout, causal,
                                          bias)
        for g, want in zip(got, ref):
            torch.testing.assert_close(g, want, atol=F32_BWD_TOL,
                                       rtol=F32_BWD_TOL)
        return
    ref = tflash._flash_bwd_reference(q, k, v, out, lse, dout, causal, bias,
                                      operand_dtype=torch.bfloat16)
    ref32 = tflash._flash_bwd_reference(
        *(t.float() for t in (q, k, v, out)), lse, dout.float(), causal,
        bias)
    for g, want, want32, name in zip(got, ref, ref32, ("dq", "dk", "dv")):
        g, want = g.float(), want.float()
        top = float(want.abs().max())
        assert bool(((g - want).abs() <= CUDA_BF16_OPS_RTOL * want.abs()
                     + CUDA_BF16_OPS_REL_ATOL * top).all()), name
        err32 = float((g - want32).abs().max())
        assert err32 <= BF16_VS_F32_REL_TOL * float(want32.abs().max()), \
            (name, err32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_kernels_match_plain(cuda_device, dtype):
    for shape in ((1, 256, 16, 64), (2, 77, 4, 128), (1, 100, 2, 32)):
        q, k, v, dout = (torch.from_numpy(a).to(cuda_device, dtype)
                         for a in _qkv(shape, seed=shape[1])
                         + _qkv(shape, seed=1)[:1])
        _check_cuda_backward(q, k, v, dout, causal=True)


# ---------------------------------------------------------------------------
# attention over every key (#4: attention._flash_fwd_kernel), and causal
# through the same entry
# ---------------------------------------------------------------------------
def _bhld(*arrays):
    return [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in arrays]


def _pallas_flash_fwd(q, k, v, causal, block):
    """The reference's `_flash_fwd_kernel`, launched with
    `_flash_fwd_pallas`'s specs, in interpret mode. q/k/v: [b, h, L, d]
    numpy f32."""
    b, h, L, d = q.shape
    r3 = lambda a: a.reshape(b * h, L, d)
    with jax.enable_x64(False):
        out = pl.pallas_call(
            functools.partial(jatt._flash_fwd_kernel, block_k=block,
                              causal=causal, sm_scale=1.0 / math.sqrt(d),
                              seq_len=L),
            grid=(b * h, L // block),
            in_specs=[pl.BlockSpec((1, block, d), lambda i, j: (i, j, 0)),
                      pl.BlockSpec((1, L, d), lambda i, j: (i, 0, 0)),
                      pl.BlockSpec((1, L, d), lambda i, j: (i, 0, 0))],
            out_specs=pl.BlockSpec((1, block, d), lambda i, j: (i, j, 0)),
            out_shape=jax.ShapeDtypeStruct((b * h, L, d), jnp.float32),
            interpret=True)(r3(q), r3(k), r3(v))
    return np.asarray(out).reshape(b, h, L, d)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_attention_matches_flash_fwd_kernel_in_interpret_mode(causal,
                                                                    d):
    q, k, v = _bhld(*_qkv((2, 128, 2, d), seed=d + causal))
    ref = _pallas_flash_fwd(q, k, v, causal, block=64)
    got = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal).numpy()
    np.testing.assert_allclose(got, ref, atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,L,H,d", [(1, 200, 2, 32), (2, 77, 3, 16)])
def test_ragged_length_matches_reference_flash_attention(causal, b, L, H, d):
    """Lengths the Pallas kernel's L % 256 gate refused; off the TPU the
    reference's `flash_attention` runs the blockwise recurrence."""
    q, k, v = _bhld(*_qkv((b, L, H, d), seed=L + causal))
    ref = np.asarray(jatt.flash_attention(q, k, v, causal))
    got = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal).numpy()
    np.testing.assert_allclose(got, ref, atol=OUT_TOL, rtol=0)


def test_full_forward_lse_is_the_log_sum_exp_over_every_key():
    q, k, v = _qkv((2, 70, 3, 16), seed=3)
    _, lse = tflash.flash_attention_full(*(torch.from_numpy(a)
                                           for a in (q, k, v)))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(16)
    m = s.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,L,H,d", [(1, 128, 2, 64), (2, 200, 2, 32)])
def test_full_backward_matches_vjp_of_reference_flash_attention(causal, b, L,
                                                                H, d):
    q, k, v = _qkv((b, L, H, d), seed=L + 2)
    dout = _qkv((b, L, H, d), seed=4)[0]
    _, vjp = jax.vjp(lambda *a: jatt.flash_attention(*a, causal),
                     *_bhld(q, k, v))
    ref = [np.asarray(g).transpose(0, 2, 1, 3)
           for g in vjp(_bhld(dout)[0])]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = tflash._flash_reference(tq, tk, tv, causal)
    grads = tflash._flash_bwd_reference(tq, tk, tv, out, lse, tdo, causal)
    for got, want, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL, rtol=0,
                                   err_msg=name)


def test_gradients_of_full_attention_through_strided_views():
    """Autograd through the full-mode Function with q/k/v as views of one
    [b, L, 3·H·d] projection (BERT's layout), against autograd of
    `xla_attention`."""
    rng = np.random.RandomState(9)
    base = rng.randn(2, 40, 3 * 4 * 16).astype(np.float32)
    g = torch.from_numpy(rng.randn(2, 40, 4, 16).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: tflash.flash_attention_full(q, k, v)[0],
               lambda q, k, v: tatt.xla_attention(q, k, v, layout="blhd")):
        qkv = torch.from_numpy(base).requires_grad_()
        q, k, v = (t.view(2, 40, 4, 16) for t in qkv.split(64, dim=-1))
        grads.append(torch.autograd.grad(fn(q, k, v), qkv, g)[0])
    torch.testing.assert_close(grads[0], grads[1], atol=GRAD_TOL, rtol=0)


def _key_bias(b, L, seed):
    """BERT's padding bias for random valid lengths (at least one key per
    sequence): 0 on the kept keys, -1e9 on the padded ones, f32 [b, L]."""
    lengths = np.random.RandomState(seed).randint(1, L + 1, b)
    keep = np.arange(L)[None, :] < lengths[:, None]
    return np.where(keep, 0.0, -1e9).astype(np.float32)


@pytest.mark.parametrize("b,L,H,d", [(2, 77, 3, 32), (2, 128, 4, 64)])
def test_key_bias_forward_matches_blockwise_attention(b, L, H, d):
    """The plain forward with a key bias against the reference's
    `blockwise_attention` with the same bias as [b, 1, 1, L] (f32; the
    blockwise recurrence sums in another order)."""
    q, k, v = _qkv((b, L, H, d), seed=L + 5)
    bias = _key_bias(b, L, seed=L)
    ref = np.asarray(jatt.blockwise_attention(
        *_bhld(q, k, v), causal=False, bias=bias[:, None, None, :]))
    out, lse = tflash._flash_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=False,
        key_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1, 3), ref,
                               atol=OUT_TOL, rtol=0)
    # the lse of the kept keys alone: the padded ones add exp(-1e9) = 0
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(d)
    s = np.where(bias[:, None, None, :] < 0, -np.inf, s)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("b,L,H,d", [(2, 77, 3, 32), (2, 128, 4, 64)])
def test_key_bias_backward_matches_vjp_of_blockwise_attention(b, L, H, d):
    q, k, v = _qkv((b, L, H, d), seed=L + 6)
    dout = _qkv((b, L, H, d), seed=7)[0]
    bias = _key_bias(b, L, seed=L + 1)
    _, vjp = jax.vjp(lambda *a: jatt.blockwise_attention(
        *a, causal=False, bias=bias[:, None, None, :]), *_bhld(q, k, v))
    ref = [np.asarray(g).transpose(0, 2, 1, 3)
           for g in vjp(_bhld(dout)[0])]
    tq, tk, tv, tdo, tb = (torch.from_numpy(a)
                           for a in (q, k, v, dout, bias))
    out, lse = tflash._flash_reference(tq, tk, tv, False, tb)
    grads = tflash._flash_bwd_reference(tq, tk, tv, out, lse, tdo, False, tb)
    for got, want, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL, rtol=0,
                                   err_msg=name)


def test_key_bias_gradients_through_the_function_match_xla_attention():
    """Autograd through the full-mode Function with a key bias (on the
    CPU: the plain versions) against autograd of `xla_attention` with the
    bias as [b, 1, 1, L]; the bias itself gets no gradient."""
    rng = np.random.RandomState(10)
    q, k, v = _qkv((2, 50, 2, 16), seed=11)
    g = torch.from_numpy(rng.randn(2, 50, 2, 16).astype(np.float32))
    bias = torch.from_numpy(_key_bias(2, 50, seed=12))
    grads = []
    for fn in (lambda *a: tflash.flash_attention_full(*a, key_bias=bias)[0],
               lambda *a: tatt.xla_attention(*a, bias=bias[:, None, None, :],
                                             layout="blhd")):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=GRAD_TOL, rtol=0)


def test_key_bias_that_requires_grad_raises():
    q = torch.zeros(1, 4, 1, 8)
    bias = torch.zeros(1, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tflash.flash_attention_full(q, q, q, key_bias=bias)


def test_key_bias_reaches_the_full_kernels_off_the_cpu():
    q = torch.empty(2, 16, 2, 64, device="meta")
    lse = torch.empty(2, 2, 16, device="meta")
    bias = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention_full(q, q, q, key_bias=bias)
    for fn, last in ((tflash.flash_bwd_dq_full, q),
                     (tflash.flash_bwd_dkv_full, lse)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, q, lse, last, key_bias=bias)


@pytest.mark.parametrize("row_stride", [3 * 2 * 64 + 4, 2 * 64 + 1])
def test_bf16_rows_off_16_bytes_raise(row_stride):
    """The bf16 forward copies rows with 16-byte cp.async: a row stride
    that is not a multiple of 8 bf16 elements raises before any launch
    (meta tensors stand in for the card's)."""
    base = torch.empty(2, 16, row_stride, device="meta", dtype=torch.bfloat16)
    q = base[..., :128].view(2, 16, 2, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        tflash.flash_attention_blhd(q, q, q)
    with pytest.raises(ValueError, match="16 bytes"):
        tflash.flash_attention_full(q, q, q)


def test_f32_rows_need_no_alignment():
    """The f32 forward is the scalar kernel, which reads any row stride."""
    base = torch.empty(2, 16, 2 * 64 + 1, device="meta")
    q = base[..., :128].view(2, 16, 2, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention_blhd(q, q, q)


@pytest.mark.parametrize("fn", ["flash_bwd_dq_full", "flash_bwd_dkv_full"])
def test_full_backward_kernels_on_other_devices_raise(fn):
    q = torch.empty(1, 4, 2, 64, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    last = q if fn == "flash_bwd_dq_full" else lse  # out, or delta
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tflash, fn)(q, q, q, q, lse, last)


def test_cpu_full_attention_launches_no_kernel():
    counters = (tflash.flash_attention_full, tflash.flash_bwd_dq_full,
                tflash.flash_bwd_dkv_full)
    before = [f.launches for f in counters]
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv((1, 16, 2, 8), seed=0))
    tflash.flash_attention_full(q, k, v)[0].sum().backward()
    assert q.grad is not None
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# the packed dK/dV experiment (#8)
# ---------------------------------------------------------------------------
# bf16 on both sides with the same roundings; the sums run in another
# order, so a rounded P or dS element can flip one bf16 ulp, and the
# outputs are rounded to bf16 once: 2^-6 of each tensor's largest value
PACKED_REL_TOL = 2.0 ** -6


def _reference_dkv_module():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "experiments",
        "dkv_packed_kernel.py")
    spec = importlib.util.spec_from_file_location("_ref_dkv_packed", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _packed_inputs(b, H, L, d, seed):
    """bf16 q/k/v/dO [b, H, L, d] (as numpy f32 holding bf16 values) and
    the f32 lse/delta of plain causal attention over them."""
    rng = np.random.RandomState(seed)
    mk = lambda: np.asarray(jnp.asarray(rng.randn(b, H, L, d) * 0.2,
                                        jnp.bfloat16), np.float32)
    q, k, v, do = mk(), mk(), mk(), mk()
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    s = np.where(np.tril(np.ones((L, L), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    out = np.einsum("bhqk,bhkd->bhqd", np.exp(s - lse[..., None]), v)
    delta = np.einsum("bhqd,bhqd->bhq", do, out)
    return q, k, v, do, lse.astype(np.float32), delta.astype(np.float32)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_packed_dkv_matches_dkv_kernel_in_interpret_mode(d):
    """At d = 32 and 128 the reference's bf16(q·scale) rounds (at d = 64
    the scale is 2^-3 and it is exact): the plain version rounds there
    too."""
    ref_mod = _reference_dkv_module()
    b, H, L, blk = 1, 2, 128, 64
    q, k, v, do, lse, delta = _packed_inputs(b, H, L, d, seed=0)
    bh = b * H
    rs = lambda t: jnp.asarray(t.reshape(bh, L, d), jnp.bfloat16)
    st = lambda t: jnp.asarray(t.reshape(bh, 1, L))
    with jax.enable_x64(False):
        packed = pl.pallas_call(
            functools.partial(ref_mod.dkv_kernel, bq=blk, bk=blk, nq=L // blk,
                              d=d, scale=1.0 / np.sqrt(d)),
            grid=(bh, L // blk),
            in_specs=[pl.BlockSpec((1, L, d), lambda i, j: (i, 0, 0)),
                      pl.BlockSpec((1, blk, d), lambda i, j: (i, j, 0)),
                      pl.BlockSpec((1, blk, d), lambda i, j: (i, j, 0)),
                      pl.BlockSpec((1, L, d), lambda i, j: (i, 0, 0)),
                      pl.BlockSpec((1, 1, L), lambda i, j: (i, 0, 0)),
                      pl.BlockSpec((1, 1, L), lambda i, j: (i, 0, 0))],
            out_specs=pl.BlockSpec((1, blk, 2 * d), lambda i, j: (i, j, 0)),
            out_shape=jax.ShapeDtypeStruct((bh, L, 2 * d), jnp.bfloat16),
            interpret=True)(rs(q), rs(k), rs(v), rs(do), st(lse), st(delta))
    packed = np.asarray(packed, np.float32).reshape(b, H, L, 2 * d)
    ref_dv, ref_dk = packed[..., :d], packed[..., d:]
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    dk, dv = tdkv.dkv_call(tb(q), tb(k), tb(v), tb(do),
                           torch.from_numpy(lse), torch.from_numpy(delta))
    assert dk.dtype == dv.dtype == torch.bfloat16
    for got, want, name in ((dk, ref_dk, "dk"), (dv, ref_dv, "dv")):
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= PACKED_REL_TOL * float(np.abs(want).max()), (name, err)


def test_packed_dkv_plain_version_is_the_causal_gradient():
    """Against the f32 causal backward of `flash_tpu` on the same bf16
    inputs: only the bf16 roundings differ."""
    b, H, L, d = 2, 2, 96, 32
    q, k, v, do, lse, delta = _packed_inputs(b, H, L, d, seed=1)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    dk, dv = tdkv.dkv_call(tb(q), tb(k), tb(v), tb(do),
                           torch.from_numpy(lse), torch.from_numpy(delta))
    tl = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3)))
    out, lse_t = tflash._flash_reference(tl(q), tl(k), tl(v))
    _, ref_dk, ref_dv = tflash._flash_bwd_reference(tl(q), tl(k), tl(v), out,
                                                    lse_t, tl(do))
    for got, want in ((dk, ref_dk), (dv, ref_dv)):
        want = want.transpose(1, 2).numpy()
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= PACKED_REL_TOL * float(np.abs(want).max())


def test_packed_dkv_main_runs_on_the_cpu_at_a_small_size():
    before = tdkv.dkv_call.launches
    res = tdkv.main(device="cpu", b=1, H=2, L=64, d=32)
    assert res["ms"] is None  # no device time from a CPU run
    assert res["err_dk"] <= PACKED_REL_TOL * res["scale_dk"]
    assert res["err_dv"] <= PACKED_REL_TOL * res["scale_dv"]
    assert tdkv.dkv_call.launches == before


def test_packed_dkv_on_other_devices_raises():
    q = torch.empty(1, 2, 4, 64, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdkv.dkv_call(q, q, q, q, lse, lse)


def test_packed_dkv_refuses_more_batch_heads_than_its_grid_takes():
    """b·H rides on the grid's y axis (at most 65535): more raises before
    any launch, on any device."""
    q = torch.empty(257, 256, 1, 32, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(257, 256, 1, device="meta")
    before = tdkv.dkv_call.launches
    with pytest.raises(ValueError, match="65535 batch-heads"):
        tdkv.dkv_call(q, q, q, q, lse, lse)
    assert tdkv.dkv_call.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_full_kernels_match_plain(cuda_device, dtype, tol):
    for shape in ((2, 128, 12, 64), (2, 77, 4, 128), (1, 200, 2, 32)):
        q, k, v, dout = (torch.from_numpy(a).to(cuda_device, dtype)
                         for a in _qkv(shape, seed=shape[1])
                         + _qkv(shape, seed=1)[:1])
        out, lse = tflash.flash_attention_full(q, k, v)
        ref_out, ref_lse = tflash._flash_reference(q, k, v, causal=False)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        _check_cuda_backward(q, k, v, dout, causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("b,H,L,d", [(2, 4, 200, 64), (2, 4, 256, 32),
                                     (2, 4, 256, 128), (1, 3, 77, 32),
                                     (1, 3, 333, 128)])
def test_cuda_packed_dkv_matches_plain(cuda_device, b, H, L, d):
    """The tensor-core kernel against its plain version at every head
    dim, ragged L among them; two calls give the same bits, and at d = 64
    those of the causal dK/dV kernel."""
    q, k, v, do, lse, delta = _packed_inputs(b, H, L, d, seed=2)
    tb = lambda a: torch.from_numpy(a).to(cuda_device, torch.bfloat16)
    tf = lambda a: torch.from_numpy(a).to(cuda_device)
    args = (tb(q), tb(k), tb(v), tb(do), tf(lse), tf(delta))
    before = tdkv.dkv_call.launches
    dk, dv = tdkv.dkv_call(*args)
    dk2, dv2 = tdkv.dkv_call(*args)
    torch.cuda.synchronize()
    assert tdkv.dkv_call.launches == before + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    ref = tdkv._dkv_packed_reference(*args)
    for got, want in zip((dk, dv), ref):
        err = float((got.float() - want.float()).abs().max())
        assert err <= PACKED_REL_TOL * float(want.float().abs().max())
    if d == 64:  # bf16(q·2^-3) is exact: the causal dK/dV kernel's bits
        blhd = lambda t: t.transpose(1, 2).contiguous()
        dk3, dv3 = tflash.flash_bwd_dkv(*(blhd(t) for t in args[:4]),
                                        *args[4:])
        assert torch.equal(dk, dk3.transpose(1, 2))
        assert torch.equal(dv, dv3.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_cuda_packed_dkv_raises_on_a_misaligned_operand(cuda_device, name):
    """q, k, v and dO are copied with 16-byte cp.async: a contiguous
    view that starts off a 16-byte boundary raises before any launch."""
    shape, n = (1, 2, 16, 64), 2 * 16 * 64
    ops = {key: torch.zeros(shape, device=cuda_device, dtype=torch.bfloat16)
           for key in ("q", "k", "v", "dout")}
    base = torch.zeros(n + 8, device=cuda_device, dtype=torch.bfloat16)
    ops[name] = base[1:n + 1].view(shape)  # 2 bytes past the boundary
    lse = torch.zeros(shape[:3], device=cuda_device)
    before = tdkv.dkv_call.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        tdkv.dkv_call(ops["q"], ops["k"], ops["v"], ops["dout"], lse, lse)
    assert tdkv.dkv_call.launches == before


# bf16 tensor-core forward against the plain version: P is rounded to bf16
# as the P·V operand (at most 2^-9 relative per element, so at most
# 2^-9·max|v| on a row, a sum of roundings of both signs in practice) and
# the output is rounded once on each side (2^-9 relative): 1e-2 + 1e-2·|ref|
BF16_OUT_TOL = 1e-2


def _cuda_bf16_operands(shape, seed, fused_qkv):
    """bf16 q, k, v on the card; with ``fused_qkv`` the [b, L, H, d] views
    of one [b, L, 3·H·d] projection, as GPT and BERT pass them."""
    b, L, H, d = shape
    if not fused_qkv:
        return [torch.from_numpy(a).to("cuda", torch.bfloat16)
                for a in _qkv(shape, seed)]
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, L, 3 * H * d).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    return [t.view(shape) for t in qkv.split(H * d, dim=-1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,fused_qkv,biased", [
    ((8, 1024, 16, 64), True, True, False),    # GPT-2 345M training
    ((32, 128, 12, 64), False, True, False),   # BERT-base
    ((32, 128, 12, 64), False, True, True),    # BERT-base, padded batch
    ((4, 200, 12, 64), False, False, True),    # ragged L, padded
    ((2, 77, 4, 128), False, False, True),
    ((2, 77, 4, 128), True, False, False),
    ((1, 100, 2, 32), True, False, False)])
def test_cuda_bf16_forward_matches_plain(cuda_device, shape, causal,
                                         fused_qkv, biased):
    q, k, v = _cuda_bf16_operands(shape, shape[1], fused_qkv)
    bias = (torch.from_numpy(_key_bias(shape[0], shape[1], seed=3))
            .to(cuda_device) if biased else None)
    counter = (tflash.flash_attention_blhd if causal
               else tflash.flash_attention_full)
    before = counter.launches
    if causal:
        out, lse = tflash.flash_attention_blhd(q, k, v)
    else:
        out, lse = tflash.flash_attention_full(q, k, v, key_bias=bias)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref_out, ref_lse = tflash._flash_reference(q, k, v, causal, bias)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=BF16_OUT_TOL, rtol=BF16_OUT_TOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_key_bias_backward_kernels_match_plain(cuda_device, dtype, tol):
    for shape in ((2, 128, 12, 64), (2, 77, 4, 128), (1, 200, 2, 32)):
        q, k, v, dout = (torch.from_numpy(a).to(cuda_device, dtype)
                         for a in _qkv(shape, seed=shape[1])
                         + _qkv(shape, seed=1)[:1])
        bias = torch.from_numpy(_key_bias(shape[0], shape[1], seed=4)).to(
            cuda_device)
        out, lse = tflash.flash_attention_full(q, k, v, key_bias=bias)
        ref_out, _ = tflash._flash_reference(q, k, v, False, bias)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                                   rtol=tol)
        _check_cuda_backward(q, k, v, dout, causal=False, bias=bias)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((8, 1024, 16, 64), True),    # GPT-2 345M training
    ((32, 128, 12, 64), False)])  # BERT-base
def test_cuda_bf16_backward_on_fused_qkv_views(cuda_device, shape, causal):
    """The bf16 backward kernels on q/k/v as the views of one fused QKV
    projection (row strides 3072 and 2304), as the models pass them."""
    q, k, v = _cuda_bf16_operands(shape, shape[1], fused_qkv=True)
    dout = torch.from_numpy(_qkv(shape, seed=2)[0]).to(cuda_device,
                                                       torch.bfloat16)
    _check_cuda_backward(q, k, v, dout, causal)


@pytest.mark.cuda
def test_cuda_bf16_backward_raises_on_misaligned_out(cuda_device):
    """out and dout are copied with 16-byte cp.async too: a view that
    starts off a 16-byte boundary raises before any launch."""
    q = torch.zeros(2, 16, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(2, 2, 16, device=cuda_device)
    base = torch.zeros(2, 16, 2 * 64 + 8, device=cuda_device,
                       dtype=torch.bfloat16)
    out = base[..., 1:129].view(2, 16, 2, 64)
    before = tflash.flash_bwd_dq.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        tflash.flash_bwd_dq(q, q, q, q, lse, out)
    assert tflash.flash_bwd_dq.launches == before


@pytest.mark.cuda
def test_cuda_bf16_misaligned_view_raises(cuda_device):
    """A bf16 q/k/v view that starts off a 16-byte boundary raises; it is
    never copied or sent to another kernel."""
    base = torch.zeros(2, 16, 3 * 128 + 8, device=cuda_device,
                       dtype=torch.bfloat16)
    q = base[..., 1:129].view(2, 16, 2, 64)  # 2 bytes past the boundary
    before = tflash.flash_attention_full.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        tflash.flash_attention_full(q, q, q)
    assert tflash.flash_attention_full.launches == before
