"""Port LayerNorm (paddle_tpu_torch.ops.fused) against the reference:
the plain forward against the Pallas `_ln_kernel` run in interpret mode
and against `_ln_reference`; the plain backward against `_ln_bwd_kernel`
in interpret mode, against `jax.vjp` of `_ln_reference` and of the GPT
model's `_ln_manual`; the CUDA kernels against the plain path on a card
(marked `cuda`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu.nn.functional.norm import _ln_manual
from paddle_tpu.ops import fused as jfused
from paddle_tpu_torch.ops import fused as tfused

TOL = 1e-5  # f32 on both sides; two-pass statistics, different sum order
# backward: dw/db are sums over every row (up to 512 terms of |g·x̂| ~ 3)
BWD_TOL = 2e-5
# against the model's one-pass (E[x²] − E[x]²) LayerNorm of the reference
MANUAL_TOL = 1e-4


def _pallas_ln(x, w, b, eps, block_rows):
    """The reference's own `_ln_kernel`, launched as `_fused_ln_fwd_impl`
    launches it, in interpret mode."""
    rows, hidden = x.shape
    with jax.enable_x64(False):
        return np.asarray(pl.pallas_call(
            functools.partial(jfused._ln_kernel, eps=eps),
            grid=(rows // block_rows,),
            in_specs=[pl.BlockSpec((block_rows, hidden), lambda i: (i, 0)),
                      pl.BlockSpec((hidden,), lambda i: (0,)),
                      pl.BlockSpec((hidden,), lambda i: (0,))],
            out_specs=pl.BlockSpec((block_rows, hidden), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((rows, hidden), jnp.float32),
            interpret=True)(x, w, b))


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    return x, w, b


def _port(x, w, b, eps=1e-5):
    return tfused.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), eps).numpy()


@pytest.mark.parametrize("rows,hidden,block_rows,eps", [
    (256, 128, 128, 1e-5), (512, 256, 256, 1e-5), (128, 384, 64, 1e-6),
    (64, 1024, 64, 1e-5)])
def test_matches_pallas_kernel_in_interpret_mode(rows, hidden, block_rows,
                                                 eps):
    x, w, b = _inputs((rows, hidden), seed=rows + hidden)
    ref = _pallas_ln(x, w, b, eps, block_rows)
    np.testing.assert_allclose(_port(x, w, b, eps), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(
        _port(x, w, b, eps),
        np.asarray(jfused._ln_reference(x, w, b, eps)), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 128), (3, 77), (2, 5, 96),
                                   (7, 1024), (1, 1, 4096)])
def test_ragged_rows_match_reference(shape):
    """Row counts the TPU kernel's gate refused (decode batches of 1-8)."""
    x, w, b = _inputs(shape, seed=sum(shape))
    ref = np.asarray(jfused._ln_reference(x, w, b, 1e-5))
    got = _port(x, w, b)
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_bf16_plain_path_rounds_once_from_f32():
    x, w, b = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((4, 256), seed=3))
    got = tfused.fused_layer_norm(x, w, b)
    assert got.dtype == torch.bfloat16
    exact = tfused._ln_reference(x.float(), w.float(), b.float())
    assert torch.equal(got, exact.to(torch.bfloat16))


def test_cpu_path_launches_no_kernel():
    before = tfused.fused_layer_norm.launches
    _port(*_inputs((2, 64), seed=0))
    assert tfused.fused_layer_norm.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.fused_layer_norm(x, w, w)


def _pallas_ln_bwd(x, w, g, eps, block_rows):
    """The reference's own `_ln_bwd_kernel`, launched as `_fused_ln_bwd`
    launches it, in interpret mode; returns (dx, dw, db)."""
    rows, hidden = x.shape
    row_spec = pl.BlockSpec((block_rows, hidden), lambda i: (i, 0))
    acc_spec = pl.BlockSpec((8, hidden), lambda i: (0, 0))
    with jax.enable_x64(False):
        dx, dw, db = pl.pallas_call(
            functools.partial(jfused._ln_bwd_kernel, eps=eps),
            grid=(rows // block_rows,),
            in_specs=[row_spec, pl.BlockSpec((hidden,), lambda i: (0,)),
                      row_spec],
            out_specs=[row_spec, acc_spec, acc_spec],
            out_shape=[jax.ShapeDtypeStruct((rows, hidden), jnp.float32),
                       jax.ShapeDtypeStruct((8, hidden), jnp.float32),
                       jax.ShapeDtypeStruct((8, hidden), jnp.float32)],
            interpret=True)(x, w, g)
    return np.asarray(dx), np.asarray(dw)[0], np.asarray(db)[0]


def _port_bwd(x, w, g, eps=1e-5):
    return [t.numpy() for t in tfused._ln_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), eps)]


def _jax_vjp(fn, x, w, b, g):
    _, vjp = jax.vjp(fn, x, w, b)
    return [np.asarray(t) for t in vjp(g)]


@pytest.mark.parametrize("rows,hidden,block_rows", [
    (512, 256, 256), (256, 128, 128)])
def test_backward_matches_pallas_kernel_in_interpret_mode(rows, hidden,
                                                          block_rows):
    x, w, _ = _inputs((rows, hidden), seed=rows)
    g = np.random.RandomState(hidden).randn(rows, hidden).astype(np.float32)
    ref = _pallas_ln_bwd(x, w, g, 1e-5, block_rows)
    for got, want, name in zip(_port_bwd(x, w, g), ref, ("dx", "dw", "db")):
        np.testing.assert_allclose(got, want, atol=BWD_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(1, 128), (3, 77), (2, 5, 96), (7, 1024)])
def test_backward_ragged_rows_match_vjp_of_reference(shape):
    """Row counts the TPU kernel's gate refused."""
    x, w, b = _inputs(shape, seed=sum(shape) + 1)
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    ref = _jax_vjp(lambda a, w_, b_: jfused._ln_reference(a, w_, b_, 1e-5),
                   x, w, b, g)
    for got, want, name in zip(_port_bwd(x, w, g), ref, ("dx", "dw", "db")):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=BWD_TOL, rtol=0,
                                   err_msg=name)


def _autograd(fn, x, w, b, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = fn(*ts)
    return [t.numpy() for t in torch.autograd.grad(y, ts,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("shape", [(2, 64, 128), (5, 256)])
def test_autograd_matches_vjp_of_the_models_manual_layer_norm(shape):
    """The GPT model's LayerNorm in the reference is `_ln_manual`
    (one-pass statistics, hand-written backward)."""
    x, w, b = _inputs(shape, seed=11)
    g = np.random.RandomState(4).randn(*shape).astype(np.float32)
    ref = _jax_vjp(lambda a, w_, b_: _ln_manual(a, w_, b_, 1e-5), x, w, b, g)
    got = _autograd(tfused.fused_layer_norm, x, w, b, g)
    for a, want, name in zip(got, ref, ("dx", "dw", "db")):
        np.testing.assert_allclose(a, want, atol=MANUAL_TOL, rtol=0,
                                   err_msg=name)


def test_cpu_backward_matches_autograd_of_the_plain_forward():
    x, w, b = _inputs((33, 96), seed=5)
    g = np.random.RandomState(6).randn(33, 96).astype(np.float32)
    got = _autograd(tfused.fused_layer_norm, x, w, b, g)
    ref = _autograd(tfused._ln_reference, x, w, b, g)
    for a, want in zip(got, ref):
        np.testing.assert_allclose(a, want, atol=TOL, rtol=0)


def test_cpu_backward_launches_no_kernel():
    before = tfused.layer_norm_bwd.launches
    x, w, b = _inputs((4, 32), seed=0)
    _autograd(tfused.fused_layer_norm, x, w, b, x)
    assert tfused.layer_norm_bwd.launches == before


def test_backward_on_other_devices_raises():
    x = torch.empty(2, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.layer_norm_bwd(x, w, x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol):
    for rows, hidden in ((1, 1024), (8, 768), (300, 1024)):
        x, w, b = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs((rows, hidden), seed=rows))
        before = tfused.fused_layer_norm.launches
        got = tfused.fused_layer_norm(x, w, b)
        torch.cuda.synchronize()
        assert tfused.fused_layer_norm.launches == before + 1
        ref = tfused._ln_reference(x, w, b)
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_backward_kernel_matches_plain(cuda_device, dtype, tol):
    for rows, hidden in ((1, 1024), (8, 768), (1000, 1024), (3, 4096)):
        x, w, _ = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs((rows, hidden), seed=rows))
        g = torch.randn(rows, hidden, device=cuda_device).to(dtype)
        before = tfused.layer_norm_bwd.launches
        got = tfused.layer_norm_bwd(x, w, g)
        torch.cuda.synchronize()
        assert tfused.layer_norm_bwd.launches == before + 2
        for a, ref in zip(got, tfused._ln_bwd_reference(x, w, g)):
            torch.testing.assert_close(a.float(), ref.float(), atol=tol,
                                       rtol=tol)
