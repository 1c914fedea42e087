"""Port LayerNorm (paddle_tpu_torch.ops.fused) against the reference:
the plain path against the Pallas `_ln_kernel` run in interpret mode and
against `_ln_reference`; the CUDA kernel against the plain path on a
card (marked `cuda`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu.ops import fused as jfused
from paddle_tpu_torch.ops import fused as tfused

TOL = 1e-5  # f32 on both sides; two-pass statistics, different sum order


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
