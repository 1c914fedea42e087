"""The port's pooling (paddle_tpu_torch.nn.functional.pooling,
nn.layer.pooling) against the reference's: max and average pooling in
1-3 dimensions with every padding form, ceil_mode, exclusive and NHWC,
return_mask, and the adaptive pools with uneven bins; gradients against
`jax.vjp` on tie-free inputs (seeded normal draws), and the max-pool
after a ReLU, whose ties at 0 route the gradient differently on the two
sides and still give the same input gradient.

Tolerance (f32): max |port - ref| <= 1e-5 * max(1, max |ref|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor, no_grad
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
import torch_threads  # noqa: F401  (one torch thread a worker)

JF = paddle.nn.functional
TOL = 1e-5


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _check(ref_fn, port_fn, x):
    def pure(raw):
        with no_grad():
            return ref_fn(Tensor(raw))._value

    out, vjp = jax.vjp(pure, jnp.asarray(x))
    ct = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    (gx,) = vjp(jnp.asarray(ct))
    t = torch.tensor(x, requires_grad=True)
    got = port_fn(t)
    got.backward(torch.from_numpy(ct))
    _close(got, out)
    _close(t.grad, gx)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


POOL2D_CASES = [
    # (kernel, stride, padding, ceil_mode, data_format)
    (2, 2, 0, False, "NCHW"),
    (3, 2, 1, False, "NCHW"),
    (3, 1, 1, False, "NCHW"),
    (3, 2, 0, True, "NCHW"),
    (3, 2, 1, True, "NCHW"),
    ((3, 2), (2, 1), (1, 0), False, "NCHW"),
    (3, 2, [(1, 0), (0, 2)], False, "NCHW"),
    (3, 2, "SAME", False, "NCHW"),
    (3, 3, "VALID", False, "NCHW"),
    (2, None, 0, False, "NCHW"),
    (3, 2, 1, False, "NHWC"),
    (4, 2, 3, False, "NCHW"),
]


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("kernel,stride,padding,ceil_mode,fmt",
                         POOL2D_CASES)
def test_pool2d_matches_reference(op, kernel, stride, padding, ceil_mode,
                                  fmt):
    shape = (2, 3, 9, 10) if fmt == "NCHW" else (2, 9, 10, 3)
    kw = dict(kernel_size=kernel, stride=stride, padding=padding,
              ceil_mode=ceil_mode, data_format=fmt)
    name = f"{op}_pool2d"
    _check(lambda a: getattr(JF, name)(a, **kw),
           lambda a: getattr(TF, name)(a, **kw), _x(shape))


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("padding,ceil_mode", [(1, False), (0, True),
                                               ("SAME", False)])
def test_avg_pool2d_exclusive_matches_reference(exclusive, padding,
                                                ceil_mode):
    kw = dict(kernel_size=3, stride=2, padding=padding, ceil_mode=ceil_mode,
              exclusive=exclusive)
    _check(lambda a: JF.avg_pool2d(a, **kw),
           lambda a: TF.avg_pool2d(a, **kw), _x((2, 3, 8, 9), 1))


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("n,padding,ceil_mode,fmt", [
    (1, 1, False, "NCL"), (1, 0, True, "NCL"), (1, "SAME", False, "NCL"),
    (1, 1, False, "NLC"), (3, 1, False, "NCDHW"), (3, 0, True, "NCDHW"),
    (3, 1, False, "NDHWC")])
def test_pool1d_3d_match_reference(op, n, padding, ceil_mode, fmt):
    spatial = (9,) if n == 1 else (5, 6, 7)
    shape = ((2, 3) + spatial if fmt.startswith("NC")
             else (2,) + spatial + (3,))
    kw = dict(kernel_size=3, stride=2, padding=padding, ceil_mode=ceil_mode,
              data_format=fmt)
    name = f"{op}_pool{n}d"
    _check(lambda a: getattr(JF, name)(a, **kw),
           lambda a: getattr(TF, name)(a, **kw), _x(shape, 2))


@pytest.mark.parametrize("kernel,stride,padding", [(2, 2, 0), (3, 2, 1),
                                                   (3, 1, 1)])
def test_max_pool2d_mask_matches_reference(kernel, stride, padding):
    x = _x((2, 3, 8, 9), 3)
    out, mask = TF.max_pool2d(torch.from_numpy(x), kernel, stride, padding,
                              return_mask=True)
    rout, rmask = JF.max_pool2d(paddle.to_tensor(x), kernel, stride, padding,
                                return_mask=True)
    _close(out, rout.numpy())
    assert mask.dtype == torch.int64
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask.numpy()))


@pytest.mark.parametrize("n,padding,ceil_mode", [(1, [2, 0], False),
                                                 (2, [(2, 0), (0, 1)], True),
                                                 (3, 1, False)])
def test_max_pool_mask_points_at_the_maximum(n, padding, ceil_mode):
    """return_mask in every dimension, also where the padding is explicit:
    each flat index picks its window's maximum out of the input."""
    x = torch.from_numpy(_x((2, 3) + (7, 8, 6)[:n], 4))
    out, mask = getattr(TF, f"max_pool{n}d")(
        x, 3, 2, padding, return_mask=True, ceil_mode=ceil_mode)
    picked = x.flatten(2).gather(2, mask.flatten(2)).reshape(out.shape)
    assert torch.equal(picked, out)


def test_max_pool_after_relu_routes_ties_harmlessly():
    """ReLU then max pool, as ResNet's stem: an all-zero window ties at 0,
    XLA and torch may route its gradient to different winners, but every
    candidate has ReLU gradient 0, so the input gradient is the same."""
    x = _x((2, 4, 10, 10), 5) - 1.0  # most windows all negative
    _check(lambda a: JF.max_pool2d(JF.relu(a), 3, 2, 1),
           lambda a: TF.max_pool2d(TF.relu(a), 3, 2, 1), x)


@pytest.mark.parametrize("op", ["avg", "max"])
@pytest.mark.parametrize("n,size", [(1, 4), (1, 5), (2, (3, 4)), (2, 1),
                                    (2, (None, 2)), (3, (2, 3, 2))])
def test_adaptive_pool_matches_reference(op, n, size):
    """Bins [floor(b*in/out), ceil((b+1)*in/out)): uneven and overlapping
    at these sizes."""
    x = _x((2, 3) + (7, 10, 5)[:n], 6)
    name = f"adaptive_{op}_pool{n}d"
    _check(lambda a: getattr(JF, name)(a, size),
           lambda a: getattr(TF, name)(a, size), x)


def test_adaptive_avg_pool2d_nhwc_matches_reference():
    x = _x((2, 7, 10, 3), 7)
    _check(lambda a: JF.adaptive_avg_pool2d(a, (3, 4), data_format="NHWC"),
           lambda a: TF.adaptive_avg_pool2d(a, (3, 4), data_format="NHWC"),
           x)


@pytest.mark.parametrize("layer,args,kw", [
    ("MaxPool2D", (3, 2, 1), {}),
    ("AvgPool2D", (3, 2, 1), {"exclusive": False}),
    ("MaxPool1D", (2, 2), {}),
    ("AvgPool3D", (2, 2), {}),
    ("AdaptiveAvgPool2D", ((1, 1),), {}),
    ("AdaptiveMaxPool1D", (3,), {}),
])
def test_pool_layers_match_reference(layer, args, kw):
    n = int(layer[-2])
    x = _x((2, 3) + (8, 9, 6)[:n], 8)
    ref = getattr(paddle.nn, layer)(*args, **kw)(paddle.to_tensor(x))
    _close(getattr(tnn, layer)(*args, **kw)(torch.from_numpy(x)),
           ref.numpy())
