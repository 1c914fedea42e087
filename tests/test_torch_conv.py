"""The port's convolutions (paddle_tpu_torch.nn.functional.conv,
nn.layer.conv) against the reference's: the same seeded numpy inputs
through both, the gradients of the input, weight and bias against
`jax.vjp`, over every padding form, stride, dilation, groups and NHWC, and
the transposed convolutions with output_padding and output_size.

Tolerance (f32): max |port - ref| <= 1e-5 * max(1, max |ref|) per tensor:
both sides sum f32 products in f32, in other orders (a weight gradient
sums over N*H*W positions)."""
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
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _ref_vjp(fn, *arrays):
    """(output, gradients) of the reference's ``fn`` on numpy arrays, with
    a seeded cotangent."""
    def pure(*raws):
        with no_grad():
            return fn(*[Tensor(r) for r in raws])._value

    out, vjp = jax.vjp(pure, *[jnp.asarray(a) for a in arrays])
    ct = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    return np.asarray(out), ct, vjp(jnp.asarray(ct))


def _port_vjp(fn, ct, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(ct))
    return out, [t.grad for t in ts]


def _check(ref_fn, port_fn, *arrays):
    out, ct, grads = _ref_vjp(ref_fn, *arrays)
    got, tgrads = _port_vjp(port_fn, ct, *arrays)
    _close(got, out)
    for g, r in zip(tgrads, grads):
        _close(g, r)


def _data(shape_x, shape_w, n_bias, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_x).astype(np.float32),
            rng.randn(*shape_w).astype(np.float32) * 0.3,
            rng.randn(n_bias).astype(np.float32))


CONV2D_CASES = [
    # (stride, padding, dilation, groups, data_format)
    (1, 0, 1, 1, "NCHW"),
    (1, 1, 1, 1, "NCHW"),
    (2, 3, 1, 1, "NCHW"),
    (1, [1, 2], 1, 1, "NCHW"),
    (2, [1, 2, 0, 1], 1, 1, "NCHW"),
    (1, [(1, 0), (0, 2)], 1, 1, "NCHW"),
    (1, "SAME", 1, 1, "NCHW"),
    (2, "SAME", 1, 1, "NCHW"),
    (3, "same", 2, 1, "NCHW"),
    (2, "VALID", 1, 1, "NCHW"),
    (1, 1, 2, 1, "NCHW"),
    (2, 1, 1, 2, "NCHW"),
    (1, 1, 1, 4, "NCHW"),
    (1, 1, 1, 1, "NHWC"),
    (2, "SAME", 1, 2, "NHWC"),
    ([2, 1], [1, 0], [1, 2], 1, "NCHW"),
]


@pytest.mark.parametrize("stride,padding,dilation,groups,fmt", CONV2D_CASES)
def test_conv2d_matches_reference(stride, padding, dilation, groups, fmt):
    cin, cout, k = 4, 8, 3
    shape_x = (2, cin, 9, 10) if fmt == "NCHW" else (2, 9, 10, cin)
    x, w, b = _data(shape_x, (cout, cin // groups, k, k), cout)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    _check(lambda a, ww, bb: JF.conv2d(a, ww, bb, **kw),
           lambda a, ww, bb: TF.conv2d(a, ww, bb, **kw), x, w, b)


@pytest.mark.parametrize("fmt,padding", [
    ("NCHW", [[0, 0], [0, 0], [2, 0], [1, 1]]),
    ("NHWC", [[0, 0], [2, 0], [1, 1], [0, 0]])])
def test_conv2d_pads_given_for_every_dimension(fmt, padding):
    """Pairs for the batch and channel dimensions too: the spatial pairs
    by the layout. (The reference's ``_norm_padding`` takes four pairs of
    a 2-D convolution for four ints and raises; it is held here against
    the spatial pairs it does take.)"""
    shape_x = (2, 4, 9, 10) if fmt == "NCHW" else (2, 9, 10, 4)
    x, w, b = _data(shape_x, (8, 4, 3, 3), 8)
    _check(lambda a, ww, bb: JF.conv2d(a, ww, bb, padding=[(2, 0), (1, 1)],
                                       data_format=fmt),
           lambda a, ww, bb: TF.conv2d(a, ww, bb, padding=padding,
                                       data_format=fmt), x, w, b)


@pytest.mark.parametrize("padding,fmt", [(1, "NCL"), ("SAME", "NCL"),
                                         ([2, 1], "NCL"), (1, "NLC")])
def test_conv1d_matches_reference(padding, fmt):
    shape_x = (2, 3, 11) if fmt == "NCL" else (2, 11, 3)
    x, w, b = _data(shape_x, (5, 3, 3), 5, seed=1)
    kw = dict(stride=2, padding=padding, data_format=fmt)
    _check(lambda a, ww, bb: JF.conv1d(a, ww, bb, **kw),
           lambda a, ww, bb: TF.conv1d(a, ww, bb, **kw), x, w, b)


@pytest.mark.parametrize("padding,fmt", [(1, "NCDHW"), ("SAME", "NCDHW"),
                                         (0, "NDHWC")])
def test_conv3d_matches_reference(padding, fmt):
    shape_x = (1, 2, 5, 6, 7) if fmt == "NCDHW" else (1, 5, 6, 7, 2)
    x, w, b = _data(shape_x, (4, 2, 3, 3, 3), 4, seed=2)
    kw = dict(stride=(1, 2, 1), padding=padding, data_format=fmt)
    _check(lambda a, ww, bb: JF.conv3d(a, ww, bb, **kw),
           lambda a, ww, bb: TF.conv3d(a, ww, bb, **kw), x, w, b)


TRANSPOSE_CASES = [
    # (n, stride, padding, output_padding, groups, dilation, output_size)
    (2, 1, 0, 0, 1, 1, None),
    (2, 2, 1, 0, 1, 1, None),
    (2, 2, 1, 1, 1, 1, None),
    (2, 3, [1, 2], [2, 1], 1, 1, None),
    (2, 2, [1, 0, 2, 1], 0, 1, 1, None),
    (2, 2, 1, 0, 2, 1, None),
    (2, 1, 1, 0, 1, 2, None),
    (2, 2, 1, 0, 1, 1, (9, 8)),
    (2, 2, "VALID", 0, 1, 1, None),
    (1, 2, 1, 1, 1, 1, None),
    (3, 2, 1, 0, 1, 1, None),
]


@pytest.mark.parametrize("n,stride,padding,out_pad,groups,dilation,size",
                         TRANSPOSE_CASES)
def test_conv_transpose_matches_reference(n, stride, padding, out_pad,
                                          groups, dilation, size):
    cin, cout = 4, 6
    spatial = (5, 6, 4)[:n]
    x, w, b = _data((2, cin) + spatial, (cin, cout // groups) + (3,) * n,
                    cout, seed=3)
    kw = dict(stride=stride, padding=padding, output_padding=out_pad,
              groups=groups, dilation=dilation)
    if size is not None:
        kw["output_size"] = size
    name = f"conv{n}d_transpose"
    _check(lambda a, ww, bb: getattr(JF, name)(a, ww, bb, **kw),
           lambda a, ww, bb: getattr(TF, name)(a, ww, bb, **kw), x, w, b)


def test_conv_transpose_refuses_same_padding():
    x = torch.zeros(1, 2, 4, 4)
    w = torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError):
        TF.conv2d_transpose(x, w, padding="SAME")


@pytest.mark.parametrize("layer,args,x_shape", [
    ("Conv1D", (3, 4, 3), (2, 3, 9)),
    ("Conv2D", (3, 4, 3), (2, 3, 7, 7)),
    ("Conv3D", (2, 4, 3), (1, 2, 5, 5, 5)),
    ("Conv2DTranspose", (3, 4, 3), (2, 3, 5, 5)),
])
def test_conv_layer_takes_the_reference_weights(layer, args, x_shape):
    """Weights cross over without a transpose ([out, in/groups, *k], or
    [in, out/groups, *k] transposed): the same output from the same
    weights."""
    paddle.seed(0)
    ref = getattr(paddle.nn, layer)(*args, stride=2, padding=1)
    port = getattr(tnn, layer)(*args, stride=2, padding=1)
    assert tuple(port.weight.shape) == tuple(ref.weight.shape)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight.numpy())))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias.numpy())))
    x = np.random.RandomState(4).randn(*x_shape).astype(np.float32)
    _close(port(torch.from_numpy(x)), ref(paddle.to_tensor(x)).numpy())


@pytest.mark.parametrize("groups", [1, 2])
def test_conv_layer_init_is_the_reference_uniform(groups):
    """Weight and bias within the reference's Uniform(-bound, bound),
    bound = 1/sqrt(in/groups * k*k), filling it; drawn from the
    generator, so one seed gives the same weights."""
    gen = lambda: torch.Generator().manual_seed(3)
    a = tnn.Conv2D(8, 16, 3, groups=groups, generator=gen())
    b = tnn.Conv2D(8, 16, 3, groups=groups, generator=gen())
    bound = 1.0 / np.sqrt(8 // groups * 9)
    for t in (a.weight.detach(), a.bias.detach()):
        assert float(t.abs().max()) <= bound
        assert float(t.abs().max()) > 0.9 * bound
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert tuple(a.weight.shape) == (16, 8 // groups, 3, 3)


def test_conv_layer_without_bias():
    conv = tnn.Conv2D(3, 4, 3, bias_attr=False)
    assert conv.bias is None
    assert [n for n, _ in conv.named_parameters()] == ["weight"]
    x = torch.randn(1, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.functional.conv2d(x, conv.weight)
    assert torch.equal(conv(x), ref)


def test_conv_layer_refuses_what_is_not_ported():
    """``padding_mode`` other than zeros is not ported; ``weight_attr`` is
    (a ``ParamAttr``, a name or an initializer), and what is none of them
    raises TypeError as in the reference's ``ParamAttr._to_attr``."""
    with pytest.raises(NotImplementedError):
        tnn.Conv2D(3, 4, 3, padding_mode="reflect")
    with pytest.raises(TypeError, match="ParamAttr"):
        tnn.Conv2D(3, 4, 3, weight_attr=object())
    with pytest.raises(TypeError, match="ParamAttr"):
        paddle.nn.Conv2D(3, 4, 3, weight_attr=object())
