"""The port's activations (paddle_tpu_torch.nn.functional.activation,
nn.layer.activation) and containers (nn.layer.container) against the
reference's: every deterministic activation and its gradient against
`jax.vjp` on the same seeded inputs, ReLU's gradient at 0 (0 on both
sides: the max-pool tie rule leans on it), the in-place forms, the
generator-drawn ones, and the containers' child names.

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

CASES = [
    ("relu", {}), ("relu6", {}), ("elu", {"alpha": 0.7}), ("selu", {}),
    ("celu", {"alpha": 1.3}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("sigmoid", {}), ("hardsigmoid", {}), ("hardswish", {}),
    ("hardtanh", {"min": -0.5, "max": 0.8}), ("hardshrink", {}),
    ("leaky_relu", {"negative_slope": 0.1}), ("log_sigmoid", {}),
    ("log_softmax", {"axis": 1}), ("maxout", {"groups": 2}), ("mish", {}),
    ("silu", {}), ("swish", {}), ("softmax", {}), ("softmax", {"axis": 1}),
    ("softplus", {"beta": 2, "threshold": 3}), ("softshrink", {}),
    ("softsign", {}), ("tanh", {}), ("tanhshrink", {}),
    ("thresholded_relu", {"threshold": 0.5}), ("glu", {"axis": 1}),
]


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _x(seed=0):
    return (np.random.RandomState(seed).randn(3, 4, 5) * 3).astype(
        np.float32)


@pytest.mark.parametrize("name,kw", CASES)
def test_activation_and_gradient_match_reference(name, kw):
    x = _x()

    def pure(a):
        with no_grad():
            return getattr(JF, name)(Tensor(a), **kw)._value

    out, vjp = jax.vjp(pure, jnp.asarray(x))
    ct = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    (gx,) = vjp(jnp.asarray(ct))
    t = torch.tensor(x, requires_grad=True)
    got = getattr(TF, name)(t, **kw)
    got.backward(torch.from_numpy(ct))
    _close(got, out)
    _close(t.grad, gx)


@pytest.mark.parametrize("data_format,n", [("NCHW", 1), ("NCHW", 4),
                                           ("NHWC", 5)])
def test_prelu_matches_reference(data_format, n):
    x = np.random.RandomState(1).randn(2, 4, 3, 5).astype(np.float32)
    w = np.linspace(0.1, 0.5, n).astype(np.float32)
    ref = JF.prelu(paddle.to_tensor(x), paddle.to_tensor(w), data_format)
    _close(TF.prelu(torch.from_numpy(x), torch.from_numpy(w), data_format),
           ref.numpy())


def test_relu_gradient_at_zero_is_zero_on_both_sides():
    x = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    gref = jax.grad(lambda a: jax.nn.relu(a).sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    TF.relu(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(gref))
    np.testing.assert_array_equal(t.grad.numpy(), [0.0, 0.0, 0.0, 1.0])


@pytest.mark.parametrize("name", ["relu_", "elu_", "tanh_", "softmax_"])
def test_in_place_forms_write_their_argument(name):
    x = torch.from_numpy(_x(2))
    want = getattr(TF, name.rstrip("_"))(x.clone())
    out = getattr(TF, name)(x)
    assert out.data_ptr() == x.data_ptr()
    torch.testing.assert_close(x, want, rtol=0, atol=1e-6)


def test_random_activations_draw_from_their_generator():
    x = torch.from_numpy(_x(3))
    g = lambda: torch.Generator().manual_seed(5)
    a = TF.rrelu(x, generator=g())
    assert torch.equal(a, TF.rrelu(x, generator=g()))
    neg = x < 0
    ratio = a[neg] / x[neg]
    assert float(ratio.min()) >= 0.125 and float(ratio.max()) <= 1 / 3
    assert torch.equal(TF.rrelu(x, training=False),
                       torch.where(x >= 0, x, x * (0.125 + 1 / 3) / 2))
    with pytest.raises(ValueError):
        TF.rrelu(x)
    y = TF.gumbel_softmax(x, hard=True, generator=g())
    assert torch.equal(y.sum(-1), torch.ones(3, 4))
    layer = tnn.RReLU(generator=g()).eval()
    assert torch.equal(layer(x), TF.rrelu(x, training=False))


@pytest.mark.parametrize("layer,args,fn,kw", [
    ("ReLU", (), "relu", {}), ("LeakyReLU", (0.2,), "leaky_relu",
                               {"negative_slope": 0.2}),
    ("Hardtanh", (-2.0, 2.0), "hardtanh", {"min": -2.0, "max": 2.0}),
    ("Softmax", (1,), "softmax", {"axis": 1}), ("GELU", (True,), "gelu",
                                               {"approximate": True}),
    ("Softplus", (), "softplus", {}), ("Maxout", (2, 1), "maxout",
                                       {"groups": 2, "axis": 1})])
def test_activation_layers_call_their_functional(layer, args, fn, kw):
    x = torch.from_numpy(_x(4))
    assert torch.equal(getattr(tnn, layer)(*args)(x),
                       getattr(TF, fn)(x, **kw))
    ref = getattr(paddle.nn, layer)(*args)(paddle.to_tensor(_x(4)))
    _close(getattr(tnn, layer)(*args)(x), ref.numpy())


def test_prelu_layer_starts_at_init():
    layer = tnn.PReLU(4, init=0.3)
    assert torch.equal(layer.weight.detach(), torch.full((4,), 0.3))


def test_containers_name_children_as_the_reference():
    paddle.seed(0)
    ref = paddle.nn.Sequential(paddle.nn.Linear(2, 3), paddle.nn.ReLU(),
                               paddle.nn.Linear(3, 1))
    port = tnn.Sequential(tnn.Linear(2, 3), tnn.ReLU(), tnn.Linear(3, 1))
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    named = tnn.Sequential(("a", tnn.ReLU()), ("b", tnn.Tanh()))
    assert list(dict(named.named_children())) == ["a", "b"]
    assert isinstance(port[1], tnn.ReLU) and len(port[1:]) == 2
    x = torch.from_numpy(_x(5)[0, :, :2].copy())
    assert torch.equal(named(x), torch.tanh(torch.relu(x)))
    layers = tnn.LayerList([tnn.ReLU()])
    layers.append(tnn.Tanh())
    layers.insert(0, tnn.Sigmoid())
    assert [type(m).__name__ for m in layers] == ["Sigmoid", "ReLU", "Tanh"]
    assert [n for n, _ in layers.named_children()] == ["0", "1", "2"]
    d = tnn.LayerDict({"x": tnn.ReLU()})
    d["y"] = tnn.Tanh()
    assert list(d.keys()) == ["x", "y"] and "y" in d
