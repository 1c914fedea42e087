"""The port's other normalizations against the reference's, on the same
seeded numpy inputs, f32: `F.layer_norm` (through the LayerNorm kernel's
plain version where it has one weight axis), `instance_norm`,
`group_norm` and `local_response_norm`; the layers `GroupNorm`,
`InstanceNorm1D/2D/3D`, `LocalResponseNorm`, `SpectralNorm` and
`SyncBatchNorm`; `nn.utils`' `weight_norm` / `remove_weight_norm` /
`spectral_norm`; `PairwiseDistance` and `ParameterList`. Values and the
gradients of the inputs and parameters for one cotangent; the layers'
parameters carried across by name (`load_jax_params`)."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused
from torch_parity import assert_close, port_call, ref_call
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32; the statistics are summed in other orders (and the reference's
# one-axis LayerNorm is one-pass, the port's kernel two-pass: inputs are
# residual-like, |mean| of the order of the spread)
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _f32(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _functional_cases():
    """id -> (function, args maker(rng), kwargs, differentiable
    positions)."""
    return {
        "layer_norm_one_axis": ("layer_norm", lambda r: (
            _f32(r, 3, 4, 8), 8, _f32(r, 8) + 1, _f32(r, 8)), {},
            (0, 2, 3)),
        "layer_norm_two_axes": ("layer_norm", lambda r: (
            _f32(r, 3, 4, 8), [4, 8], _f32(r, 4, 8) + 1, _f32(r, 4, 8)),
            dict(epsilon=1e-3), (0, 2, 3)),
        "layer_norm_no_affine": ("layer_norm", lambda r: (
            _f32(r, 5, 6), [6]), {}, (0,)),
        "instance_norm_nchw": ("instance_norm", lambda r: (
            _f32(r, 2, 3, 4, 5), None, None, _f32(r, 3), _f32(r, 3)), {},
            (0, 3, 4)),
        "instance_norm_nlc": ("instance_norm", lambda r: (
            _f32(r, 2, 7, 3),), dict(data_format="NLC", eps=1e-3), (0,)),
        "group_norm_nchw": ("group_norm", lambda r: (
            _f32(r, 2, 6, 3, 3), 3, 1e-5, _f32(r, 6), _f32(r, 6)), {},
            (0, 3, 4)),
        "group_norm_nhwc": ("group_norm", lambda r: (
            _f32(r, 2, 3, 3, 4), 2), dict(data_format="NHWC"), (0,)),
        "local_response_norm": ("local_response_norm", lambda r: (
            _f32(r, 2, 7, 3, 3), 5), dict(alpha=0.1, k=2.0), (0,)),
        "local_response_norm_nhwc_even": ("local_response_norm", lambda r: (
            _f32(r, 2, 3, 3, 6), 4), dict(data_format="NHWC", beta=0.5),
            (0,)),
    }


@pytest.mark.parametrize("name", sorted(_functional_cases()))
def test_functional_norm_matches_the_reference(name):
    fn, build, kw, grad = _functional_cases()[name]
    args = build(np.random.RandomState(0))
    want = ref_call(getattr(JF, fn), args, kw, grad)
    launched = fused.fused_layer_norm.launches
    got = port_call(getattr(TF, fn), args, kw, grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
    assert fused.fused_layer_norm.launches == launched  # CPU: no kernel


def test_one_axis_layer_norm_is_the_kernels_path(monkeypatch):
    """``F.layer_norm`` over one axis with both affine tensors calls
    ``fused_layer_norm`` (#5 / #6 on the card); other shapes do not."""
    calls = []
    real = fused.fused_layer_norm
    monkeypatch.setattr(fused, "fused_layer_norm",
                        lambda *a: calls.append(a) or real(*a))
    x = torch.randn(3, 8)
    TF.layer_norm(x, 8, torch.ones(8), torch.zeros(8))
    TF.layer_norm(x, 8)
    TF.layer_norm(x.reshape(3, 2, 4), [2, 4], torch.ones(2, 4),
                  torch.zeros(2, 4))
    assert len(calls) == 1


def _layer_cases():
    """id -> (build(nn, side) -> layer, inputs maker(rng))."""
    def kw(s):
        return {} if s == "ref" else {"device": "cpu"}

    return {
        "GroupNorm": (lambda nn, s: nn.GroupNorm(2, 4, **kw(s)),
                      lambda r: (_f32(r, 2, 4, 3, 3),)),
        "GroupNorm_no_affine": (lambda nn, s: nn.GroupNorm(
            4, 4, weight_attr=False, bias_attr=False, **kw(s)),
            lambda r: (_f32(r, 2, 4, 5),)),
        "InstanceNorm1D": (lambda nn, s: nn.InstanceNorm1D(3, **kw(s)),
                           lambda r: (_f32(r, 2, 3, 6),)),
        "InstanceNorm2D": (lambda nn, s: nn.InstanceNorm2D(
            3, epsilon=1e-3, **kw(s)), lambda r: (_f32(r, 2, 3, 4, 4),)),
        "InstanceNorm3D_no_affine": (lambda nn, s: nn.InstanceNorm3D(
            2, weight_attr=False, **kw(s)),
            lambda r: (_f32(r, 1, 2, 3, 3, 3),)),
        "LocalResponseNorm": (lambda nn, s: nn.LocalResponseNorm(3),
                              lambda r: (_f32(r, 2, 5, 3, 3),)),
        "SpectralNorm": (lambda nn, s: nn.SpectralNorm(
            [4, 3, 2], dim=1, power_iters=3, **kw(s)),
            lambda r: (_f32(r, 4, 3, 2),)),
        "SyncBatchNorm": (lambda nn, s: nn.SyncBatchNorm(3, **kw(s)),
                          lambda r: (_f32(r, 4, 3, 2, 2) * 2 + 1,)),
        "PairwiseDistance": (lambda nn, s: nn.PairwiseDistance(),
                             lambda r: (_f32(r, 5, 4), _f32(r, 5, 4))),
        "PairwiseDistance_p1_keepdim": (lambda nn, s: nn.PairwiseDistance(
            p=1, keepdim=True), lambda r: (_f32(r, 5, 4), _f32(r, 5, 4))),
        "PairwiseDistance_inf": (lambda nn, s: nn.PairwiseDistance(
            p=float("inf")), lambda r: (_f32(r, 5, 4), _f32(r, 5, 4))),
    }


def _carried(ref, port):
    params = {k: np.asarray(v) for k, v in jfunc.get_params(ref).items()}
    load_jax_params(port, params)
    return params


def _param_grads(port, ref):
    got = {k: p.grad.numpy() for k, p in port.named_parameters()
           if p.grad is not None}
    want = {k: np.asarray(p.grad.numpy()) for k, p in
            ref.named_parameters() if p.grad is not None}
    assert sorted(got) == sorted(want)
    return [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_norm_layer_matches_the_reference(name):
    build, inputs = _layer_cases()[name]
    ref, port = build(paddle.nn, "ref"), build(tnn, "port")
    _carried(ref, port)
    args = inputs(np.random.RandomState(3))
    grad = tuple(range(len(args)))
    got = port_call(port, args, grad=grad)
    want = ref_call(ref, args, grad=grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
    assert_close(*_param_grads(port, ref), what=name, **GRAD_TOL)
    if name == "SyncBatchNorm":  # the running statistics, as BatchNorm's
        assert_close([port._mean.numpy(), port._variance.numpy()],
                     [np.asarray(ref._mean.numpy()),
                      np.asarray(ref._variance.numpy())], what=name,
                     **VALUE_TOL)


def test_spectral_norm_layer_never_writes_u_and_v_back():
    """The reference runs its power iteration from the stored u and v on
    every call and keeps them as they were; so does the port."""
    sn = tnn.SpectralNorm([5, 4], power_iters=2, device="cpu")
    u0, v0 = sn.weight_u.clone(), sn.weight_v.clone()
    w = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    first = sn(w)
    second = sn(w)
    assert torch.equal(first, second)
    assert torch.equal(sn.weight_u, u0) and torch.equal(sn.weight_v, v0)
    assert not sn.weight_u.requires_grad and not sn.weight_v.requires_grad


def test_sync_batch_norm_converts_and_refuses_a_larger_world(monkeypatch):
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"),
                         tnn.BatchNorm2D(4, device="cpu"))
    with torch.no_grad():
        net[1].weight.uniform_(0.5, 1.5)
        net[1]._mean.fill_(0.25)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    for k, v in conv.state_dict().items():
        assert torch.equal(v, before[k]), k
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="item 6"):
        conv(torch.randn(2, 3, 5, 5))
    conv.eval()(torch.randn(2, 3, 5, 5))  # running statistics: no sync


def _reparam_cases():
    """id -> (apply(nn module, layer) -> layer, layer maker(nn, side),
    inputs maker)."""
    def kw(s):
        return {} if s == "ref" else {"device": "cpu"}

    lin = lambda nn, s: nn.Linear(4, 3, **kw(s))  # noqa: E731
    conv = lambda nn, s: nn.Conv2D(2, 3, 3, **kw(s))  # noqa: E731
    x_lin = lambda r: (_f32(r, 5, 4),)  # noqa: E731
    x_conv = lambda r: (_f32(r, 2, 2, 5, 5),)  # noqa: E731
    return {
        "weight_norm_linear": (lambda nn, m: nn.weight_norm(m), lin, x_lin),
        "weight_norm_dim1": (lambda nn, m: nn.weight_norm(m, dim=1), lin,
                             x_lin),
        "weight_norm_whole": (lambda nn, m: nn.weight_norm(m, dim=None),
                              conv, x_conv),
        "weight_norm_removed": (lambda nn, m: nn.remove_weight_norm(
            nn.weight_norm(m)), conv, x_conv),
        "spectral_norm_linear": (lambda nn, m: nn.spectral_norm(
            m, n_power_iterations=2), lin, x_lin),
        "spectral_norm_conv_dim1": (lambda nn, m: nn.spectral_norm(
            m, dim=1), conv, x_conv),
    }


@pytest.mark.parametrize("name", sorted(_reparam_cases()))
def test_reparametrization_matches_the_reference(name):
    """The reparametrized layer in both packages, its parameters
    (``weight_g`` / ``weight_v``, ``weight_orig`` and the u / v of
    ``weight_sn``) carried by name; the output and every gradient."""
    apply, build, inputs = _reparam_cases()[name]
    ref = apply(paddle.nn, build(paddle.nn, "ref"))
    port = apply(tnn, build(tnn, "port"))
    params = _carried(ref, port)
    if "weight_norm" in name and "removed" not in name:
        assert {"weight_g", "weight_v"} <= set(params)
    if "spectral" in name:
        assert {"weight_orig", "weight_sn.weight_u",
                "weight_sn.weight_v"} <= set(params)
    args = inputs(np.random.RandomState(4))
    got = port_call(port, args, grad=(0,))
    want = ref_call(ref, args, grad=(0,))
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
    assert_close(*_param_grads(port, ref), what=name, **GRAD_TOL)


def test_parameter_list_names_and_holds_parameters_as_the_reference():
    """Parameters named "0", "1", ... (a model holding the list gets
    ``plist.0``), appended and iterated in order; the gradients reach
    them through a product."""
    r = np.random.RandomState(5)
    a, b, x = _f32(r, 3, 4), _f32(r, 4, 2), _f32(r, 5, 3)
    ref = paddle.nn.ParameterList([paddle.create_parameter(
        [3, 4], "float32")])
    ref.append(paddle.create_parameter([4, 2], "float32"))
    port = tnn.ParameterList([torch.nn.Parameter(torch.zeros(3, 4))])
    port.append(torch.nn.Parameter(torch.zeros(4, 2)))
    assert len(port) == len(ref) == 2
    assert [k for k, _ in port.named_parameters()] == ["0", "1"]
    assert sorted(jfunc.get_params(ref)) == ["0", "1"]
    load_jax_params(port, {"0": a, "1": b})
    with torch.no_grad():
        for p, v in zip(ref, (a, b)):
            p.set_value(v)
    got = port_call(lambda x: x @ port[0] @ port[-1], [x], grad=(0,))
    want = ref_call(lambda x: x @ ref[0] @ ref[1], [x], grad=(0,))
    assert_close([got[0]], [want[0]], rtol=1e-5, atol=1e-5)
    assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert [tuple(p.shape) for p in port] == [(3, 4), (4, 2)]
    np.testing.assert_allclose(port[1].grad.numpy(),
                               np.asarray(ref[1].grad.numpy()), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("name", sorted(_functional_cases()))
def test_functional_norm_on_the_card_matches_the_cpu(name):
    fn, build, kw, grad = _functional_cases()[name]
    args = build(np.random.RandomState(0))
    cpu = port_call(getattr(TF, fn), args, kw, grad)
    card = port_call(getattr(TF, fn), args, kw, grad, "cuda")
    assert_close([card[0]], [cpu[0]], what=name, **VALUE_TOL)
    assert_close(card[1], cpu[1], what=name, **GRAD_TOL)
