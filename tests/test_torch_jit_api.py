"""The jit API of the port (paddle_tpu_torch.jit: to_static, StaticFunction,
TracedLayer, not_to_static, InputSpec, save / load) against the
reference's, on the CPU, with the reference's weights and buffers carried
across by ``load_jax_params``:

- ``to_static`` on a Layer (a Linear, a BatchNorm1D in train mode and a
  tensor ``if`` in its forward): the same outputs as the reference's, no
  gradient, and the running statistics updated as the reference's
  functionalized apply updates them;
- ``to_static`` on a function: it runs under ``no_grad`` and returns
  values without gradient, as the reference's jitted function does;
- ``TracedLayer``: the eval-mode forward, buffers left alone;
- ``not_to_static``, ``InputSpec``, and ``save`` / ``load``: a round trip
  of the port's files, the reference's ``.pdiparams`` read by the port's
  ``load``, and with ``input_spec`` the ``.pdexport`` artifact, whose
  Predictor gives the reference Predictor's outputs (a BatchNorm in eval
  mode, a dynamic batch).

Tolerances: outputs and running statistics 1e-5 (f32, other summation
orders); the saved weights exact."""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import get_buffers as jget_buffers
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu_torch import jit
from paddle_tpu_torch.jit.dy2static import convert_to_static
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import BatchNorm1D, Linear


class TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 4, device="cpu")
        self.bn = BatchNorm1D(4, device="cpu")

    def forward(self, x):
        h = self.bn(self.fc(x))
        if x.sum() > 0:
            out = h * 2
        else:
            out = h * -1
        return out


class TPlain(TNet):
    def forward(self, x):
        return self.bn(self.fc(x)) * 2


class JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 4)
        self.bn = paddle.nn.BatchNorm1D(4)

    def forward(self, x):
        h = self.bn(self.fc(x))
        if x.sum() > 0:
            out = h * 2
        else:
            out = h * -1
        return out


class JPlain(JNet):
    def forward(self, x):
        return self.bn(self.fc(x)) * 2


def _pair(train=True, tcls=TNet, jcls=JNet):
    paddle.seed(0)
    jnet = jcls()
    tnet = load_jax_params(
        tcls(), {k: np.asarray(v) for k, v in jget_params(jnet).items()},
        buffers={k: np.asarray(v) for k, v in jget_buffers(jnet).items()})
    jnet.train() if train else jnet.eval()
    tnet.train(train)
    return jnet, tnet


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def _x(seed=0, n=3):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_to_static_layer_values_no_grad_and_buffers(seed):
    jnet, tnet = _pair(train=True)
    jst, tst = paddle.jit.to_static(jnet), jit.to_static(tnet)
    assert isinstance(tst, jit.StaticFunction)
    x = _x(seed)
    got = tst(torch.from_numpy(x))
    want = jst(paddle.to_tensor(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not got.requires_grad and got.grad_fn is None
    tb = {k: v.numpy() for k, v in tnet.named_buffers()}
    for k, v in jget_buffers(jnet).items():
        np.testing.assert_allclose(tb[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-5)
    assert not np.allclose(tb["bn._mean"], 0.0)  # train mode moved them


def test_to_static_function_runs_under_no_grad():
    seen = []

    def f(x, y):
        seen.append(torch.is_grad_enabled())
        if x.sum() > y.sum():
            z = x * 2 + y
        else:
            z = x - y
        return z, {"sum": z.sum()}

    st = jit.to_static(f)
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    z, aux = st(x, torch.tensor([0.5, 0.5]))
    np.testing.assert_array_equal(z.numpy(), [2.5, 4.5])
    assert seen == [False]
    assert not z.requires_grad and not aux["sum"].requires_grad
    jz, _ = paddle.jit.to_static(
        lambda a, b: (a * 2 + b, {"sum": (a * 2 + b).sum()}))(
        paddle.to_tensor([1.0, 2.0]), paddle.to_tensor([0.5, 0.5]))
    np.testing.assert_array_equal(z.numpy(), jz.numpy())
    # the decorator form
    assert jit.to_static()(f)(x, torch.tensor([9.0, 9.0]))[0].tolist() == \
        [-8.0, -7.0]


def test_traced_layer_is_the_eval_forward_and_leaves_buffers():
    # the reference's TracedLayer jits without converting: no tensor if
    jnet, tnet = _pair(train=True, tcls=TPlain, jcls=JPlain)
    before = {k: v.clone() for k, v in tnet.named_buffers()}
    traced = jit.TracedLayer(tnet)
    x = _x(3)
    out = traced(torch.from_numpy(x))
    want = paddle.jit.TracedLayer(jnet)(paddle.to_tensor(x))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not out.requires_grad and tnet.training
    for k, v in tnet.named_buffers():
        assert torch.equal(v, before[k])


def test_not_to_static_and_input_spec():
    def f(x):
        if x.sum() > 0:
            y = x
        else:
            y = -x
        return y

    assert jit.not_to_static(f) is f and f._not_to_static
    assert convert_to_static(f) is f
    spec = jit.InputSpec([None, 8], "float32", "x")
    assert (spec.shape, spec.dtype, spec.name) == ([None, 8], "float32", "x")
    spec = jit.InputSpec.from_tensor(torch.zeros(2, 3, dtype=torch.int64),
                                     name="ids")
    assert (spec.shape, spec.dtype, spec.name) == ([2, 3], "int64", "ids")
    assert "InputSpec(shape=[2, 3]" in repr(spec)
    jspec = paddle.jit.InputSpec([None, 8], "float32", "x")
    assert (jspec.shape, jspec.dtype, jspec.name) == ([None, 8], "float32",
                                                      "x")


def test_save_load_round_trip_and_the_reference_files(tmp_path):
    jnet, tnet = _pair(train=False)
    path = str(tmp_path / "sub" / "net")
    jit.save(jit.to_static(tnet), path)
    assert os.path.exists(path + ".pdiparams")
    with open(path + ".pdmodel", "rb") as f:
        assert pickle.load(f) == {"class": "TNet"}
    loaded = jit.load(path)
    assert loaded.meta == {"class": "TNet"}
    own = tnet.state_dict()
    assert sorted(loaded.state_dict()) == sorted(own)
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(_np(v), _np(own[k]))
    # the reference's jit.save, read by the port's load
    jpath = str(tmp_path / "ref")
    paddle.jit.save(jnet, jpath)
    ref = jit.load(jpath)
    assert ref.meta["class"] == "JNet"
    for k, v in jnet.state_dict().items():
        np.testing.assert_array_equal(_np(ref.state_dict()[k]),
                                      np.asarray(v._value))
    # with input_spec: the .pdexport artifact, served by a Predictor with
    # the reference Predictor's outputs (the reference's .pdexport is a
    # jax.export program, so each side serves its own)
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference as tinf

    jplain, tplain = _pair(train=False, tcls=TPlain, jcls=JPlain)
    spec = [jit.InputSpec([None, 4], "float32", "x")]
    jit.save(tplain, str(tmp_path / "x"), input_spec=spec)
    paddle.jit.save(jplain, str(tmp_path / "jx"), input_spec=[
        paddle.jit.InputSpec([None, 4], "float32", "x")])
    assert os.path.exists(str(tmp_path / "x.pdiparams"))
    assert jit.load(str(tmp_path / "x")).meta["in_specs"] \
        == [([None, 4], "float32")]
    cfg = tinf.Config(str(tmp_path / "x"))
    cfg.disable_gpu()
    pred = tinf.create_predictor(cfg)
    jpred = jinf.create_predictor(jinf.Config(str(tmp_path / "jx")))
    for n in (1, 5):
        x = _x(n, n)
        np.testing.assert_allclose(pred.run([x])[0], jpred.run([x])[0],
                                   rtol=1e-5, atol=1e-5)
