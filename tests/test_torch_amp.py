"""The port's AMP (paddle_tpu_torch.amp) against the reference's: the same
op lists; with AMP off the white-listed functionals are the identity on
their inputs (linear: the same bits as F.linear); under auto_cast(bf16)
linear and the convolutions run in bf16 and BatchNorm keeps a bf16
activation bf16, against the reference under its auto_cast; O2,
custom lists, nesting, thread-locality and decorate.

Tolerance (bf16): each output within 2^-6 of its largest magnitude: the
inputs are rounded to bf16 identically, both sides accumulate in f32 and
round the result once (the reference rounds the bias add once more)."""
import importlib
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer.common import linear
import torch_threads  # noqa: F401  (one torch thread a worker)

# the packages export the function ``auto_cast`` under the module's name
ref_amp = importlib.import_module("paddle_tpu.amp.auto_cast")
port_amp = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
JF = paddle.nn.functional
BF16_TOL = 2.0 ** -6


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max())


def _rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_op_lists_are_the_references():
    assert port_amp.white_list == ref_amp.white_list
    assert port_amp.black_list == ref_amp.black_list


def test_amp_off_is_the_identity():
    x, w = torch.randn(3, 4), torch.randn(4, 5)
    assert not amp.amp_state().enabled
    out = amp.maybe_cast_inputs("linear", x, w)
    assert out[0] is x and out[1] is w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_with_amp_off_is_f_linear_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=g).to(dtype)
    w = torch.randn(8, 5, generator=g).to(dtype)
    b = torch.randn(5, generator=g).to(dtype)
    assert torch.equal(linear(x, w, b),
                       torch.nn.functional.linear(x, w.t(), b))
    assert torch.equal(linear(x, w), torch.nn.functional.linear(x, w.t()))


def test_linear_under_bf16_matches_reference():
    x, w, b = _rnd(6, 8), _rnd(8, 5, seed=1), _rnd(5, seed=2)
    with ref_amp.auto_cast(dtype="bfloat16"):
        ref = JF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                        paddle.to_tensor(b))
    with amp.auto_cast(dtype="bfloat16"):
        got = linear(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and str(ref.dtype).endswith("bfloat16")
    _close(got, ref.astype("float32").numpy(), BF16_TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_under_bf16_matches_reference(n):
    x = _rnd(*((2, 3) + (6, 7, 5)[:n]))
    w = _rnd(*((4, 3) + (3,) * n), seed=1) * 0.3
    b = _rnd(4, seed=2)
    name = f"conv{n}d"
    with ref_amp.auto_cast(dtype="bfloat16"):
        ref = getattr(JF, name)(paddle.to_tensor(x), paddle.to_tensor(w),
                                paddle.to_tensor(b), padding=1)
    with amp.auto_cast(dtype="bfloat16"):
        got = getattr(TF, name)(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), padding=1)
    assert got.dtype == torch.bfloat16 and str(ref.dtype).endswith("bfloat16")
    _close(got, ref.astype("float32").numpy(), BF16_TOL)


def test_conv_bn_relu_under_bf16_matches_reference():
    """O1 as ResNet runs it: the conv in bf16, BatchNorm (black-listed,
    never cast) takes the bf16 activation, keeps f32 statistics and
    returns bf16; the ReLU follows its input's dtype."""
    x = _rnd(4, 3, 8, 8)
    paddle.seed(0)
    rconv, rbn = paddle.nn.Conv2D(3, 8, 3, padding=1), paddle.nn.BatchNorm2D(8)
    conv, bn = tnn.Conv2D(3, 8, 3, padding=1), tnn.BatchNorm2D(8)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(rconv.weight.numpy())))
        conv.bias.copy_(torch.from_numpy(np.array(rconv.bias.numpy())))
    with ref_amp.auto_cast(dtype="bfloat16"):
        ref = JF.relu(rbn(rconv(paddle.to_tensor(x))))
    with amp.auto_cast(dtype="bfloat16"):
        got = TF.relu(bn(conv(torch.from_numpy(x))))
    assert got.dtype == torch.bfloat16
    assert bn._mean.dtype == torch.float32
    _close(got, ref.astype("float32").numpy(), BF16_TOL)
    _close(bn._variance, rbn._variance.numpy(), 1e-2)


def test_transposed_conv_is_not_cast():
    x, w = torch.randn(1, 2, 4, 4), torch.randn(2, 3, 3, 3)
    with amp.auto_cast(dtype="bfloat16"):
        assert TF.conv2d_transpose(x, w).dtype == torch.float32


def test_custom_lists_and_o2():
    x = torch.randn(2, 3)
    with amp.auto_cast(dtype="bfloat16", custom_black_list={"linear"}):
        assert amp.maybe_cast_inputs("linear", x)[0].dtype == torch.float32
    with amp.auto_cast(dtype="bfloat16", custom_white_list={"relu"}):
        assert amp.maybe_cast_inputs("relu", x)[0].dtype == torch.bfloat16
    with amp.auto_cast(dtype="bfloat16", level="O2"):
        assert amp.maybe_cast_inputs("relu", x)[0].dtype == torch.bfloat16
        assert amp.maybe_cast_inputs("softmax", x)[0].dtype == torch.float32
    with amp.auto_cast(enable=False, dtype="bfloat16"):
        assert amp.maybe_cast_inputs("linear", x)[0] is x
    ids = torch.arange(3)
    with amp.auto_cast(dtype="bfloat16"):
        assert amp.maybe_cast_inputs("linear", ids)[0] is ids  # not float


def test_auto_cast_nests_and_restores():
    with amp.auto_cast(dtype="bfloat16"):
        with amp.auto_cast(dtype="float16", level="O2"):
            assert amp.amp_state().dtype == torch.float16
            assert amp.amp_state().level == "O2"
        assert amp.amp_state().dtype == torch.bfloat16
        assert amp.amp_state().level == "O1"
    assert not amp.amp_state().enabled
    with pytest.raises(RuntimeError):
        with amp.amp_guard(dtype="bfloat16"):
            raise RuntimeError("inside")
    assert not amp.amp_state().enabled


def test_state_is_per_thread():
    seen = []
    with amp.auto_cast(dtype="bfloat16"):
        t = threading.Thread(
            target=lambda: seen.append(amp.amp_state().enabled))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [False]


def test_decorate_o2_casts_parameters_and_buffers_as_the_reference():
    paddle.seed(0)
    ref = paddle.amp.decorate(paddle.nn.BatchNorm2D(4), level="O2",
                              dtype="bfloat16")
    port = amp.decorate(tnn.BatchNorm2D(4), level="O2", dtype="bfloat16")
    for name in ("weight", "bias", "_mean", "_variance"):
        assert getattr(port, name).dtype == torch.bfloat16
        assert str(getattr(ref, name).dtype).endswith("bfloat16")
    model, opt = amp.decorate(tnn.Conv2D(2, 2, 1), optimizers="opt",
                              level="O1")
    assert model.weight.dtype == torch.float32 and opt == "opt"
