"""The port's BatchNorm (paddle_tpu_torch.nn.functional.batch_norm,
nn.layer.norm.BatchNorm*) against the reference's: the training forward
and its dx, dw, db against `jax.vjp` of the reference's `_bn_manual`
path, the running statistics after 3 steps (biased variance, momentum 0.9,
in the buffer's dtype), eval mode and use_global_stats, NCHW and NHWC,
[N, C] and 3-D inputs, and a bf16 input (bf16 out, f32 statistics).

Tolerance (f32): max |port - ref| <= 1e-5 * max(1, max |ref|) for the
output, dx, dw, db and the running statistics: both sides take one-pass
f32 sums in other orders. bf16: the output within 2^-7 of its largest
magnitude (one bf16 rounding of f32 results that agree to 1e-5)."""
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

SHAPES = [((4, 3, 5, 6), "NCHW"), ((4, 5, 6, 3), "NHWC"), ((8, 3), "NC"),
          ((4, 3, 7), "NCL"), ((2, 3, 3, 4, 5), "NCDHW")]


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _inputs(shape, fmt, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    return (x, (1.0 + 0.2 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32))


@pytest.mark.parametrize("shape,fmt", SHAPES)
def test_training_forward_and_gradients_match_reference(shape, fmt):
    x, w, b = _inputs(shape, fmt)

    def pure(a, ww, bb):
        with no_grad():
            return JF.batch_norm(Tensor(a), None, None, Tensor(ww),
                                 Tensor(bb), training=True,
                                 data_format=fmt)._value

    out, vjp = jax.vjp(pure, *map(jnp.asarray, (x, w, b)))
    ct = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    gx, gw, gb = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    got = TF.batch_norm(ts[0], None, None, ts[1], ts[2], training=True,
                        data_format=fmt)
    got.backward(torch.from_numpy(ct))
    _close(got, out)
    for t, g in zip(ts, (gx, gw, gb)):
        _close(t.grad, g)


@pytest.mark.parametrize("shape,fmt", SHAPES)
@pytest.mark.parametrize("momentum", [0.9, 0.5])
def test_running_statistics_after_three_steps_match_reference(shape, fmt,
                                                              momentum):
    """r = m*r + (1-m)*batch with the BIASED batch variance (torch's
    F.batch_norm would update with the unbiased one), three steps on
    three inputs, then an eval forward on the running statistics."""
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    ref = paddle.nn.BatchNorm2D(c, momentum=momentum, data_format=fmt)
    port = tnn.BatchNorm2D(c, momentum=momentum, data_format=fmt)
    for step in range(3):
        x, _, _ = _inputs(shape, fmt, seed=step + 1)
        _close(port(torch.from_numpy(x)), ref(paddle.to_tensor(x)).numpy())
    _close(port._mean, ref._mean.numpy())
    _close(port._variance, ref._variance.numpy())
    assert port._mean.dtype == port._variance.dtype == torch.float32
    ref.eval()
    port.eval()
    x, _, _ = _inputs(shape, fmt, seed=7)
    _close(port(torch.from_numpy(x)), ref(paddle.to_tensor(x)).numpy())


def test_running_variance_is_biased():
    x = torch.randn(6, 2, 3, 3, generator=torch.Generator().manual_seed(0))
    bn = tnn.BatchNorm2D(2, momentum=0.0)  # r = the batch statistics
    bn(x)
    want = x.transpose(0, 1).reshape(2, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(bn._variance, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_use_global_stats_normalises_with_the_running_statistics(fmt):
    shape = (4, 3, 5, 6) if fmt == "NCHW" else (4, 5, 6, 3)
    x, w, b = _inputs(shape, fmt, seed=3)
    rng = np.random.RandomState(4)
    rm = rng.randn(3).astype(np.float32)
    rv = (1.0 + rng.rand(3)).astype(np.float32)
    ref = JF.batch_norm(paddle.to_tensor(x), paddle.to_tensor(rm),
                        paddle.to_tensor(rv), paddle.to_tensor(w),
                        paddle.to_tensor(b), training=True,
                        data_format=fmt, use_global_stats=True)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    got = TF.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                        torch.from_numpy(b), training=True, data_format=fmt,
                        use_global_stats=True)
    _close(got, ref.numpy())
    assert torch.equal(trm, torch.from_numpy(rm))  # no update
    assert torch.equal(trv, torch.from_numpy(rv))


def test_bf16_input_gives_bf16_output_with_f32_statistics():
    x, w, b = _inputs((4, 3, 5, 6), "NCHW", seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref_bn = paddle.nn.BatchNorm2D(3)
    port_bn = tnn.BatchNorm2D(3)
    ref = ref_bn(paddle.to_tensor(xb.float().numpy()).astype("bfloat16"))
    got = port_bn(xb)
    assert got.dtype == torch.bfloat16
    assert str(ref.dtype).endswith("bfloat16")
    _close(got, np.asarray(ref.astype("float32").numpy()), tol=2.0 ** -7)
    assert port_bn._mean.dtype == torch.float32
    _close(port_bn._mean, ref_bn._mean.numpy())
    _close(port_bn._variance, ref_bn._variance.numpy())


@pytest.mark.parametrize("weight,bias", [(False, True), (True, False),
                                         (False, False)])
def test_missing_weight_or_bias_matches_reference(weight, bias):
    x, w, b = _inputs((4, 3, 5, 6), "NCHW", seed=6)
    ref = JF.batch_norm(paddle.to_tensor(x), None, None,
                        paddle.to_tensor(w) if weight else None,
                        paddle.to_tensor(b) if bias else None, training=True)
    t = torch.tensor(x, requires_grad=True)
    got = TF.batch_norm(t, None, None,
                        torch.from_numpy(w) if weight else None,
                        torch.from_numpy(b) if bias else None, training=True)
    _close(got, ref.numpy())
    got.sum().backward()
    assert torch.isfinite(t.grad).all()


def test_layers_carry_the_reference_names_and_defaults():
    port = tnn.BatchNorm2D(4)
    ref = paddle.nn.BatchNorm2D(4)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()] == ["weight", "bias"]
    assert [n for n, _ in port.named_buffers()] == \
        [n for n, _ in ref.named_buffers()] == ["_mean", "_variance"]
    for name in ("weight", "bias", "_mean", "_variance"):
        np.testing.assert_array_equal(getattr(port, name).detach().numpy(),
                                      np.asarray(getattr(ref, name).numpy()))


def test_fluid_batch_norm_applies_its_activation():
    x, _, _ = _inputs((4, 3, 5, 6), "NCHW", seed=8)
    ref = paddle.nn.BatchNorm(3, act="relu")(paddle.to_tensor(x))
    got = tnn.BatchNorm(3, act="relu")(torch.from_numpy(x))
    _close(got, ref.numpy())
    assert float(got.detach().min()) == 0.0


@pytest.mark.parametrize("cls,shape", [("BatchNorm1D", (8, 3)),
                                       ("BatchNorm1D", (4, 3, 7)),
                                       ("BatchNorm3D", (2, 3, 3, 4, 5))])
def test_batch_norm_1d_3d_layers_match_reference(cls, shape):
    x, _, _ = _inputs(shape, "NC", seed=9)
    ref = getattr(paddle.nn, cls)(3)
    port = getattr(tnn, cls)(3)
    _close(port(torch.from_numpy(x)), ref(paddle.to_tensor(x)).numpy())
    _close(port._variance, ref._variance.numpy())


@pytest.mark.parametrize("master", [False, True])
def test_train_step_updates_buffers_and_keeps_them_f32(master):
    """The step's forward updates BatchNorm's running statistics in
    place; in bf16 master mode only the parameters are cast, the
    buffers stay f32."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import Adam

    model = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    opt = Adam(1e-3, parameters=model.parameters(), multi_precision=master)
    step = ParallelTrainStep(model,
                             lambda out, lbl: (out.float() ** 2).mean(),
                             opt, device="cpu",
                             compute_dtype=torch.bfloat16 if master else None)
    x = torch.from_numpy(_inputs((4, 3, 6, 6), "NCHW", seed=10)[0])
    if master:  # the input in the parameters' dtype, as a conv needs
        x = x.to(torch.bfloat16)
    step((x,), (x,))
    bn = model[1]
    assert bn._mean.dtype == bn._variance.dtype == torch.float32
    assert bn.weight.dtype == (torch.bfloat16 if master else torch.float32)
    assert float(bn._mean.abs().max()) > 0.0
    assert not torch.equal(bn._variance, torch.ones(4))
