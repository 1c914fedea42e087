"""The vision slice as a whole (paddle_tpu_torch.vision.models with the
port's layers, TrainStep, optimizers, DataLoader and metrics) against the
reference's, on the CPU:

- LeNet, resnet18 and resnet50 name their parameters and buffers as the
  reference's, with the same shapes; the reference's weights and buffers
  cross over with `load_jax_params(..., buffers=...)` and give the same
  eval-mode logits;
- LeNet as BASELINE config #1 trains it (batch 64 x 1 x 28 x 28 from
  RandomState(0), Adam 1e-3, `jit.TrainStep`): 3 steps against the
  reference's `jit.TrainStep`, the losses and parameters;
- resnet18 with Momentum(0.01, 0.9) and [N, 1] labels: 2 steps against
  the reference's `jit.TrainStep`, the losses, the parameters and the
  running statistics;
- resnet50 at full width: one train-mode forward, the gradients (against
  `jax.vjp`) and the running statistics after it;
- resnet18's loss curve under bf16 AMP O1 (3 Momentum steps);
- LeNet trained one epoch over the synthetic MNIST through the
  DataLoader: the loss falls and test Accuracy ends above chance.

The ResNets run at 2 x 3 x 64 x 64, not 32 x 32: at 32 x 32 layer4's maps
are 1 x 1, so each of its BatchNorms normalises two values a channel to
+-1 with rstd up to 1/sqrt(eps) ~ 316, and f32 rounding is amplified
~300-fold a layer. Measured on the CPU in f32 at 32 x 32: resnet18's step-1
loss 3.6381 against the reference's 3.6417 and parameters 14.9 apart
after two steps; resnet50's logits 0.77 apart relative to their largest.
At 64 x 64 (8 values a channel) resnet18 agrees to 2e-6.

Tolerances (f32, both sides sum in f32 in other orders): LeNet's loss
1e-5 and its parameters after 3 Adam steps 5e-5 (Adam divides by
sqrt(v): a gradient near 0 turns a 1e-7 difference into a visible move);
resnet18's losses 1e-5 relative, its parameters after two Momentum steps
1e-5, its logits and running statistics 1e-4 of each tensor's largest
magnitude. resnet50 (53 BatchNorms at batch 2): its logits and running
statistics 1e-3 of their largest magnitude (measured 2.6e-4), fc's
gradient 5e-3 (measured 7.8e-4), and every other gradient tensor within
0.1 of its L2 norm (measured 0.046 at worst): a randomly initialised
ResNet-50's gradients grow ~100-fold toward the stem, and its f32
gradients are this far from an f64 run of the same port (0.2 of a
tensor's largest element; torch's own two-pass F.batch_norm: 0.07).
Under bf16 AMP the losses within 5e-2 relative (see that test)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.jit.functionalize import (get_buffers, get_params,
                                                load_jax_params)
from paddle_tpu_torch.jit.train_step import EvalStep, TrainStep
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Adam, Momentum
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import models as tmodels
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

LENET_LOSS_TOL = 1e-5
LENET_PARAM_TOL = 5e-5
RESNET_SHAPE = (2, 3, 64, 64)
RESNET_REL_TOL = 1e-4
R18_LOSS_TOL = 1e-5
R18_PARAM_TOL = 1e-5
R50_FWD_TOL = 1e-3
R50_FC_GRAD_TOL = 5e-3
R50_GRAD_L2_TOL = 0.1
BF16_LOSS_RTOL = 5e-2
# vgg11 (with BatchNorm) and mobilenet_v2(scale=0.25) at 2 x 3 x 64 x 64:
# logits, the step's loss and the running statistics within 1e-4 of their
# largest magnitude (measured 3.1e-7, 1.6e-5 and 7.9e-6); each
# parameter's update p' - p within 5e-2 of its L2 norm (measured 1.4e-2:
# the port's f32 gradients are within 2.4e-6 of its f64 run, the
# reference's 1.4e-2 from it at vgg11's conv layers; mobilenet's
# small-batch BatchNorms: 8.8e-3), plus lr·1e-4 an element for gradients
# that are rounding noise: the biases in front of a BatchNorm, whose
# gradient is 0 analytically (f64: ~1e-7), and mobilenet's first
# depthwise BatchNorm bias (f64: at most 2.7e-5; measured 1.4e-7 an
# element apart)
VGG_MOBILE_TOL = 1e-4
VGG_MOBILE_UPDATE_L2 = 5e-2
VGG_MOBILE_UPDATE_FLOOR = 1e-6


def _np(d):
    return {k: np.array(v, dtype=np.float32) for k, v in d.items()}


def _rel_close(got, ref, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-6), err


def _ref_model(name, **kw):
    paddle.seed(0)
    return getattr(jmodels, name)(**kw)


def _port_model(name, ref, **kw):
    model = getattr(tmodels, name)(device="cpu", **kw)
    return load_jax_params(model, _np(jfunc.get_params(ref)),
                           buffers=_np(jfunc.get_buffers(ref)))


@pytest.fixture(scope="module")
def resnet50_ref():
    return _ref_model("resnet50")  # ~15 s to build on a CPU: built once


@pytest.mark.parametrize("name,kw", [("LeNet", {}),
                                     ("resnet18", {"num_classes": 10}),
                                     ("resnet50", {}),
                                     ("vgg11", {}),
                                     ("vgg11", {"batch_norm": True}),
                                     ("mobilenet_v2", {"scale": 0.25}),
                                     ("mobilenet_v1", {"scale": 0.25})])
def test_models_name_their_tensors_as_the_reference(name, kw, request):
    ref = (request.getfixturevalue("resnet50_ref") if name == "resnet50"
           else _ref_model(name, **kw))
    port = getattr(tmodels, name)(device="cpu", **kw)
    for ours, theirs in ((get_params(port), jfunc.get_params(ref)),
                         (get_buffers(port), jfunc.get_buffers(ref))):
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
            {k: tuple(v.shape) for k, v in theirs.items()}
    if name == "resnet50":
        params = get_params(port)
        assert len(params) == 161 and len(get_buffers(port)) == 106
        assert sum(p.numel() for p in params.values()) == 25_557_032


def test_models_are_the_same_for_a_seed_and_refuse_pretrained():
    a = tmodels.resnet18(num_classes=10, device="cpu", seed=3)
    b = tmodels.resnet18(num_classes=10, device="cpu", seed=3)
    c = tmodels.resnet18(num_classes=10, device="cpu", seed=4)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    with pytest.raises(NotImplementedError):
        tmodels.resnet50(pretrained=True, device="cpu")


def test_load_jax_params_checks_buffers():
    ref = _ref_model("resnet18", num_classes=10)
    port = tmodels.resnet18(num_classes=10, device="cpu")
    bufs = _np(jfunc.get_buffers(ref))
    with pytest.raises(KeyError):
        load_jax_params(port, _np(jfunc.get_params(ref)),
                        buffers={k: v for k, v in bufs.items()
                                 if k != "bn1._mean"})
    bufs["bn1._mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_jax_params(port, _np(jfunc.get_params(ref)), buffers=bufs)


@pytest.mark.parametrize("name,kw,shape", [
    ("LeNet", {}, (4, 1, 28, 28)),
    ("resnet18", {"num_classes": 10}, (2, 3, 32, 32))])
def test_carried_weights_and_buffers_give_the_same_eval_logits(name, kw,
                                                               shape):
    ref = _ref_model(name, **kw)
    rng = np.random.RandomState(1)
    for b in ref.buffers():  # non-trivial running statistics
        b._value = jnp.asarray(rng.rand(*b.shape).astype(np.float32) + 0.5)
    port = _port_model(name, ref, **kw)
    x = rng.randn(*shape).astype(np.float32)
    ref.eval()
    want = ref(paddle.to_tensor(x)).numpy()
    got = EvalStep(port)(torch.from_numpy(x))
    _rel_close(got, want, RESNET_REL_TOL)


def _lenet_batch():
    # bench_all.py's config #1 inputs
    rng = np.random.RandomState(0)
    return (rng.randn(64, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, 64).astype(np.int64))


@pytest.fixture(scope="module")
def lenet_runs():
    ref = _ref_model("LeNet")
    port = _port_model("LeNet", ref)
    xs, ys = _lenet_batch()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=ref.parameters())
    rstep = paddle.jit.TrainStep(ref, loss_fn=paddle.nn.CrossEntropyLoss(),
                                 optimizer=opt)
    ref_losses = [float(rstep((paddle.to_tensor(xs),),
                              (paddle.to_tensor(ys),)).numpy())
                  for _ in range(3)]
    rstep.sync_to_layer()
    step = TrainStep(port, CrossEntropyLoss(),
                     Adam(1e-3, parameters=port.parameters()), device="cpu")
    losses = [float(step((torch.from_numpy(xs),), (torch.from_numpy(ys),)))
              for _ in range(3)]
    return ref_losses, _np(jfunc.get_params(ref)), losses, port


@pytest.mark.parametrize("i", range(3))
def test_lenet_config1_loss_of_each_step_matches_reference(lenet_runs, i):
    ref_losses, _, losses, _ = lenet_runs
    assert abs(losses[i] - ref_losses[i]) <= LENET_LOSS_TOL
    assert losses[-1] < losses[0]


def test_lenet_config1_params_after_three_steps_match_reference(lenet_runs):
    _, ref_params, _, port = lenet_runs
    for name, p in get_params(port).items():
        err = float(np.abs(p.numpy() - ref_params[name]).max())
        assert err <= LENET_PARAM_TOL, (name, err)


def _resnet_batch(classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*RESNET_SHAPE).astype(np.float32),
            rng.randint(0, classes, (2, 1)).astype(np.int64))


def test_resnet18_momentum_steps_match_reference():
    ref = _ref_model("resnet18", num_classes=10)
    port = _port_model("resnet18", ref, num_classes=10)
    batches = [_resnet_batch(10, seed) for seed in (0, 1)]
    opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=ref.parameters())
    rstep = paddle.jit.TrainStep(ref, loss_fn=paddle.nn.CrossEntropyLoss(),
                                 optimizer=opt)
    ref_losses = [float(rstep((paddle.to_tensor(x),),
                              (paddle.to_tensor(y),)).numpy())
                  for x, y in batches]
    rstep.sync_to_layer()
    step = TrainStep(port, CrossEntropyLoss(),
                     Momentum(0.01, 0.9, parameters=port.parameters()),
                     device="cpu")
    losses = [float(step((torch.from_numpy(x),), (torch.from_numpy(y),)))
              for x, y in batches]
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= R18_LOSS_TOL * max(1.0, abs(want))
    ref_params = _np(jfunc.get_params(ref))
    for name, p in get_params(port).items():
        err = float(np.abs(p.numpy() - ref_params[name]).max())
        assert err <= R18_PARAM_TOL, (name, err)
    ref_bufs = _np(jfunc.get_buffers(ref))
    for name, b in get_buffers(port).items():
        _rel_close(b, ref_bufs[name], RESNET_REL_TOL)


def test_resnet18_bf16_amp_loss_curve_follows_the_reference():
    """Three Momentum steps under auto_cast(bf16) (O1, as config #2) on
    both sides. The port keeps the loss in f32; the reference's
    cross_entropy rounds each row's loss, and the mean, to the bf16
    logits' dtype (up to 2^-7 relative each at these magnitudes), and
    the two round activations at other points (the reference adds a bias
    after rounding the product), which the later steps' bf16 gradients
    carry on: measured 1.1%, 0.85% and 3.3% apart."""
    ref_amp = importlib.import_module("paddle_tpu.amp.auto_cast")
    ref = _ref_model("resnet18", num_classes=10)
    port = _port_model("resnet18", ref, num_classes=10)
    batches = [_resnet_batch(10, seed) for seed in range(3)]
    opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=ref.parameters())
    rstep = paddle.jit.TrainStep(ref, loss_fn=paddle.nn.CrossEntropyLoss(),
                                 optimizer=opt)
    with ref_amp.auto_cast(dtype="bfloat16"):
        ref_losses = [float(rstep((paddle.to_tensor(x),),
                                  (paddle.to_tensor(y),)).numpy())
                      for x, y in batches]
    step = TrainStep(port, CrossEntropyLoss(),
                     Momentum(0.01, 0.9, parameters=port.parameters()),
                     device="cpu")
    with amp.auto_cast(dtype="bfloat16"):
        losses = [step((torch.from_numpy(x),), (torch.from_numpy(y),))
                  for x, y in batches]
    assert all(l.dtype == torch.float32 for l in losses)
    for got, want in zip(losses, ref_losses):
        assert abs(float(got) - want) <= BF16_LOSS_RTOL * abs(want)


def _l2_rel(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref))


def test_resnet50_train_forward_gradients_and_statistics_match_reference(
        resnet50_ref):
    ref = resnet50_ref
    params, bufs = jfunc.get_params(ref), jfunc.get_buffers(ref)
    port = _port_model("resnet50", ref)
    x, _ = _resnet_batch(1000)
    apply = jfunc.functionalize(ref, training=True)
    out, vjp, new_bufs = jax.vjp(lambda p: apply(p, bufs, jnp.asarray(x)),
                                 params, has_aux=True)
    ct = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    (grads,) = vjp(jnp.asarray(ct))
    port.train()
    got = port(torch.from_numpy(x))
    got.backward(torch.from_numpy(ct))
    _rel_close(got, out, R50_FWD_TOL)
    for name, b in get_buffers(port).items():
        _rel_close(b, new_bufs[name], R50_FWD_TOL)
    _rel_close(port.fc.weight.grad, grads["fc.weight"], R50_FC_GRAD_TOL)
    for name, p in port.named_parameters():
        assert _l2_rel(p.grad, grads[name]) <= R50_GRAD_L2_TOL, name


def test_lenet_trains_on_mnist_through_the_dataloader():
    """tests/test_e2e_mnist.py's flow on the port: one epoch of the
    synthetic MNIST (32 batches of 64), then Accuracy on the test split."""
    np.random.seed(0)
    model = tmodels.LeNet(device="cpu")
    step = TrainStep(model, CrossEntropyLoss(),
                     Adam(1e-3, parameters=model.parameters()), device="cpu")
    loader = DataLoader(tds.MNIST(mode="train"), batch_size=64, shuffle=True,
                        drop_last=True, places="cpu")
    losses = [float(step((img,), (lbl,))) for img, lbl in loader]
    assert len(losses) == 32
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    acc = tmetric.Accuracy()
    evaluate = EvalStep(model)
    for img, lbl in DataLoader(tds.MNIST(mode="test"), batch_size=128,
                               places="cpu"):
        acc.update(acc.compute(evaluate(img), lbl))
    assert acc.accumulate() > 0.1


@pytest.mark.parametrize("name,kw,dropout", [
    ("vgg11", {"batch_norm": True, "num_classes": 10}, (2, 5)),
    ("mobilenet_v2", {"scale": 0.25, "num_classes": 10}, (0,))])
def test_vgg_and_mobilenet_forward_and_momentum_step_match_reference(
        name, kw, dropout):
    """Eval-mode logits from non-trivial running statistics, then one
    train-mode Momentum step through `TrainStep` on both sides (the
    classifier's dropouts set to p=0 on both: the packages draw masks
    from different generators): the loss, each parameter's update and the
    running statistics the step updated. See VGG_MOBILE_* for the
    bounds."""
    ref = _ref_model(name, **kw)
    rng = np.random.RandomState(1)
    for b in ref.buffers():
        b._value = jnp.asarray(rng.rand(*b.shape).astype(np.float32) + 0.5)
    port = _port_model(name, ref, **kw)
    for i in dropout:
        ref.classifier[i].p = 0.0
        port.classifier[i].p = 0.0
    x, y = _resnet_batch(10)
    ref.eval()
    want = ref(paddle.to_tensor(x)).numpy()
    ref.train()
    _rel_close(EvalStep(port)(torch.from_numpy(x)), want, VGG_MOBILE_TOL)
    params0 = _np(jfunc.get_params(ref))
    opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=ref.parameters())
    rstep = paddle.jit.TrainStep(ref, loss_fn=paddle.nn.CrossEntropyLoss(),
                                 optimizer=opt)
    ref_loss = float(rstep((paddle.to_tensor(x),),
                           (paddle.to_tensor(y),)).numpy())
    rstep.sync_to_layer()
    step = TrainStep(port, CrossEntropyLoss(),
                     Momentum(0.01, 0.9, parameters=port.parameters()),
                     device="cpu")
    loss = float(step((torch.from_numpy(x),), (torch.from_numpy(y),)))
    assert abs(loss - ref_loss) <= VGG_MOBILE_TOL * abs(ref_loss)
    ref_params = _np(jfunc.get_params(ref))
    for pname, p in get_params(port).items():
        got = p.numpy().astype(np.float64) - params0[pname]
        want = ref_params[pname].astype(np.float64) - params0[pname]
        err = np.linalg.norm(got - want)
        assert err <= VGG_MOBILE_UPDATE_L2 * np.linalg.norm(want) + \
            VGG_MOBILE_UPDATE_FLOOR * np.sqrt(want.size), pname
    ref_bufs = _np(jfunc.get_buffers(ref))
    for bname, b in get_buffers(port).items():
        _rel_close(b, ref_bufs[bname], VGG_MOBILE_TOL)
