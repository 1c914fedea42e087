"""The high-level API of the port (paddle_tpu_torch.hapi: Model, the
callbacks, summary; with framework.io checkpoints, the optimizers' state
dicts, the device prefetcher and the preemption exit) against the
reference's, on the CPU:

- LeNet as the reference's own end-to-end test trains it
  (`Model(LeNet()).prepare(Adam(1e-3), CrossEntropyLoss(), Accuracy())`,
  `fit(MNIST train, batch_size=64, num_iters=20)`), from the reference's
  weights (`load_jax_params`) and the same batch order (numpy's global
  seed): each step's loss and accuracy, the final parameters, then
  `evaluate`'s loss and accuracy and `predict`'s outputs;
- the callbacks: EarlyStopping's stop epoch and mode, the LRScheduler
  callback's steps and `fit`'s per-epoch scheduler step, `num_iters`
  over epochs, ModelCheckpoint's files;
- resume: 1 epoch, `save`, a fresh Model and Adam, `load`, 1 more epoch
  gives the bits of 2 uninterrupted epochs (parameters, Adam's moments and
  beta powers, the scheduler's state); `fit(prefetch_depth=2)` gives the
  bits of `prefetch_depth=0`;
- a bf16 master-mode step that a checkpoint is loaded into takes its next
  step from the loaded weights (`refresh_from_layer`);
- `prepare(amp_configs=...)` raises; `summary`'s totals are the
  reference's for LeNet, VGG-16 and MobileNetV2;
- a SIGTERM during `fit` writes `preempt.pdparams/.pdopt` and exits with
  the relaunch code; a relaunch with the same `save_dir` consumes them
  once.

Tolerances (f32; the two packages sum in other orders), measured on the
CPU in brackets: per-step losses within 1e-5 over the 20 steps (6.0e-7),
the parameters after them within 1e-4 (1.0e-6; Adam divides by sqrt(v),
so an element whose gradient is near 0 can move by a visible share of
lr), evaluate's loss within 1e-5 (3.3e-7) and predict's logits within
1e-4 of their largest magnitude (6.5e-7); accuracies and argmaxes
exactly. Resume, prefetch and the master-mode reload: bit for bit.
"""
import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision.datasets import MNIST as JMNIST
import paddle_tpu_torch as pt
from paddle_tpu_torch import callbacks as tcb
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.framework import load, save
from paddle_tpu_torch.io import Subset
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear, ReLU, Sequential
from paddle_tpu_torch.nn import set_state_dict
from paddle_tpu_torch.optimizer import Adam, lr as tlr
from paddle_tpu_torch.resilience import EXIT_PREEMPTED
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.datasets import MNIST
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
LOGIT_REL_TOL = 1e-4


def _np(d):
    return {k: np.array(v, dtype=np.float32) for k, v in d.items()}


class _Recorder:
    """Each train batch's logs, for either package's callback class."""

    def __init__(self):
        self.logs = []

    def on_train_batch_end(self, step, logs=None):
        self.logs.append(dict(logs))


def _recorder(base):
    return type("Recorder", (_Recorder, base), {
        "__init__": lambda self: (base.__init__(self),
                                  _Recorder.__init__(self))[0]})()


@pytest.fixture(scope="module")
def lenet_fit():
    """Both packages' Model on LeNet, from the same weights and batches."""
    paddle.seed(0)
    rnet = jmodels.LeNet()
    rmodel = paddle.Model(rnet)
    rmodel.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                         parameters=rmodel.parameters()),
                   paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    tnet = load_jax_params(tmodels.LeNet(device="cpu"),
                           _np(jfunc.get_params(rnet)))
    tmodel = pt.Model(tnet)
    tmodel.prepare(Adam(1e-3, parameters=tmodel.parameters()),
                   CrossEntropyLoss(), Accuracy())
    rrec, trec = _recorder(jcb.Callback), _recorder(tcb.Callback)
    np.random.seed(0)
    rmodel.fit(JMNIST(mode="train"), epochs=1, batch_size=64, verbose=0,
               num_iters=20, callbacks=[rrec])
    np.random.seed(0)
    tmodel.fit(MNIST(mode="train"), epochs=1, batch_size=64, verbose=0,
               num_iters=20, callbacks=[trec])
    out = {"rlogs": rrec.logs, "tlogs": trec.logs,
           "rparams": _np(jfunc.get_params(rnet)),
           "tparams": get_params(tnet)}
    out["reval"] = rmodel.evaluate(JMNIST(mode="test"), batch_size=64,
                                   verbose=0, num_iters=4)
    out["teval"] = tmodel.evaluate(MNIST(mode="test"), batch_size=64,
                                   verbose=0, num_iters=4)
    out["rpred"] = rmodel.predict(JMNIST(mode="test"), batch_size=128,
                                  stack_outputs=True)
    out["tpred"] = tmodel.predict(MNIST(mode="test"), batch_size=128,
                                  stack_outputs=True)
    return out


@pytest.mark.parametrize("i", range(0, 20, 4))
def test_lenet_fit_loss_and_accuracy_of_each_step_match_reference(
        lenet_fit, i):
    r, t = lenet_fit["rlogs"], lenet_fit["tlogs"]
    assert len(r) == len(t) == 20
    assert abs(t[i]["loss"] - r[i]["loss"]) <= LOSS_TOL
    assert t[i]["acc"] == pytest.approx(float(r[i]["acc"]), abs=1e-7)
    assert t[i]["step"] == r[i]["step"] == i


def test_lenet_fit_final_params_match_reference(lenet_fit):
    for name, p in lenet_fit["tparams"].items():
        err = float(np.abs(p.numpy() - lenet_fit["rparams"][name]).max())
        assert err <= PARAM_TOL, (name, err)
    losses = [l["loss"] for l in lenet_fit["tlogs"]]
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_lenet_evaluate_and_predict_match_reference(lenet_fit):
    r, t = lenet_fit["reval"], lenet_fit["teval"]
    assert set(t) == set(r) == {"loss", "acc"}
    assert abs(t["loss"] - r["loss"]) <= LOSS_TOL
    assert float(t["acc"]) == pytest.approx(float(r["acc"]), abs=1e-7)
    (rp,), (tp,) = lenet_fit["rpred"], lenet_fit["tpred"]
    assert tp.shape == rp.shape == (512, 10)
    assert np.abs(tp - rp).max() <= LOGIT_REL_TOL * np.abs(rp).max()
    np.testing.assert_array_equal(tp.argmax(-1), rp.argmax(-1))


# --- callbacks -------------------------------------------------------------
class _Holder:
    stop_training = False


@pytest.mark.parametrize("monitor,values,kw", [
    ("loss", [1.0, 0.9, 0.95, 0.91, 0.92, 0.5], {"patience": 2}),
    ("acc", [0.1, 0.3, 0.29, 0.3, 0.31], {"patience": 1,
                                          "min_delta": 0.05}),
    ("loss", [3.0, 2.0, 2.5], {"patience": 0})])
def test_early_stopping_stops_at_the_reference_epoch(monitor, values, kw):
    stops = []
    for mod in (jcb, tcb):
        cb = mod.EarlyStopping(monitor=monitor, **kw)
        cb.set_model(_Holder())
        stop = None
        for epoch, v in enumerate(values):
            # the eval_<monitor> fallback: only the eval value is logged
            cb.on_epoch_end(epoch, {f"eval_{monitor}": v})
            if cb.model.stop_training and stop is None:
                stop = epoch
        stops.append((stop, cb.mode, cb.best))
    assert stops[0] == stops[1]
    assert stops[1][1] == ("max" if "acc" in monitor else "min")


def _tiny_fit(mod, model_cls, opt_cls, sched_cls, loss_cls, data, epochs,
              num_iters, callbacks, **fit_kw):
    sched = sched_cls(learning_rate=0.1, step_size=1, gamma=0.5)
    net = model_cls()
    model = mod.Model(net)
    model.prepare(opt_cls(learning_rate=sched,
                          parameters=model.parameters()), loss_cls())
    rec = callbacks[0]
    model.fit(data, batch_size=8, epochs=epochs, verbose=0, shuffle=False,
              num_iters=num_iters, callbacks=callbacks, **fit_kw)
    return sched.last_epoch, len(rec.logs)


@pytest.mark.parametrize("by_step,epochs,num_iters", [
    (True, 2, None), (False, 2, None), (True, 3, 3)])
def test_lr_scheduler_callback_and_num_iters_follow_the_reference(
        by_step, epochs, num_iters):
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 6).astype(np.float32)
    ys = rng.randint(0, 3, (32, 1)).astype(np.int64)
    from paddle_tpu.io.dataset import TensorDataset as JTD
    from paddle_tpu_torch.io import TensorDataset as TTD

    got = []
    for mod, ds, model_cls, opt, sched, loss, cbmod in (
            (paddle, JTD([paddle.to_tensor(xs), paddle.to_tensor(ys)]),
             lambda: paddle.nn.Linear(6, 3), paddle.optimizer.SGD,
             paddle.optimizer.lr.StepDecay, paddle.nn.CrossEntropyLoss, jcb),
            (pt, TTD([torch.from_numpy(xs), torch.from_numpy(ys)]),
             lambda: Linear(6, 3, generator=torch.Generator()),
             __import__("paddle_tpu_torch.optimizer",
                        fromlist=["SGD"]).SGD,
             tlr.StepDecay, CrossEntropyLoss, tcb)):
        cbs = [_recorder(cbmod.Callback),
               cbmod.LRScheduler(by_step=by_step, by_epoch=not by_step)]
        got.append(_tiny_fit(mod, model_cls, opt, sched, loss, ds, epochs,
                             num_iters, cbs))
    assert got[0] == got[1]
    steps = got[1][1]
    # fit's own per-epoch step on top of the callback's
    assert got[1][0] == (steps if by_step else epochs) + epochs
    assert steps == (4 * epochs if num_iters is None
                     else num_iters + epochs - 1)


def test_model_checkpoint_and_save_dir_write_the_reference_files(tmp_path):
    ds = Subset(MNIST(mode="train"), list(range(128)))
    net = tmodels.LeNet(device="cpu")
    model = pt.Model(net).prepare(Adam(1e-3, parameters=net.parameters()),
                                  CrossEntropyLoss())
    model.fit(ds, batch_size=64, epochs=2, verbose=0,
              save_dir=str(tmp_path / "fit"),
              callbacks=[tcb.ModelCheckpoint(save_dir=str(tmp_path / "mc"))])
    want = {f"{e}.{x}" for e in ("0", "1") for x in ("pdparams", "pdopt")}
    assert set(os.listdir(tmp_path / "fit")) == want
    assert set(os.listdir(tmp_path / "mc")) == want | {
        "final.pdparams", "final.pdopt"}


def test_prepare_refuses_amp_configs():
    net = tmodels.LeNet(device="cpu")
    with pytest.raises(NotImplementedError, match="amp_configs"):
        pt.Model(net).prepare(Adam(parameters=net.parameters()),
                              CrossEntropyLoss(), amp_configs={"level": "O1"})


# --- resume and prefetch, bit for bit ------------------------------------
def _lenet_model(seed=0):
    net = tmodels.LeNet(device="cpu", seed=seed)
    sched = tlr.StepDecay(1e-3, step_size=1, gamma=0.5)
    model = pt.Model(net).prepare(Adam(sched, parameters=net.parameters()),
                                  CrossEntropyLoss(), Accuracy())
    return model


def _state(model):
    opt = model._optimizer.state_dict()
    return ({k: v.clone() for k, v in model.network.state_dict().items()},
            {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in opt.items()})


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def small_mnist():
    return Subset(MNIST(mode="train"), list(range(256)))


def test_resume_from_checkpoint_equals_uninterrupted_training(
        small_mnist, tmp_path):
    kw = dict(batch_size=64, verbose=0, shuffle=False)
    whole = _lenet_model()
    whole.fit(small_mnist, epochs=2, **kw)
    first = _lenet_model()
    first.fit(small_mnist, epochs=1, **kw)
    first.save(str(tmp_path / "ck"))
    resumed = _lenet_model(seed=5)  # other weights: all of them come back
    resumed.load(str(tmp_path / "ck"))
    resumed.fit(small_mnist, epochs=1, **kw)
    (wp, wo), (rp, ro) = _state(whole), _state(resumed)
    _assert_same_bits(wp, rp)
    _assert_same_bits(wo, ro)
    assert wo["global_step"] == 8 and "fc.2.bias__beta1_pow" in wo
    assert wo["LR_Scheduler"]["last_epoch"] == 2


def test_fit_with_prefetch_matches_without(small_mnist):
    runs = []
    for depth in (0, 2):
        np.random.seed(3)
        model = _lenet_model()
        model.fit(small_mnist, batch_size=64, epochs=2, verbose=0,
                  prefetch_depth=depth)
        runs.append(_state(model))
    _assert_same_bits(runs[0][0], runs[1][0])
    _assert_same_bits(runs[0][1], runs[1][1])
    import threading
    assert not [t for t in threading.enumerate()
                if t.name == "DevicePrefetcher" and t.is_alive()]


def test_loaded_checkpoint_starts_the_next_bf16_master_step(tmp_path):
    """ParallelTrainStep in master mode (bf16 compute, f32 masters): a
    checkpoint loaded into the layer must be what the next step runs on,
    not the stale masters of the steps since."""
    gen = torch.Generator().manual_seed(0)

    def build():
        return Sequential(Linear(8, 16, generator=gen), ReLU(),
                          Linear(16, 4, generator=gen))

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rng.randint(0, 4, 6).astype(np.int64))
    net = build()
    opt = Adam(1e-2, parameters=net.parameters(), multi_precision=True)
    step = ParallelTrainStep(net, CrossEntropyLoss(), opt, device="cpu",
                             compute_dtype=torch.bfloat16)
    for _ in range(2):
        step((x,), (y,))
    step.sync_to_layer()
    save(net.state_dict(), str(tmp_path / "w.pdparams"))
    ckpt = {k: v.clone() for k, v in net.state_dict().items()}
    for _ in range(2):  # the masters move on
        step((x,), (y,))
    step.sync_to_layer()
    missing, unexpected = set_state_dict(net, load(str(tmp_path /
                                                       "w.pdparams")))
    assert missing == [] and unexpected == []
    step.refresh_from_layer()
    loss = step((x,), (y,))
    # a fresh master-mode step on the checkpoint's weights: the same loss
    fresh_net = build()
    set_state_dict(fresh_net, ckpt)
    fresh = ParallelTrainStep(
        fresh_net, CrossEntropyLoss(),
        Adam(1e-2, parameters=fresh_net.parameters(), multi_precision=True),
        device="cpu", compute_dtype=torch.bfloat16)
    assert torch.equal(loss, fresh((x,), (y,)))


@pytest.mark.parametrize("name,shape", [
    ("LeNet", (1, 1, 28, 28)), ("mobilenet_v2", (1, 3, 64, 64)),
    ("vgg16", (1, 3, 64, 64))])
def test_summary_totals_match_reference(name, shape, capsys):
    paddle.seed(0)
    want = paddle.summary(getattr(jmodels, name)(), shape)
    got = pt.summary(getattr(tmodels, name)(device="cpu"), shape)
    assert got == want
    assert "Total params" in capsys.readouterr().out


# --- preemption ------------------------------------------------------------
_PREEMPT_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import callbacks as cb
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.resilience import install_preemption_handler
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    class Term(cb.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 2 and {kill}:
                os.kill(os.getpid(), signal.SIGTERM)

    install_preemption_handler()
    net = LeNet(device="cpu")
    model = pt.Model(net).prepare(Adam(1e-3, parameters=net.parameters()),
                                  CrossEntropyLoss())
    model.fit(Subset(MNIST(mode="train"), list(range(512))), batch_size=64,
              verbose=0, shuffle=False, save_dir={save_dir!r},
              num_iters={num_iters}, callbacks=[Term()])
    print("GLOBAL_STEP", model._optimizer._global_step)
""")


def test_sigterm_writes_preempt_files_and_a_relaunch_consumes_them(
        tmp_path):
    save_dir = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def run(kill, num_iters):
        code = _PREEMPT_SCRIPT.format(repo=_REPO, kill=kill,
                                      save_dir=save_dir, num_iters=num_iters)
        return subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=180)

    first = run(True, None)
    assert first.returncode == EXIT_PREEMPTED, first.stderr
    assert sorted(os.listdir(save_dir)) == ["preempt.pdopt",
                                            "preempt.pdparams"]
    saved = load(os.path.join(save_dir, "preempt.pdopt"))
    assert saved["global_step"] == 3  # the SIGTERM came after step 3
    again = run(False, 1)
    assert again.returncode == 0, again.stderr
    # loaded once (3 steps) and one more taken; the files are gone
    assert "GLOBAL_STEP 4" in again.stdout
    assert not [f for f in os.listdir(save_dir) if f.startswith("preempt")]
