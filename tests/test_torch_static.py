"""The static graph of the port (paddle_tpu_torch.static: Program,
program_guard, data, Executor.run / run_steps, static.nn, the program
state) against the reference's paddle_tpu.static on the CPU, with the
weights carried across by parameter name (``static.set_program_state``)
or through ``load_jax_params``:

- the fc programs of tests/test_e2e_mnist.py (an fc regression under SGD
  with a StepDecay scheduler, and under Adam): losses and parameters run
  by run; ``run_steps`` with per-step and stacked feeds against the same
  number of ``run`` calls and against the reference's ``run_steps``;
- resnet18 at 2 x 3 x 64 x 64 (32 x 32 is chaotic, see
  test_torch_vision.py) for three Momentum runs: losses, parameters and
  the running statistics, which both packages update at record time only
  (one-hot labels: the reference's hard-label cross entropy reads its
  label placeholder's record-time value in a program, which the port does
  not copy);
- fetch by name, ``clone(for_test)``, ``gradients`` / ``append_backward``
  fetches, ``data_norm`` across runs, a replay at another batch than the
  recorded one, the dropout mask drawn once, a forward program that leaves
  the weights alone, ``layer_norm`` as one op, ``FLAGS_check_nan_inf``, the
  refused clips, and the program-state functions.

Tolerances (f32, both sides in f32 in other orders): the fc programs'
losses and parameters 1e-5 relative (+1e-6 absolute); resnet18's losses
1e-4 relative (+1e-5 absolute), its parameters within 1e-5 + 1e-4 of
each tensor's largest magnitude (test_torch_vision.py holds two steps to
1e-5; a BatchNorm bias of ~5e-3 moves 1.6e-6 apart in three), its running
statistics 1e-6 (both sides keep the record-time values); layer_norm and
data_norm outputs 1e-5."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.jit.functionalize import get_buffers as jget_buffers
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import static
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByValue
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.nn.layer.common import Dropout, Linear
from paddle_tpu_torch.nn.param_attr import ParamAttr
from paddle_tpu_torch.vision.models import resnet18

CPU = "cpu"
TRUE_W = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)


@pytest.fixture(autouse=True)
def _reference_heartbeat_kept():
    """The reference's Executor beats its process-wide watchdog, and its
    ops server's /healthz reports a beat older than 60 s as stale: leave
    the last beat as the test found it, for the suites that run after
    this one in the same process."""
    from paddle_tpu.resilience import watchdog as jwatchdog

    saved = jwatchdog._last_beat
    yield
    jwatchdog._last_beat = saved


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    xb = rng.rand(n, 4).astype(np.float32)
    return xb, xb @ TRUE_W


def _fc_programs(make_opt, make_jopt, sched=False):
    """The e2e fc regression in both packages, with the reference's
    weights carried into the port by name."""
    paddle.seed(0)
    jmain, jstart = jstatic.Program(), jstatic.Program()
    with jstatic.program_guard(jmain, jstart):
        x = jstatic.data("x", [None, 4], "float32")
        y = jstatic.data("y", [None, 1], "float32")
        out = jstatic.nn.fc(x, 1, weight_attr=paddle.ParamAttr(name="fc_w"),
                            bias_attr=paddle.ParamAttr(name="fc_b"))
        jloss = paddle.nn.functional.mse_loss(out, y)
        jsched = (paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
                  if sched else None)
        make_jopt(jsched).minimize(jloss)
    main, start = static.Program(), static.Program()
    with static.program_guard(main, start):
        x = static.data("x", [None, 4], "float32", device=CPU)
        y = static.data("y", [None, 1], "float32", device=CPU)
        out = static.nn.fc(x, 1, weight_attr=ParamAttr(name="fc_w"),
                           bias_attr=ParamAttr(name="fc_b"))
        loss = ((out - y) ** 2).mean()
        tsched = (toptim.lr.StepDecay(0.1, step_size=2, gamma=0.5)
                  if sched else None)
        make_opt(tsched).minimize(loss)
    static.set_program_state(main, {p.name: np.asarray(p._value)
                                    for p in jmain.all_parameters()})
    return (jmain, jloss, jsched), (main, loss, tsched, out)


def _params(prog, ref=False):
    if ref:
        return {p.name: np.asarray(p._value) for p in prog.all_parameters()}
    return {static.param_name(p): p.detach().numpy()
            for p in prog.all_parameters()}


OPTIMIZERS = {
    "sgd_step_decay": (lambda s: toptim.SGD(learning_rate=s),
                       lambda s: paddle.optimizer.SGD(learning_rate=s), True),
    "adam": (lambda s: toptim.Adam(learning_rate=0.05),
             lambda s: paddle.optimizer.Adam(learning_rate=0.05), False),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_fc_program_matches_the_reference_run_by_run(name):
    make_opt, make_jopt, sched = OPTIMIZERS[name]
    (jmain, jloss, jsched), (main, loss, tsched, _) = _fc_programs(
        make_opt, make_jopt, sched)
    jexe, exe = jstatic.Executor(), static.Executor(static.CPUPlace())
    exe.run(static.default_startup_program())
    for i in range(6):
        xb, yb = _batch(seed=i)
        (jl,) = jexe.run(jmain, feed={"x": xb, "y": yb}, fetch_list=[jloss])
        (tl,) = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss])
        _close(tl, jl)
        if sched:
            jsched.step()
            tsched.step()
    jp, tp = _params(jmain, ref=True), _params(main)
    assert sorted(jp) == sorted(tp) == ["fc_b", "fc_w"]
    for k in jp:
        _close(tp[k], jp[k])


@pytest.mark.parametrize("stacked", [False, True])
def test_run_steps_matches_run_calls_and_the_reference(stacked):
    """A window of 4 steps with an LRScheduler sampled per step: per-step
    (the same batch every step) or stacked ([4, ...]) feeds."""
    n = 4
    make_opt, make_jopt, _ = OPTIMIZERS["sgd_step_decay"]
    batches = [_batch(seed=i) for i in range(n)]
    if stacked:
        feed = {"x": np.stack([b[0] for b in batches]),
                "y": np.stack([b[1] for b in batches])}
    else:
        feed = {"x": batches[0][0], "y": batches[0][1]}
        batches = [batches[0]] * n
    (jmain, jloss, jsched), (main, loss, tsched, _) = _fc_programs(
        make_opt, make_jopt, sched=True)
    window = static.Executor(static.CPUPlace()).run_steps(
        main, feed=feed, fetch_list=[loss], n_steps=n)[0]
    jwindow = jstatic.Executor().run_steps(
        jmain, feed=feed, fetch_list=[jloss], n_steps=n)[0]
    assert window.shape == (n,)
    _close(window, jwindow)
    window_params = _params(main)
    # the same steps as single runs, the scheduler stepped between them
    (_, _, _), (main2, loss2, tsched2, _) = _fc_programs(
        make_opt, make_jopt, sched=True)
    exe = static.Executor(static.CPUPlace())
    singles = []
    for i, (xb, yb) in enumerate(batches):
        if i:
            tsched2.step()
        singles.append(float(exe.run(main2, feed={"x": xb, "y": yb},
                                     fetch_list=[loss2])[0]))
    _close(window, singles, rtol=0, atol=0)
    for k, v in _params(main2).items():
        _close(window_params[k], v, rtol=0, atol=0)
    assert tsched.last_epoch == tsched2.last_epoch


def test_resnet18_program_three_runs_match_the_reference():
    """Config #2's machinery at a small size: resnet18 recorded in both
    packages, the reference's weights and (record-time) running
    statistics carried over, three Momentum runs."""
    rng = np.random.RandomState(0)
    xb = rng.randn(2, 3, 64, 64).astype(np.float32)
    # one-hot labels with soft_label: the reference's hard-label cross
    # entropy reads its label placeholder's record-time value in a program
    # (see the next test)
    yb = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)]
    paddle.seed(0)
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        x = jstatic.data("x", [None, 3, 64, 64], "float32")
        y = jstatic.data("y", [None, 10], "float32")
        jmodel = jmodels.resnet18(num_classes=10)
        jloss = paddle.nn.functional.cross_entropy(jmodel(x), y,
                                                   soft_label=True)
        paddle.optimizer.Momentum(0.01, 0.9).minimize(jloss)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 3, 64, 64], "float32", device=CPU)
        y = static.data("y", [None, 10], "float32", device=CPU)
        model = resnet18(num_classes=10, device=CPU)
        loss = cross_entropy(model(x), y, soft_label=True)
        toptim.Momentum(0.01, 0.9).minimize(loss)
    load_jax_params(model, {k: np.asarray(v) for k, v in
                            jget_params(jmodel).items()},
                    buffers={k: np.asarray(v) for k, v in
                             jget_buffers(jmodel).items()})
    jexe, exe = jstatic.Executor(), static.Executor(static.CPUPlace())
    for _ in range(3):
        (jl,) = jexe.run(jmain, feed={"x": xb, "y": yb}, fetch_list=[jloss])
        (tl,) = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss])
        _close(tl, jl, rtol=1e-4, atol=1e-5)
    tp = {k: v.detach().numpy() for k, v in model.named_parameters()}
    for k, v in jget_params(jmodel).items():
        v = np.asarray(v)
        np.testing.assert_allclose(tp[k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max() + 1e-5)
    # trap 2: the running statistics moved once, at record time, in both
    tb = {k: v.numpy() for k, v in model.named_buffers()}
    for k, v in jget_buffers(jmodel).items():
        np.testing.assert_allclose(tb[k], np.asarray(v), rtol=0, atol=1e-6)
    assert len(main.parameters) == len(list(model.parameters()))


def test_hard_label_cross_entropy_reads_the_fed_labels():
    """The reference's hard-label cross_entropy passes ``label.detach()``
    to its op, and its detach is not an op: in a program the label is the
    placeholder's record-time value (zeros at batch 1), whatever is fed.
    The port's recorder sees every torch call, so its program reads the
    fed labels, as eager code does (ROADMAP: reference behaviour not
    copied)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 10).astype(np.float32)
    yb = np.array([[3], [7]], np.int64)
    eager = float(cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(yb)))
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [None, 10], "float32")
        jy = jstatic.data("y", [None, 1], "int64")
        jl = paddle.nn.functional.cross_entropy(jx, jy)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 10], "float32", device=CPU)
        y = static.data("y", [None, 1], "int64", device=CPU)
        loss = cross_entropy(x, y)
    feed = {"x": logits, "y": yb}
    tl = static.Executor(static.CPUPlace()).run(main, feed=feed,
                                                fetch_list=[loss])[0]
    jref = float(jstatic.Executor().run(jmain, feed=feed,
                                        fetch_list=[jl])[0])
    _close(tl, eager)
    jeager = float(paddle.nn.functional.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(yb))._value)
    _close(jeager, eager)
    assert abs(jref - eager) > 1.0  # the reference's program differs


def test_fetch_by_name_clone_for_test_and_gradients():
    make_opt, make_jopt, _ = OPTIMIZERS["adam"]
    (jmain, jloss, _), (main, loss, _, out) = _fc_programs(make_opt,
                                                           make_jopt)
    w = next(p for p in main.all_parameters()
             if static.param_name(p) == "fc_w")
    with static.program_guard(main):
        (gw,) = static.gradients(loss, [w])
        pairs = static.append_backward(loss)
    jw = next(p for p in jmain.all_parameters() if p.name == "fc_w")
    with jstatic.program_guard(jmain):
        (jgw,) = jstatic.gradients(jloss, [jw])
    assert [p for p, _ in pairs][0] is w and pairs[0][1] is gw
    xb, yb = _batch()
    test = main.clone(for_test=True)
    before = _params(main)
    (pred,) = static.Executor(static.CPUPlace()).run(
        test, feed={"x": xb}, fetch_list=[out])
    for k, v in _params(main).items():
        _close(v, before[k], rtol=0, atol=0)
    _close(pred, xb @ before["fc_w"] + before["fc_b"])
    exe, jexe = static.Executor(static.CPUPlace()), jstatic.Executor()
    tl, ty, tg = exe.run(main, feed={"x": xb, "y": yb},
                         fetch_list=[loss, "y", gw])
    jl, jy, jg = jexe.run(jmain, feed={"x": xb, "y": yb},
                          fetch_list=[jloss, "y", jgw])
    _close(tl, jl)
    _close(ty, jy, rtol=0, atol=0)
    _close(tg, jg)
    assert "fc_w@GRAD" in main.vars_by_name
    assert "Program(ops=" in repr(main) and main.global_block().var("x") \
        is main.feed_vars["x"]


def test_data_norm_summaries_persist_across_runs():
    def jbuild():
        jmain = jstatic.Program()
        with jstatic.program_guard(jmain, jstatic.Program()):
            x = jstatic.data("x", [None, 3], "float32")
            h = jstatic.nn.data_norm(x)
            jl = (jstatic.nn.fc(h, 1) ** 2).mean()
            paddle.optimizer.SGD(0.1).minimize(jl)
        return jmain, jl, h

    jmain, jl, jh = jbuild()
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 3], "float32", device=CPU)
        h = static.nn.data_norm(x)
        loss = (static.nn.fc(h, 1) ** 2).mean()
        toptim.SGD(0.1).minimize(loss)
    jparams, tparams = jmain.all_parameters(), main.all_parameters()
    assert len(jparams) == len(tparams) == 5
    with torch.no_grad():
        for tp, jp in zip(tparams, jparams):
            tp.copy_(torch.from_numpy(np.array(jp._value)))
    exe, jexe = static.Executor(static.CPUPlace()), jstatic.Executor()
    rng = np.random.RandomState(0)
    for _ in range(3):
        xb = (rng.randn(5, 3) * 3 + 1).astype(np.float32)
        th, tl = exe.run(main, feed={"x": xb}, fetch_list=[h, loss])
        jh_, jl_ = jexe.run(jmain, feed={"x": xb}, fetch_list=[jh, jl])
        _close(th, jh_)
        _close(tl, jl_)
    for tp, jp in zip(tparams, jparams):
        _close(tp.detach().numpy(), np.asarray(jp._value))
    assert float(tparams[0][0]) > 1e4  # the batch-size summary grew


def test_dropout_mask_is_drawn_at_record_time_and_reused():
    """Trap 3: the mask is a program constant (both packages), broadcast
    over any fed batch."""
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 64], "float32", device=CPU)
        out = Dropout(0.5, torch.Generator().manual_seed(0))(x)
    exe = static.Executor(static.CPUPlace())
    xb = np.ones((4, 64), np.float32)
    a = exe.run(main, feed={"x": xb}, fetch_list=[out])[0]
    b = exe.run(main, feed={"x": xb}, fetch_list=[out])[0]
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) == {0.0, 2.0}
    np.testing.assert_array_equal(a, np.broadcast_to(a[:1], a.shape))
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [None, 64], "float32")
        jout = paddle.nn.functional.dropout(jx, 0.5, training=True)
    jexe = jstatic.Executor()
    ja = jexe.run(jmain, feed={"x": xb}, fetch_list=[jout])[0]
    np.testing.assert_array_equal(
        ja, jexe.run(jmain, feed={"x": xb}, fetch_list=[jout])[0])
    np.testing.assert_array_equal(ja, np.broadcast_to(ja[:1], ja.shape))


@pytest.mark.parametrize("batch", [1, 5, 7])
def test_replay_at_another_batch_than_recorded(batch):
    """Trap 4: placeholders record at batch 1; runs feed any batch."""
    make_opt, make_jopt, _ = OPTIMIZERS["adam"]
    (jmain, jloss, _), (main, loss, _, out) = _fc_programs(make_opt,
                                                           make_jopt)
    xb, yb = _batch(batch)
    tl, tout = static.Executor(static.CPUPlace()).run(
        main, feed={"x": xb, "y": yb}, fetch_list=[loss, out])
    jl, = jstatic.Executor().run(jmain, feed={"x": xb, "y": yb},
                                 fetch_list=[jloss])
    assert tout.shape == (batch, 1)
    _close(tl, jl)


def test_forward_program_leaves_the_weights_alone():
    """Trap 5: parameters made inside the guard (a layer's in-place
    initialisation, static.nn's factories) are not program ops."""
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 8], "float32", device=CPU)
        lin = Linear(8, 8, device=CPU, generator=torch.Generator()
                     .manual_seed(1))
        out = static.nn.fc(lin(x), 4, activation="relu")
    recorded = {static.param_name(p): p.detach().clone()
                for p in main.all_parameters()}
    assert len(recorded) == 4
    assert all(not op.name.endswith("_") for op in main.ops), main.ops
    exe = static.Executor(static.CPUPlace())
    xb = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    r1 = exe.run(main, feed={"x": xb}, fetch_list=[out])[0]
    r2 = exe.run(main, feed={"x": xb}, fetch_list=[out])[0]
    np.testing.assert_array_equal(r1, r2)
    for p in main.all_parameters():
        assert torch.equal(p, recorded[static.param_name(p)])


def test_layer_norm_is_recorded_as_one_op():
    """Trap 1: the port's LayerNorm Function records as one op, which
    replays as its .apply (the kernel on the card)."""
    xb = np.random.RandomState(0).randn(6, 16).astype(np.float32)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 16], "float32", device=CPU)
        out = static.nn.layer_norm(x)
    assert [op.name for op in main.ops] == ["_LayerNormFn.apply"]
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [None, 16], "float32")
        jout = jstatic.nn.layer_norm(jx)
    tout = static.Executor(static.CPUPlace()).run(
        main, feed={"x": xb}, fetch_list=[out])[0]
    _close(tout, jstatic.Executor().run(jmain, feed={"x": xb},
                                        fetch_list=[jout])[0])


def test_check_nan_inf_raises_after_the_commit():
    make_opt, make_jopt, _ = OPTIMIZERS["adam"]
    _, (main, loss, _, _) = _fc_programs(make_opt, make_jopt)
    xb, yb = _batch()
    xb[0, 0] = np.nan
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="NaN or Inf"):
            static.Executor(static.CPUPlace()).run(
                main, feed={"x": xb, "y": yb}, fetch_list=[loss])
    finally:
        tflags.set_flags({"FLAGS_check_nan_inf": False})


@pytest.mark.parametrize("clip", ["value", "global_norm"])
def test_clips_under_the_static_executor(clip):
    """ClipGradByValue is refused (the reference skips it silently); a
    global-norm clip runs as the reference's does."""
    (jmain, jloss, _), (main, loss, _, _) = _fc_programs(
        lambda s: toptim.SGD(0.1, grad_clip=(
            ClipGradByValue(0.01) if clip == "value"
            else ClipGradByGlobalNorm(0.05))),
        lambda s: paddle.optimizer.SGD(0.1, grad_clip=paddle.nn.
                                       ClipGradByGlobalNorm(0.05)))
    xb, yb = _batch()
    exe = static.Executor(static.CPUPlace())
    if clip == "value":
        with pytest.raises(NotImplementedError, match="ClipGradByValue"):
            exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss])
        return
    jexe = jstatic.Executor()
    for _ in range(2):
        _close(exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss])[0],
               jexe.run(jmain, feed={"x": xb, "y": yb},
                        fetch_list=[jloss])[0])
    for k, v in _params(jmain, ref=True).items():
        _close(_params(main)[k], v)


def test_program_state_save_load_and_serialize(tmp_path):
    make_opt, make_jopt, _ = OPTIMIZERS["adam"]
    (jmain, _, _), (main, loss, _, out) = _fc_programs(make_opt, make_jopt)
    saved = _params(main)
    static.save(main, str(tmp_path / "m"))
    state = static.load_program_state(str(tmp_path / "m"))
    assert sorted(state) == ["fc_b", "fc_w"]
    blob = static.serialize_persistables([], [], program=main)
    with torch.no_grad():
        for p in main.all_parameters():
            p.zero_()
    static.load(main, str(tmp_path / "m"))
    for k, v in _params(main).items():
        _close(v, saved[k], rtol=0, atol=0)
    with torch.no_grad():
        for p in main.all_parameters():
            p.zero_()
    static.deserialize_persistables(main, blob)
    for k, v in _params(main).items():
        _close(v, saved[k], rtol=0, atol=0)
    static.save_vars(None, str(tmp_path / "vars"), main)
    with torch.no_grad():
        for p in main.all_parameters():
            p.zero_()
    static.load_vars(None, str(tmp_path / "vars"), main)
    for k, v in _params(main).items():
        _close(v, saved[k], rtol=0, atol=0)
    static.save_to_file(str(tmp_path / "b"), blob)
    assert static.load_from_file(str(tmp_path / "b")) == blob
    # the reference's state carries over by name; normalize_program prunes
    static.set_program_state(main, _params(jmain, ref=True))
    for k, v in _params(jmain, ref=True).items():
        _close(_params(main)[k], v, rtol=0, atol=0)
    pruned = static.normalize_program(main, [main.feed_vars["x"]], [out])
    assert len(pruned.ops) < len(main.ops)
    assert list(pruned.feed_vars) == ["x"]
    assert len(pruned.all_parameters()) == 2


def test_placement_and_what_is_not_ported(tmp_path):
    """Nothing moves between devices silently; the functions that wait
    for later modules raise, naming them; save_inference_model, which
    waited for the export, serves what it saved."""
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 4], "float32", device="meta")
        out = x * 2
    with pytest.raises(ValueError, match="placeholder x is on meta"):
        static.Executor(static.CPUPlace()).run(
            main, feed={"x": np.ones((1, 4), np.float32)}, fetch_list=[out])
    with pytest.raises(ValueError, match="placeholders are on"):
        with static.program_guard(main):
            static.data("z", [1], device=CPU)
    # save_inference_model, which waited for the export: the placeholder
    # on the CPU round-trips through the .pdexport
    served = static.Program()
    with static.program_guard(served):
        y = static.data("y", [None, 4], "float32", device=CPU)
        out2 = y * 2 + 1
    prefix = str(tmp_path / "p")
    static.save_inference_model(prefix, [y], [out2], program=served)
    pred, feeds, fetches = static.load_inference_model(
        prefix, static.Executor(static.CPUPlace()))
    assert (feeds, fetches) == (["y"], ["output0"])
    yb = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(pred.run([yb])[0], yb * 2 + 1)
    with pytest.raises(ValueError, match="placeholders"):
        static.save_inference_model(prefix, [out2], [out2], program=served)
    with pytest.raises(NotImplementedError, match="io/data_feed.py"):
        static.Executor(static.CPUPlace()).train_from_dataset(main)
    with pytest.raises(NotImplementedError, match="group_norm"):
        static.nn.group_norm(x, 2)
    with pytest.raises(ValueError, match="parameters is required"):
        toptim.SGD(0.1)


# -- static.nn against the reference ---------------------------------------------
def _nn_cases():
    """name -> (build(pkg, st, data) -> outputs, feeds as numpy)."""
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    probs = rng.rand(6, 5).astype(np.float32)
    return {
        "fc_flatten_dims": (lambda P, st, d: [st.nn.fc(
            d("x", [None, 2, 3], "float32"), 4, num_flatten_dims=2,
            activation="relu")], {"x": f32(3, 2, 3)}),
        "conv2d": (lambda P, st, d: [st.nn.conv2d(
            d("x", [None, 3, 8, 8], "float32"), 4, 3, padding=1,
            act="relu")], {"x": f32(2, 3, 8, 8)}),
        "conv2d_transpose": (lambda P, st, d: [st.nn.conv2d_transpose(
            d("x", [None, 3, 5, 5], "float32"), 2, filter_size=3,
            stride=2)], {"x": f32(2, 3, 5, 5)}),
        "conv3d": (lambda P, st, d: [st.nn.conv3d(
            d("x", [None, 2, 4, 4, 4], "float32"), 3, 3, padding=1)],
            {"x": f32(2, 2, 4, 4, 4)}),
        "conv3d_transpose": (lambda P, st, d: [st.nn.conv3d_transpose(
            d("x", [None, 2, 3, 3, 3], "float32"), 2, filter_size=2)],
            {"x": f32(2, 2, 3, 3, 3)}),
        "batch_norm": (lambda P, st, d: [st.nn.batch_norm(
            d("x", [None, 3, 4, 4], "float32"), act="relu")],
            {"x": f32(4, 3, 4, 4) * 2 + 1}),
        "embedding": (lambda P, st, d: [st.nn.embedding(
            d("ids", [None, 5], "int64"), [10, 4], padding_idx=0)],
            {"ids": rng.randint(0, 10, (3, 5)).astype(np.int64)}),
        "layer_norm_dims": (lambda P, st, d: [st.nn.layer_norm(
            d("x", [None, 3, 4], "float32"), begin_norm_axis=1)],
            {"x": f32(2, 3, 4)}),
        "prelu_all": (lambda P, st, d: [st.nn.prelu(
            d("x", [None, 3, 4], "float32"), "all")], {"x": f32(2, 3, 4)}),
        "prelu_channel": (lambda P, st, d: [st.nn.prelu(
            d("x", [None, 3, 4], "float32"), "channel")],
            {"x": f32(2, 3, 4)}),
        "prelu_element": (lambda P, st, d: [st.nn.prelu(
            d("x", [None, 3, 4], "float32"), "element")],
            {"x": f32(2, 3, 4)}),
        "bilinear_tensor_product": (lambda P, st, d: [
            st.nn.bilinear_tensor_product(d("x", [None, 3], "float32"),
                                          d("y", [None, 4], "float32"), 2,
                                          act="tanh")],
            {"x": f32(5, 3), "y": f32(5, 4)}),
        "conv_shift": (lambda P, st, d: [st.nn.conv_shift(
            d("x", [None, 5], "float32"), d("y", [None, 3], "float32"))],
            {"x": f32(2, 5), "y": f32(2, 3)}),
        "accuracy": (lambda P, st, d: list(_accuracy(
            st, d("p", [None, 5], "float32"), d("l", [None, 1], "int64"))),
            {"p": probs, "l": rng.randint(0, 5, (6, 1)).astype(np.int64)}),
        "auc": (lambda P, st, d: [st.auc(
            d("p", [None, 2], "float32"), d("l", [None, 1], "int64"))[0]],
            {"p": np.stack([1 - probs[:, 0], probs[:, 0]], 1),
             "l": (probs[:, 1:2] > 0.5).astype(np.int64)}),
        "py_func": (lambda P, st, d: _py_func(st, d("x", [None, 3],
                                                    "float32")),
                    {"x": f32(4, 3)}),
        "create_parameter": (lambda P, st, d: [
            d("x", [None, 3], "float32") @ _param(st, [3, 2])],
            {"x": f32(4, 3)}),
    }


def _accuracy(st, p, lbl):
    correct = st.create_global_var([1], 0, "int64")
    total = st.create_global_var([1], 0, "int64")
    acc = st.accuracy(p, lbl, k=2, correct=correct, total=total)
    return acc, correct, total


def _py_func(st, x):
    out = st.create_global_var([4, 3], 0.0, "float32")
    return [st.py_func(lambda a: np.tanh(a) * 2, x, out) * 1.0]


def _param(st, shape):
    return st.nn.create_parameter(shape, "float32", **(
        {"device": CPU} if st is static else {}))


# static.nn cases where the reference's program is not its eager
# function (ROADMAP: reference behaviour not copied), with the eager value
# the port's program is held to instead: the reference's embedding
# gathers with ``x.detach()``, not an op, so its program reads the ids
# placeholder's record-time zeros; its 'element' prelu multiplies by an
# alpha flattened to [1, C*L, 1], which does not broadcast
REF_NN_DIFFERS = {
    "embedding": lambda feed, params: (
        params[0][feed["ids"]] * (feed["ids"] != 0)[..., None]),
    "prelu_element": lambda feed, params: np.where(
        feed["x"] > 0, feed["x"], params[0] * feed["x"]),
}


@pytest.mark.parametrize("name", sorted(_nn_cases()))
def test_static_nn_layer_matches_the_reference(name):
    """Each static.nn function recorded in both packages, the reference's
    parameters carried over in program order, run once on a feed (f32:
    1e-5)."""
    build, feed = _nn_cases()[name]
    if name in REF_NN_DIFFERS:
        main = static.Program()
        with static.program_guard(main):
            outs = build(torch, static,
                         lambda n, s, d: static.data(n, s, d, device=CPU))
        got = static.Executor(static.CPUPlace()).run(main, feed=feed,
                                                     fetch_list=outs)[0]
        params = [p.detach().numpy() for p in main.all_parameters()]
        _close(got, REF_NN_DIFFERS[name](feed, params))
        jmain = jstatic.Program()
        if name == "prelu_element":
            with pytest.raises(TypeError):
                with jstatic.program_guard(jmain, jstatic.Program()):
                    build(paddle, jstatic, jstatic.data)
            return
        with jstatic.program_guard(jmain, jstatic.Program()):
            jouts = build(paddle, jstatic, jstatic.data)
        want = jstatic.Executor().run(jmain, feed=feed, fetch_list=jouts)[0]
        assert want.shape != got.shape  # the placeholder's batch of 1
        return
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jouts = build(paddle, jstatic, jstatic.data)
    main = static.Program()
    with static.program_guard(main):
        outs = build(torch, static,
                     lambda n, s, d: static.data(n, s, d, device=CPU))
    jparams, tparams = jmain.all_parameters(), main.all_parameters()
    assert [tuple(p.shape) for p in tparams] == [tuple(p.shape)
                                                 for p in jparams]
    with torch.no_grad():
        for tp, jp in zip(tparams, jparams):
            tp.copy_(torch.from_numpy(np.array(jp._value)))
    got = static.Executor(static.CPUPlace()).run(main, feed=feed,
                                                 fetch_list=outs)
    want = jstatic.Executor().run(jmain, feed=feed, fetch_list=jouts)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


def test_mode_switches():
    """enable_static / disable_static / in_dynamic_mode and the dygraph
    aliases. The reference's disable_static is a no-op, so its mode stays
    static after it; the port's turns static mode off."""
    import paddle_tpu_torch as pt

    assert pt.in_dynamic_mode()
    pt.enable_static()
    try:
        assert not pt.in_dynamic_mode()
        pt.disable_static()
        assert pt.in_dynamic_mode()
        pt.disable_dygraph()
        assert not pt.in_dynamic_mode()
        pt.enable_dygraph()
        assert pt.in_dynamic_mode()
    finally:
        pt.disable_static()
    paddle.enable_static()
    try:
        paddle.disable_static()
        assert not paddle.in_dynamic_mode()
    finally:
        jstatic._disable_static_mode()
    assert paddle.in_dynamic_mode()


def test_a_run_inside_program_guard_records_nothing():
    main = static.Program()
    exe = static.Executor(static.CPUPlace())
    with static.program_guard(main):
        x = static.data("x", [None, 3], "float32", device=CPU)
        out = static.nn.fc(x, 2)
        n_ops = len(main.ops)
        r = exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                    fetch_list=[out])[0]
        assert len(main.ops) == n_ops
        out2 = out * 2  # recording goes on after the run
    assert len(main.ops) == n_ops + 1
    np.testing.assert_allclose(
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[out2])[0], 2 * r)


def test_executor_telemetry_scope_and_shims(capsys):
    from paddle_tpu_torch.profiler.telemetry import get_telemetry

    tel = get_telemetry()
    compiles = tel.counter_value("executor/compiles")
    runs = tel.counter_value("executor/runs")
    make_opt, make_jopt, _ = OPTIMIZERS["adam"]
    _, (main, loss, _, out) = _fc_programs(make_opt, make_jopt)
    with static.program_guard(main), static.name_scope("printed"):
        shown = static.Print(out, message="fc out")
    compiled = static.CompiledProgram(main).with_data_parallel(
        loss_name="loss", build_strategy=static.BuildStrategy(),
        exec_strategy=static.ExecutionStrategy())
    exe = static.Executor(static.CPUPlace())
    xb, yb = _batch()
    for _ in range(2):
        exe.run(compiled, feed={"x": xb, "y": yb}, fetch_list=[loss])
    exe.run_steps(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                  n_steps=3)
    exe.run(main.clone(for_test=True), feed={"x": xb}, fetch_list=[shown])
    assert "fc out" in capsys.readouterr().out
    # one plan for the training program (run and run_steps share it),
    # one for its test clone
    assert tel.counter_value("executor/compiles") - compiles == 2
    assert tel.counter_value("executor/runs") - runs == 6
    assert tel.hist_summary("executor/step_ms") is not None
    scope = static.global_scope()
    scope.var("w").get_tensor().set(np.ones(3), static.CPUPlace())
    with static.scope_guard(scope) as s:
        assert s.find_var("w").get_tensor().shape() == [3]
    assert [type(p).__name__ for p in static.cpu_places()] == ["CPUPlace"]
    assert static.default_main_program() is not main


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_recorded_layer_norm_runs_its_kernels_on_the_card(cuda_device):
    """A program recorded on the card replays the LayerNorm kernels:
    one forward launch a run, and the backward's two in a training run;
    the output within the kernel's f32 tolerance of its plain version
    (chip_smoke's LN_TOL, 1e-5)."""
    from paddle_tpu_torch.ops import fused

    xb = np.random.RandomState(0).randn(64, 1024).astype(np.float32)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 1024], "float32", device=cuda_device)
        out = static.nn.layer_norm(x)
        loss = (out * out).mean()
        toptim.Adam(1e-3).minimize(loss)
    exe = static.Executor(cuda_device)
    fwd, bwd = fused.fused_layer_norm.launches, fused.layer_norm_bwd.launches
    got = exe.run(main.clone(for_test=True), feed={"x": xb},
                  fetch_list=[out])[0]
    assert fused.fused_layer_norm.launches == fwd + 1
    exe.run(main, feed={"x": xb}, fetch_list=[loss])
    torch.cuda.synchronize()
    assert fused.fused_layer_norm.launches == fwd + 2
    assert fused.layer_norm_bwd.launches == bwd + 2
    ref = fused._ln_reference(torch.from_numpy(xb), torch.ones(1024),
                              torch.zeros(1024))
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["Constant", "Assign", "Dirac", "Normal",
                                  "TruncatedNormal", "Uniform",
                                  "XavierUniform", "XavierNormal",
                                  "KaimingUniform", "KaimingNormal",
                                  "Orthogonal"])
def test_initializers_against_the_reference(name):
    """The deterministic initializers give the reference's values; the
    random ones (drawn from another generator than the reference's key)
    its bounds or moments over 20k values, and the orthogonal one
    orthonormal rows."""
    import importlib

    from paddle_tpu_torch.nn import initializer as TI

    JI = importlib.import_module("paddle_tpu.nn.initializer")
    shape = {"Dirac": (4, 3, 3, 3), "Orthogonal": (8, 16)}.get(
        name, (100, 200))
    args = {"Constant": (0.5,), "Assign": (np.arange(20000).reshape(
        100, 200).astype(np.float32),), "Uniform": (-0.3, 0.3),
        "Normal": (1.0, 2.0), "TruncatedNormal": (0.0, 0.5)}.get(name, ())
    got = getattr(TI, name)(*args)(shape, torch.float32, "cpu",
                                   torch.Generator().manual_seed(0))
    want = np.asarray(getattr(JI, name)(*args)(shape, "float32"))
    assert got.shape == want.shape and got.dtype == torch.float32
    g = got.numpy()
    if name in ("Constant", "Assign", "Dirac"):
        np.testing.assert_array_equal(g, want)
    elif name == "Orthogonal":
        np.testing.assert_allclose(g @ g.T, np.eye(8), atol=1e-5)
    elif name in ("Uniform", "XavierUniform", "KaimingUniform"):
        assert np.abs(g).max() <= np.abs(want).max() * 1.001
        assert np.abs(g).max() >= np.abs(want).max() * 0.99
    else:
        np.testing.assert_allclose(g.mean(), want.mean(), atol=0.05)
        np.testing.assert_allclose(g.std(), want.std(), rtol=0.05)
