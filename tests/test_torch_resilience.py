"""The port's guarded training (the engines' `check_finite` /
`guard_updates`, paddle_tpu_torch.resilience: StepGuard, the watchdog,
the fault injector, preemption spills, incubate.checkpoint) on the CPU,
against the reference's engines and its own `tests/test_resilience.py` /
`test_sanitizer.py` scenarios (minus the static graph, the mesh and
`distributed.launch`).

Guarded steps: the reference's and the port's engines, both built with
`guard_updates=True` from the same weights, see a NaN batch (an MLP) or
an update that overflows (lr 3.4e38: AdamW's decay and step on f32
parameters, and bf16 master mode on a small GPT, where the new master
rounds to inf in bf16). Both keep their state — the port bit for bit —
and name the same leaves; the losses of the later steps agree within
`tests/test_torch_train.py`'s f32 tolerance (1e-5)."""
import importlib
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.amp import AmpScaler
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.incubate import checkpoint as tckpt
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.jit.train_step import EvalStep, TrainStep
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.optimizer.lr import NoamDecay
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.resilience import (EXIT_PREEMPTED, FaultInjector,
                                         RecoveryPolicy, StepGuard,
                                         active_injector, clear_injector,
                                         clear_preemption_request,
                                         install_injector, install_watchdog,
                                         load_quarantine, quarantine_batch,
                                         replay_quarantine,
                                         uninstall_preemption_handler,
                                         uninstall_watchdog)
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# tests/test_torch_train.py's f32 loss tolerance: the same math in
# another summation order
LOSS_TOL = 1e-5
# an lr at the top of f32's range: an Adam step moves an element by
# about lr, so a decayed or bf16-cast new value overflows while every
# gradient stays finite
LR_OVERFLOW = 3.4e38


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _ref_net(seed=0, din=8, dout=4):
    paddle.seed(seed)
    return jnn.Linear(din, dout)


def _np_params(ref_net):
    return {k: np.asarray(v) for k, v in jfunc.get_params(ref_net).items()}


def _port_net(ref_net):
    w = _np_params(ref_net)
    din, dout = w["weight"].shape
    net = tnn.Linear(din, dout, device="cpu")
    return load_jax_params(net, w)


def _batches(n, seed=0, din=8, dout=4):
    rng = np.random.RandomState(seed)
    return ([rng.randn(16, din).astype("float32") for _ in range(n)],
            [rng.randn(16, dout).astype("float32") for _ in range(n)])


def _build_step(guard=True, engine=TrainStep, opt_cls=Adam, lr=1e-2,
                ref_net=None, **kw):
    net = _port_net(ref_net or _ref_net())
    opt = opt_cls(learning_rate=lr, parameters=net.parameters())
    extra = {} if engine is TrainStep else {"device": "cpu"}
    if engine is TrainStep:
        kw.setdefault("device", "cpu")
    return engine(net, _mse, opt, guard_updates=guard, **extra, **kw)


def _state_bits(step):
    snap = step.snapshot_state()
    flat = {}
    for group in ("params", "buffers"):
        for n, t in snap[group].items():
            flat[f"{group}/{n}"] = t
    for n, st in snap["opt_state"].items():
        for k, t in st.items():
            flat[f"opt/{n}/{k}"] = t
    return flat


def _assert_bits_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _host_params(step):
    return {n: t.float().numpy() for n, t in
            step.snapshot_state()["params"].items()}


# ---------------------------------------------------------------------------
# guarded steps against the reference's engines
# ---------------------------------------------------------------------------
def _ref_mlp_run(opt_cls, lr_at_2):
    net = _ref_net()
    opt = opt_cls(learning_rate=1e-2, parameters=net.parameters())
    step = JTrainStep(net, _mse, opt, guard_updates=True)
    xs, ys = _batches(5)
    losses, names = [], None
    for i in range(5):
        x = xs[i].copy()
        if i == 2 and lr_at_2 is None:
            x[0, 0] = np.nan
        if i == 2 and lr_at_2 is not None:
            opt.set_lr(lr_at_2)
        before = {k: np.asarray(v) for k, v in step._params.items()}
        losses.append(float(np.asarray(step((x,), (ys[i],)).numpy())))
        if i == 2:
            ok, names = step.last_step_finite()
            assert not ok
            after = {k: np.asarray(v) for k, v in step._params.items()}
            for k in before:
                np.testing.assert_array_equal(after[k], before[k])
            if lr_at_2 is not None:
                opt.set_lr(1e-2)
    return losses, names


@pytest.mark.parametrize("engine", [TrainStep, ParallelTrainStep])
@pytest.mark.parametrize("case", ["nan_batch", "overflowing_lr"])
def test_guarded_bad_step_keeps_state_and_names_leaves_as_reference(
        engine, case):
    opt_cls = {"nan_batch": (paddle.optimizer.Adam, Adam),
               "overflowing_lr": (paddle.optimizer.AdamW, AdamW)}[case]
    lr_at_2 = LR_OVERFLOW if case == "overflowing_lr" else None
    ref_losses, ref_bad = _ref_mlp_run(opt_cls[0], lr_at_2)
    step = _build_step(engine=engine, opt_cls=opt_cls[1])
    xs, ys = _batches(5)
    losses = []
    for i in range(5):
        x = xs[i].copy()
        if i == 2 and lr_at_2 is None:
            x[0, 0] = np.nan
        if i == 2 and lr_at_2 is not None:
            step._optimizer.set_lr(lr_at_2)
        before = _state_bits(step)
        losses.append(float(step((x,), (ys[i],))))
        if i == 2:
            ok, bad = step.last_step_finite()
            assert not ok and bad == ref_bad
            if case == "overflowing_lr":  # finite gradients, bad updates
                assert not any(n.startswith("grad") for n in bad)
                assert any(n.startswith("param") for n in bad)
                step._optimizer.set_lr(1e-2)
            _assert_bits_equal(_state_bits(step), before)
            # the step count advances, as in the reference
            assert step._optimizer._global_step == 3
    for i in (0, 1, 3, 4):
        assert abs(losses[i] - ref_losses[i]) <= LOSS_TOL, (i, losses,
                                                             ref_losses)


def _gpt_cfg(mod):
    return mod.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                         num_heads=4, max_position_embeddings=256,
                         hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def gpt_overflow_runs():
    """Step 0 of a small GPT (GPT-2 tiny's widths, 2 layers: the
    reference's guarded engine compiles in half the time of 4) at lr
    3.4e38 in bf16 master mode through both engines (the new masters
    round to inf in bf16), then 2 steps at lr 1e-3."""
    paddle.seed(7)
    jmodel = jgpt.GPTForCausalLM(_gpt_cfg(jgpt))
    p0 = {k: np.asarray(v, np.float32)
          for k, v in jfunc.get_params(jmodel).items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    jopt = paddle.optimizer.Adam(learning_rate=LR_OVERFLOW,
                                 parameters=jmodel.parameters(),
                                 multi_precision=True)
    jstep = JStep(jmodel, lambda out, lbl: out, jopt,
                  mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                  compute_dtype=jnp.bfloat16, guard_updates=True)
    ref_losses, ref_bad = [], None
    for i in range(3):
        ref_losses.append(float(np.asarray(
            jstep((ids, labels), (labels,)).numpy())))
        if i == 0:
            ref_bad = jstep.last_step_finite()[1]
            jopt.set_lr(1e-3)
    model = load_jax_params(tgpt.GPTForCausalLM(_gpt_cfg(tgpt),
                                                device="cpu"), p0)
    opt = Adam(LR_OVERFLOW, parameters=model.parameters(),
               multi_precision=True)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                             compute_dtype=torch.bfloat16,
                             guard_updates=True)
    tids, tlab = (torch.from_numpy(a).long() for a in (ids, labels))
    before = _state_bits(step)
    losses = [float(step((tids, tlab), (tlab,)))]
    bad = step.last_step_finite()[1]
    kept = _state_bits(step)
    opt.set_lr(1e-3)
    losses += [float(step((tids, tlab), (tlab,))) for _ in range(2)]
    return ref_losses, ref_bad, losses, bad, before, kept


def test_gpt_bf16_master_overflow_is_kept_out_bit_for_bit(gpt_overflow_runs):
    _, _, _, bad, before, kept = gpt_overflow_runs
    assert bad and all(n.startswith("param[") for n in bad)
    assert any(k.endswith("/master") for k in before)
    _assert_bits_equal(kept, before)


def test_gpt_bf16_master_overflow_names_the_reference_leaves(
        gpt_overflow_runs):
    _, ref_bad, _, bad, _, _ = gpt_overflow_runs
    assert bad == ref_bad


def test_gpt_bf16_master_losses_after_the_kept_step_follow_reference(
        gpt_overflow_runs):
    ref_losses, _, losses, _, _, _ = gpt_overflow_runs
    # bf16 compute: tests/test_torch_train.py's bf16 loss tolerance
    np.testing.assert_allclose(losses, ref_losses, atol=0.04, rtol=0)


def test_guarded_momentum_step_restores_its_copied_state():
    step = _build_step(opt_cls=Momentum)
    xs, ys = _batches(3)
    step((xs[0],), (ys[0],))
    before = _state_bits(step)
    bad = xs[1].copy()
    bad[3, 2] = np.inf
    step((bad,), (ys[1],))
    ok, names = step.last_step_finite()
    assert not ok and "loss" in names
    _assert_bits_equal(_state_bits(step), before)


def test_guarded_batchnorm_buffers_are_restored():
    net = tnn.Sequential(tnn.Linear(8, 4, device="cpu"),
                         tnn.BatchNorm1D(4, device="cpu"))
    load_jax_params(net[0], _np_params(_ref_net()))
    opt = Adam(1e-2, parameters=net.parameters())
    step = TrainStep(net, _mse, opt, device="cpu", guard_updates=True)
    xs, ys = _batches(2)
    step((xs[0],), (ys[0],))
    before = _state_bits(step)
    assert any(k.startswith("buffers/") for k in before)
    bad = xs[1].copy()
    bad[0, 0] = np.nan
    step((bad,), (ys[1],))
    assert not step.last_step_finite()[0]
    _assert_bits_equal(_state_bits(step), before)


# ---------------------------------------------------------------------------
# check_finite (the reference's test_sanitizer)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", [TrainStep, ParallelTrainStep])
def test_check_finite_raises_located_after_committing(engine):
    step = _build_step(guard=False, engine=engine, check_finite=True)
    xs, ys = _batches(2)
    step((xs[0],), (ys[0],))
    x = xs[1].copy()
    x[0, 0] = np.inf
    with pytest.raises(FloatingPointError, match="loss") as e:
        step((x,), (ys[1],))
    assert "grad['weight']" in str(e.value)
    # the update was committed (params now non-finite) and the step count
    # stayed, as the reference's raise comes before its increment
    assert not np.isfinite(_host_params(step)["weight"]).all()
    assert step._optimizer._global_step == 1


def test_check_finite_flag_is_read_when_the_engine_is_built():
    from paddle_tpu_torch.core.flags import set_flags

    set_flags({"FLAGS_check_nan_inf": True})
    try:
        step = _build_step(guard=False)
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    xs, ys = _batches(1)
    xs[0][0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        step((xs[0],), (ys[0],))
    off = _build_step(guard=False)
    off((xs[0],), (ys[0],))  # flag off at build: no check
    assert off.last_step_finite() == (True, [])


def test_check_finite_window_raises_after_the_window():
    step = _build_step(guard=False, engine=ParallelTrainStep,
                       check_finite=True)
    xs, ys = _batches(3)
    xs[1][0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        step.run_steps((np.stack(xs),), (np.stack(ys),))
    assert step._optimizer._global_step == 0


def test_eval_step_takes_numpy_inputs():
    step = _build_step(guard=False)
    out = EvalStep(step._layer)(np.ones((2, 8), np.float32))
    assert out.shape == (2, 4)


# ---------------------------------------------------------------------------
# StepGuard (the reference's TestStepGuardNaN)
# ---------------------------------------------------------------------------
def test_skip_quarantine_backoff_rollback(tmp_path):
    tel = get_telemetry()
    before = {k: tel.counter_value(f"resilience/{k}") for k in
              ("nonfinite_steps", "rollbacks", "quarantined_batches")}
    step = _build_step()
    scaler = AmpScaler(enable=True, init_loss_scaling=1024.0)
    qdir = str(tmp_path / "q")
    guard = StepGuard(step, RecoveryPolicy(max_consecutive_bad=1,
                                           snapshot_every=1,
                                           quarantine_dir=qdir),
                      scaler=scaler, injector=FaultInjector(nan_steps=[2]))
    xs, ys = _batches(6)
    for i in range(6):
        if i == 2:
            kept = _state_bits(step)
        guard((xs[i],), (ys[i],))
        if i == 2:  # the snapshot (taken after step 1) is the kept state
            _assert_bits_equal(_state_bits(step), kept)
    assert guard.step_count == 6
    assert all(np.isfinite(v).all() for v in _host_params(step).values())
    for k, n in (("nonfinite_steps", 1), ("rollbacks", 1),
                 ("quarantined_batches", 1)):
        assert tel.counter_value(f"resilience/{k}") == before[k] + n
    assert scaler.get_init_loss_scaling() == 512.0
    assert os.listdir(qdir) == ["step-2.npz"]
    qpath = os.path.join(qdir, "step-2.npz")
    _, _, meta = load_quarantine(qpath)
    assert meta["step"] == 2 and "loss" in meta["bad"]
    ok, bad = replay_quarantine(_build_step(), qpath)
    assert not ok and "loss" in bad


def test_bad_step_skips_update_exactly():
    """An uninjected twin that skips batch 2 equals the guarded run whose
    batch 2 went NaN, bit for bit."""
    xs, ys = _batches(5)
    ref = _build_step()
    gref = StepGuard(ref, RecoveryPolicy(quarantine_dir=None))
    for i in range(5):
        if i != 2:
            gref((xs[i],), (ys[i],))
    inj = _build_step()
    ginj = StepGuard(inj, RecoveryPolicy(max_consecutive_bad=1,
                                         snapshot_every=1,
                                         quarantine_dir=None),
                     injector=FaultInjector(nan_steps=[2]))
    for i in range(5):
        ginj((xs[i],), (ys[i],))
    for k, v in _host_params(ref).items():
        np.testing.assert_array_equal(_host_params(inj)[k], v)


def test_rollback_restores_the_snapshot_bits():
    step = _build_step()
    guard = StepGuard(step, RecoveryPolicy(max_consecutive_bad=2,
                                           snapshot_every=100,
                                           quarantine_dir=None),
                      injector=FaultInjector(nan_steps=[1, 2]))
    xs, ys = _batches(3)
    snap = _state_bits(step)  # the first call snapshots the load state
    guard((xs[0],), (ys[0],))
    assert not all(torch.equal(a, snap[k])
                   for k, a in _state_bits(step).items())
    guard((xs[1],), (ys[1],))
    guard((xs[2],), (ys[2],))  # the second bad step in a row: rollback
    _assert_bits_equal(_state_bits(step), snap)


def test_gives_up_after_max_rollbacks(tmp_path):
    step = _build_step()
    guard = StepGuard(step, RecoveryPolicy(
        max_consecutive_bad=1, max_rollbacks=2, snapshot_every=1,
        quarantine_dir=str(tmp_path / "q")),
        injector=FaultInjector(nan_steps=[0, 1, 2, 3, 4]))
    xs, ys = _batches(5)
    with pytest.raises(FloatingPointError, match="giving up after 2"):
        for i in range(5):
            guard((xs[i],), (ys[i],))


def test_requires_guarded_engine():
    with pytest.raises(ValueError, match="guard_updates=True"):
        StepGuard(_build_step(guard=False))


def test_policy_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_GUARD_K", "5")
    monkeypatch.setenv("PADDLE_TPU_GUARD_SNAPSHOT_EVERY", "7")
    pol = RecoveryPolicy.from_env(max_rollbacks=9)
    assert (pol.max_consecutive_bad, pol.snapshot_every,
            pol.max_rollbacks) == (5, 7, 9)


def test_structured_batch_roundtrips_through_quarantine(tmp_path):
    feats = {"ids": np.arange(6, dtype=np.float32).reshape(2, 3),
             "mask": torch.ones((2, 3), dtype=torch.int64)}
    path = quarantine_batch(str(tmp_path), 5, (feats,),
                            (torch.zeros(2, dtype=torch.bfloat16),),
                            ["loss"])
    ins, labs, meta = load_quarantine(path)
    assert isinstance(ins, tuple) and isinstance(ins[0], dict)
    np.testing.assert_array_equal(ins[0]["ids"], feats["ids"])
    assert ins[0]["mask"].dtype == np.int64
    np.testing.assert_array_equal(labs[0], np.zeros(2, np.float32))
    assert meta["step"] == 5 and meta["bad"] == ["loss"]


# ---------------------------------------------------------------------------
# the watchdog, the injector, preemption, checkpoints
# ---------------------------------------------------------------------------
def test_watchdog_dumps_on_an_injected_slow_step(tmp_path):
    dumps = []
    tel = get_telemetry()
    before = tel.counter_value("resilience/watchdog_dumps")
    step = _build_step()
    guard = StepGuard(step, RecoveryPolicy(quarantine_dir=None),
                      injector=FaultInjector(slow_steps={1: 0.6}))
    xs, ys = _batches(3)
    guard((xs[0],), (ys[0],))
    wd = install_watchdog(0.15, abort=False, on_timeout=dumps.append,
                          dump_dir=str(tmp_path), poll_s=0.02)
    try:
        for i in range(1, 3):
            guard((xs[i],), (ys[i],))
        assert wd.fired and len(dumps) == 1
        assert "MainThread" in dumps[0] and "maybe_slow" in dumps[0]
        assert "-- telemetry --" in dumps[0]
        assert "compute (compute)" in dumps[0]
        assert os.path.exists(tmp_path / f"watchdog-{os.getpid()}.txt")
        assert tel.counter_value("resilience/watchdog_dumps") == before + 1
    finally:
        uninstall_watchdog()


def test_heartbeats_keep_the_watchdog_quiet():
    import time

    fired = []
    wd = install_watchdog(0.2, abort=False, on_timeout=fired.append,
                          poll_s=0.02)
    try:
        for i in range(5):
            wd.beat(i)
            time.sleep(0.05)
        assert not wd.fired and not fired and wd.last_step == 4
    finally:
        uninstall_watchdog()


def test_injector_spec_parsing_and_bad_kind():
    inj = FaultInjector.from_spec("nan@3,sigterm@7,slow@5:1.5,"
                                  "kill_worker@2,bitflip_param@4:1,"
                                  "slow_rank@6:1:0.5,deadline_storm@20:3")
    assert inj.nan_steps == {3} and inj.sigterm_steps == {7}
    assert inj.slow_steps == {5: 1.5} and inj.kill_worker_batches == {2}
    assert inj.bitflip_param_steps == {4: 1}
    assert inj.slow_rank_steps == {6: (1, 0.5)}
    assert inj.storm_req_ids == {20, 21, 22}
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultInjector.from_spec("explode@1")
    with pytest.raises(ValueError, match="slow_rank needs"):
        FaultInjector.from_spec("slow_rank@1")


def test_corrupt_batch_poisons_one_float_leaf_once():
    inj = FaultInjector(nan_steps=[1])
    ids = torch.arange(4)
    x = torch.ones(2, 3)
    batch = ((ids, x), {"y": np.ones(3, np.float32)})
    assert inj.corrupt_batch(0, batch) is batch
    out = inj.corrupt_batch(1, batch)
    assert torch.equal(out[0][0], ids)
    assert torch.isnan(out[0][1][0, 0]) and torch.isfinite(x).all()
    np.testing.assert_array_equal(out[1]["y"], np.ones(3))
    assert inj.corrupt_batch(1, batch) is batch  # one-shot


def test_state_dir_markers_survive_processes(tmp_path):
    a = FaultInjector(sigterm_steps=[3], state_dir=str(tmp_path))
    assert a._once("sigterm@3") and not a._once("sigterm@3")
    b = FaultInjector(sigterm_steps=[3], state_dir=str(tmp_path))
    assert not b._once("sigterm@3")  # a relaunch does not fire again


def test_injector_from_env_and_install(monkeypatch):
    clear_injector()
    monkeypatch.setenv("PADDLE_TPU_INJECT", "nan@2")
    try:
        assert active_injector().nan_steps == {2}
        install_injector(None)
        assert active_injector() is None
    finally:
        clear_injector()


def test_sigterm_spill_and_resume_match_the_uninjected_run(tmp_path):
    xs, ys = _batches(6)
    ref = _build_step()
    gref = StepGuard(ref, RecoveryPolicy(quarantine_dir=None))
    for i in range(6):
        gref((xs[i],), (ys[i],))
    spill = str(tmp_path / "emergency")
    try:
        first = _build_step()
        g1 = StepGuard(first, RecoveryPolicy(spill_path=spill,
                                             quarantine_dir=None),
                       injector=FaultInjector(sigterm_steps=[3])
                       ).install_preemption()
        with pytest.raises(SystemExit) as exc:
            for i in range(g1.resume(), 6):
                g1((xs[i],), (ys[i],))
        assert exc.value.code == EXIT_PREEMPTED
        clear_preemption_request()
        second = _build_step()
        g2 = StepGuard(second, RecoveryPolicy(spill_path=spill,
                                              quarantine_dir=None))
        assert g2.resume() == 3
        for i in range(3, 6):
            g2((xs[i],), (ys[i],))
        _assert_bits_equal(_state_bits(second), _state_bits(ref))
    finally:
        uninstall_preemption_handler()


def test_resume_restores_the_lr_schedule_position(tmp_path):
    spill = str(tmp_path / "em")

    def build():
        net = _port_net(_ref_net())
        sched = NoamDecay(d_model=64, warmup_steps=100)
        opt = Adam(learning_rate=sched, parameters=net.parameters())
        return TrainStep(net, _mse, opt, device="cpu",
                         guard_updates=True), sched

    xs, ys = _batches(6)
    try:
        step1, sched1 = build()
        g1 = StepGuard(step1, RecoveryPolicy(spill_path=spill,
                                             quarantine_dir=None),
                       injector=FaultInjector(sigterm_steps=[4])
                       ).install_preemption()
        with pytest.raises(SystemExit):
            for i in range(6):
                g1((xs[i],), (ys[i],))
                sched1.step()
        clear_preemption_request()
        step2, sched2 = build()
        g2 = StepGuard(step2, RecoveryPolicy(spill_path=spill,
                                             quarantine_dir=None))
        assert g2.resume() == 4
        assert step2._optimizer._global_step == \
            step1._optimizer._global_step
        assert sched2.last_epoch == sched1.last_epoch
    finally:
        uninstall_preemption_handler()


def test_preemption_flag_from_a_real_sigterm():
    from paddle_tpu_torch.resilience import (install_preemption_handler,
                                             preemption_requested)

    assert not preemption_requested()
    h = install_preemption_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert preemption_requested()
        assert h.received_signum == signal.SIGTERM
    finally:
        uninstall_preemption_handler()
    assert not preemption_requested()


def test_train_state_roundtrips_bf16_and_survives_a_crashed_swap(tmp_path):
    state = {"w": torch.randn(3, 4).bfloat16(), "n": np.arange(3),
             "meta": {"step": 7}}
    path = str(tmp_path / "ck")
    tckpt.save_train_state(state, path)
    got = tckpt.restore_train_state(path)
    back = torch.empty(3, 4, dtype=torch.bfloat16).copy_(got["w"])
    assert torch.equal(back, state["w"])
    np.testing.assert_array_equal(got["n"], np.arange(3))
    assert got["meta"] == {"step": 7}
    # a crash between the two renames leaves only the .tmp-old survivor
    os.rename(path, path + ".tmp-old")
    assert tckpt.restore_train_state(path)["meta"] == {"step": 7}
    tckpt.save_train_state({"v": np.ones(2)}, path)
    assert not os.path.exists(path + ".tmp-old")


def test_save_retries_a_transient_oserror(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CKPT_RETRY_BASE", "0.01")
    real = tckpt._write_dir
    fails = [2]

    def flaky(directory, state):
        if fails[0] > 0:
            fails[0] -= 1
            raise OSError("transient fs blip")
        return real(directory, state)

    monkeypatch.setattr(tckpt, "_write_dir", flaky)
    tel = get_telemetry()
    before = tel.counter_value("resilience/io_retries")
    path = str(tmp_path / "ck")
    tckpt.save_train_state({"w": np.arange(4.0)}, path)
    np.testing.assert_array_equal(tckpt.restore_train_state(path)["w"],
                                  [0, 1, 2, 3])
    assert tel.counter_value("resilience/io_retries") == before + 2


def test_train_epoch_range_resumes_after_the_last_saved_epoch(tmp_path):
    root = str(tmp_path / "auto")
    state = {"w": torch.zeros(2)}

    def get():
        return {"w": state["w"].clone()}

    def put(s):
        state["w"] = s["w"].clone()

    seen = []
    for epoch in tckpt.train_epoch_range(5, root, get, put, keep_max=2):
        state["w"] += 1
        seen.append(epoch)
        if epoch == 2:
            break  # the job dies inside epoch 2, after epoch 1's save
    state["w"] = torch.zeros(2)
    rest = list(tckpt.train_epoch_range(5, root, get, put, keep_max=2))
    assert seen == [0, 1, 2] and rest == [2, 3, 4]
    assert torch.equal(state["w"], torch.full((2,), 2.0))
    saver = tckpt.CheckpointSaver(root)
    assert saver.latest() == 4 and saver.latest_meta() == {"epoch": 4}
    assert len(saver.numbers()) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("opt_cls", [Adam, Momentum])
def test_cuda_guarded_bad_step_keeps_every_bit(cuda_device, opt_cls):
    """Adam's check pass gates its kernel; Momentum's plain route sweeps
    with the multi-tensor kernel's finite mode and restores its copy."""
    from paddle_tpu_torch.ops import fused, tree_reduce

    net = _port_net(_ref_net()).to(cuda_device)
    opt = opt_cls(learning_rate=1e-2, parameters=net.parameters())
    step = TrainStep(net, _mse, opt, guard_updates=True)
    xs, ys = _batches(3)
    step((xs[0],), (ys[0],))
    before = _state_bits(step)
    counts = (fused.adam_finite_check.launches,
              tree_reduce.tree_reduce.launches)
    bad = xs[1].copy()
    bad[2, 3] = np.nan
    step((bad,), (ys[1],))
    ok, names = step.last_step_finite()
    assert not ok and "loss" in names
    _assert_bits_equal(_state_bits(step), before)
    after = (fused.adam_finite_check.launches,
             tree_reduce.tree_reduce.launches)
    assert after[0] - counts[0] == (2 if opt_cls is Adam else 0)
    assert after[1] - counts[1] == (0 if opt_cls is Adam else 2)
    step((xs[2],), (ys[2],))
    assert step.last_step_finite() == (True, [])
