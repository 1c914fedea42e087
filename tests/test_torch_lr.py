"""The port's learning-rate schedulers (paddle_tpu_torch.optimizer.lr)
against the reference's: each of the 16 classes over 30 `step()` calls
and over `step(epoch)` jumps, to 1e-12 (the same Python arithmetic), and
a `state_dict` round trip; an optimizer reads its scheduler's value at
each step and refuses `set_lr`."""
import math

import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.optimizer import lr as tlr
import torch_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-12
STEPS = 30
EPOCHS = (0, 3, 7, 2, 15, 40, 11)


def _cases():
    """(id, class name, args, kwargs) — every scheduler, and the modes
    that take other branches of its arithmetic."""
    return [
        ("noam", "NoamDecay", (64, 5), dict(learning_rate=2.0)),
        ("piecewise", "PiecewiseDecay", ([3, 6, 9], [0.1, 0.05, 0.01, 1e-3]),
         {}),
        ("natural_exp", "NaturalExpDecay", (0.5, 0.1), {}),
        ("inverse_time", "InverseTimeDecay", (0.5, 0.1), {}),
        ("polynomial", "PolynomialDecay", (0.5, 10),
         dict(end_lr=0.01, power=2.0)),
        ("polynomial_cycle", "PolynomialDecay", (0.5, 7),
         dict(end_lr=0.01, power=1.5, cycle=True)),
        ("linear_warmup", "LinearWarmup", (0.5, 5, 0.0, 0.5), {}),
        ("exponential", "ExponentialDecay", (0.5, 0.9), {}),
        ("multistep", "MultiStepDecay", (0.5, [5, 10, 20]),
         dict(gamma=0.5)),
        ("step", "StepDecay", (0.5, 4), dict(gamma=0.5)),
        ("lambda", "LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
        ("cosine", "CosineAnnealingDecay", (0.5, 10), dict(eta_min=0.01)),
        ("multiplicative", "MultiplicativeDecay", (0.5, lambda e: 0.9),
         {}),
        ("one_cycle", "OneCycleLR", (0.5, 20), {}),
        ("one_cycle_linear", "OneCycleLR", (0.5, 20),
         dict(anneal_strategy="linear", phase_pct=0.4)),
        ("cyclic", "CyclicLR", (0.01, 0.5, 4), dict(step_size_down=3)),
        ("cyclic_triangular2", "CyclicLR", (0.01, 0.5, 4),
         dict(mode="triangular2")),
        ("cyclic_exp_range", "CyclicLR", (0.01, 0.5, 3),
         dict(mode="exp_range", exp_gamma=0.97)),
        ("cyclic_scale_fn", "CyclicLR", (0.01, 0.5, 3),
         dict(scale_fn=lambda x: 1 / (1 + x), scale_mode="iterations")),
    ]


CASES = {c[0]: c[1:] for c in _cases()}


def _pair(case):
    name, args, kw = CASES[case]
    return getattr(jlr, name)(*args, **kw), getattr(tlr, name)(*args, **kw)


def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1.5e-4, T_max=10,
                                                     eta_min=1e-5),
                            warmup_steps=3, start_lr=0.0, end_lr=1.5e-4)


def test_every_scheduler_is_ported():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    assert len(tlr.__all__) == 16
    covered = {name for name, _, _ in CASES.values()} | {"ReduceOnPlateau",
                                                        "LRScheduler"}
    assert covered == set(jlr.__all__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match_the_reference(case):
    ref, got = _pair(case)
    assert got() == pytest.approx(ref(), abs=TOL)
    for _ in range(STEPS):
        ref.step()
        got.step()
        assert abs(got() - ref()) <= TOL, (case, got.last_epoch)
        assert got.last_epoch == ref.last_epoch


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_to_an_epoch_matches_the_reference(case):
    ref, got = _pair(case)
    for epoch in EPOCHS:
        ref.step(epoch)
        got.step(epoch)
        assert abs(got() - ref()) <= TOL, (case, epoch)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip(case):
    _, a = _pair(case)
    for _ in range(7):
        a.step()
    _, b = _pair(case)
    b.set_state_dict(a.state_dict())
    assert b.last_epoch == a.last_epoch and b() == a()
    a.step()
    b.step()
    assert b() == a()


def test_linear_warmup_over_cosine_matches_the_reference():
    """The slice's schedule: 3 warm-up steps from 0, then a cosine decay
    from 1.5e-4 to 1e-5 over 10."""
    ref, got = _warmup_cosine(jlr), _warmup_cosine(tlr)
    seen = [got()]
    for _ in range(STEPS):
        ref.step()
        got.step()
        assert abs(got() - ref()) <= TOL
        seen.append(got())
    assert seen[0] == 0.0 and seen[3] == pytest.approx(1.5e-4)
    assert seen[13] == pytest.approx(1e-5)


def test_reduce_on_plateau_matches_the_reference():
    kw = dict(mode="min", factor=0.5, patience=2, cooldown=1, min_lr=0.02,
              threshold=0.01)
    ref, got = jlr.ReduceOnPlateau(0.5, **kw), tlr.ReduceOnPlateau(0.5, **kw)
    metrics = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.91, 0.85, 0.9, 0.9, 0.9,
               0.9, 0.9, 0.9, 0.9, 0.9, 0.9]
    for m in metrics:
        ref.step(m)
        got.step(torch.tensor(m))
        assert abs(got() - ref()) <= TOL
    assert got() < 0.5  # it did reduce
    max_kw = dict(mode="max", threshold_mode="abs", patience=0)
    ref, got = (jlr.ReduceOnPlateau(1.0, **max_kw),
                tlr.ReduceOnPlateau(1.0, **max_kw))
    for m in (1.0, 2.0, 1.5, 1.5, 3.0, 2.0):
        ref.step(m)
        got.step(m)
        assert got() == ref()
    ref.step()
    got.step()
    assert got.last_epoch == ref.last_epoch


def test_the_optimizer_reads_its_scheduler_and_refuses_set_lr():
    sched = _warmup_cosine(tlr)
    opt = Adam(sched, parameters=[torch.zeros(3, requires_grad=True)])
    values = []
    for _ in range(5):
        values.append(float(opt.lr_device_scalar("cpu")))
        assert opt.get_lr() == sched()
        sched.step()
    assert values[0] == 0.0 and len(set(values)) == 5
    # epoch 4 is the cosine's step 1
    cos1 = 1e-5 + (1.5e-4 - 1e-5) * (1 + math.cos(math.pi / 10)) / 2
    assert values[-1] == pytest.approx(cos1, rel=1e-6)
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.1)


def test_the_device_scalar_is_made_anew_only_when_the_value_changes():
    sched = tlr.StepDecay(0.5, step_size=2)
    opt = Adam(sched, parameters=[torch.zeros(3, requires_grad=True)])
    first = opt.lr_device_scalar("cpu")
    assert opt.lr_device_scalar("cpu") is first
    sched.step()  # epoch 1: still 0.5
    assert opt.lr_device_scalar("cpu") is first
    sched.step()  # epoch 2: 0.05
    second = opt.lr_device_scalar("cpu")
    assert second is not first and float(second) == pytest.approx(0.05)
    assert float(first) == 0.5  # a new tensor, not a write into the old
