"""GPT-2 trained the way it is pretrained, through the port's engines
against the reference's: a 2-layer GPT-2 tiny on the reference's weights
(dropout 0), `AdamW(weight_decay=0.01)` with LayerNorm weights and biases
excluded by name, `LinearWarmup(CosineAnnealingDecay)` stepped after every
step, `ClipGradByGlobalNorm(0.5)` (it clips), for 4 steps — through
`ParallelTrainStep` and `jit.TrainStep` on both sides, in f32 and in bf16
with f32 masters, under remat 'off', 'full' and 'dots'. Per-step losses
and final parameters agree to `test_torch_train.py`'s tolerances;
`run_steps` gives the reference's learning rates and leaves the scheduler
where the reference leaves it; the engines refuse the clips they do not
run and the resilience options."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.jit.train_step import EvalStep, TrainStep
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

PEAK_LR = 1e-3
STEPS = 4
CLIP = 0.5
# test_torch_train.py's tolerances: f32 losses to a few ulps, parameters
# within 5e-5 (Adam divides by sqrt(v): an element whose gradient is near
# 0 turns a 1e-7 gradient difference into a visible move); bf16 losses
# within 0.04 (the reference rounds each token's loss to bf16), bf16
# masters within 2·lr per step (a bf16-rounded gradient can flip a sign:
# the sum of this schedule's 4 learning rates, 2.5e-3, is under the
# 3 steps x 1e-3 that the bound there allows)
LOSS_TOL = 1e-5
PARAM_TOL = 5e-5
BF16_LOSS_TOL = 0.04
BF16_PARAM_TOL = 2 * 1e-3 * 3


def _jcfg():
    """The reference's gpt2_tiny cut to 2 layers."""
    return jgpt.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=4, max_position_embeddings=256,
                          hidden_dropout=0.0, attention_dropout=0.0)


def _decays(name):
    return not (name.endswith("bias") or ".ln_" in name)


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(PEAK_LR, T_max=10,
                                                     eta_min=1e-5),
                            warmup_steps=2, start_lr=0.0, end_lr=PEAK_LR)


def _batches():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (STEPS, 2, 64)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=2)


def _np(params):
    return {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}


def _run_reference(engine, bf16, remat, window=False):
    paddle.seed(7)
    model = jgpt.GPTForCausalLM(_jcfg())
    p0 = _np(jfunc.get_params(model))
    if bf16 and engine == "train_step":
        model.bfloat16()
    sched = _schedule(jlr)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(),
        weight_decay=0.01, apply_decay_param_fun=_decays,
        grad_clip=JClip(CLIP), multi_precision=bf16)
    loss_fn = lambda out, lbl: out  # noqa: E731 (the model returns it)
    if engine == "parallel":
        step = JStep(model, loss_fn=loss_fn, optimizer=opt,
                     mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                     compute_dtype=jnp.bfloat16 if bf16 else None,
                     remat=remat)
    else:
        step = JTrainStep(model, loss_fn, opt, remat=remat)
    ids, labels = _batches()
    if window:
        losses = [float(x) for x in np.asarray(
            step.run_steps((ids, labels), (labels,)).numpy())]
    else:
        losses = []
        for i in range(STEPS):
            losses.append(float(np.asarray(
                step((ids[i], labels[i]), (labels[i],)).numpy())))
            sched.step()
    step.sync_to_layer()
    return p0, losses, _np(jfunc.get_params(model)), sched


def _run_port(p0, engine, bf16, remat, window=False):
    model = load_jax_params(
        tgpt.GPTForCausalLM(tgpt.gpt2_tiny(num_layers=2), device="cpu"), p0)
    if bf16 and engine == "train_step":
        model.to(torch.bfloat16)
    sched = _schedule(tlr)
    opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                apply_decay_param_fun=_decays,
                grad_clip=ClipGradByGlobalNorm(CLIP), multi_precision=bf16)
    loss_fn = lambda out, lbl: out  # noqa: E731
    if engine == "parallel":
        step = ParallelTrainStep(model, loss_fn, opt, device="cpu",
                                 compute_dtype=torch.bfloat16 if bf16
                                 else None, remat=remat)
    else:
        step = TrainStep(model, loss_fn, opt, device="cpu", remat=remat)
    ids, labels = (torch.from_numpy(a).long() for a in _batches())
    lrs = []
    if window:
        seen = []
        real_step = opt.step

        def step_reading_lr():
            seen.append(opt.get_lr())
            real_step()

        opt.step = step_reading_lr
        losses = [float(x) for x in step.run_steps((ids, labels),
                                                         (labels,))]
        lrs = seen
    else:
        losses = []
        for i in range(STEPS):
            losses.append(float(step((ids[i], labels[i]), (labels[i],))))
            lrs.append(opt.get_lr())
            sched.step()
    # the layers hold the masters (ParallelTrainStep) or, under TrainStep,
    # the bf16 residents, on both sides
    step.sync_to_layer()
    params = {k: v.float() for k, v in get_params(model).items()}
    return losses, _np(params), sched, lrs


CONFIGS = [(engine, bf16, remat)
           for engine in ("parallel", "train_step")
           for bf16 in (False, True)
           for remat in ("off", "full", "dots")]


@pytest.fixture(scope="module")
def reference_runs():
    return {config: _run_reference(*config) for config in CONFIGS}


def _p0():
    paddle.seed(7)
    return _np(jfunc.get_params(jgpt.GPTForCausalLM(_jcfg())))


def _ids(config):
    engine, bf16, remat = config
    return f"{engine}-{'bf16_master' if bf16 else 'f32'}-{remat}"


@pytest.mark.parametrize("config", CONFIGS, ids=_ids)
def test_losses_and_params_match_the_reference(reference_runs, config):
    engine, bf16, remat = config
    p0, ref_losses, ref_params, _ = reference_runs[config]
    losses, params, _, lrs = _run_port(p0, engine, bf16, remat)
    assert lrs[0] == 0.0 and lrs[2] == PEAK_LR and lrs[3] < PEAK_LR
    loss_tol = BF16_LOSS_TOL if bf16 else LOSS_TOL
    param_tol = BF16_PARAM_TOL if bf16 else PARAM_TOL
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= loss_tol, (losses, ref_losses)
    assert losses[-1] < losses[0]
    moved = max(float(np.abs(ref_params[n] - p0[n]).max()) for n in p0)
    assert moved > 10 * PARAM_TOL
    for name, want in ref_params.items():
        np.testing.assert_allclose(params[name], want, atol=param_tol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("engine", ["parallel", "train_step"])
def test_remat_policies_give_off_bitwise(engine):
    p0 = _p0()
    runs = {r: _run_port(p0, engine, True, r)
            for r in ("off", "full", "dots", "dots_no_batch")}
    for remat, (losses, params, _, _) in runs.items():
        assert losses == runs["off"][0], remat
        for name, v in params.items():
            np.testing.assert_array_equal(v, runs["off"][1][name])


def test_the_clip_clips():
    p0 = _p0()
    model = load_jax_params(
        tgpt.GPTForCausalLM(tgpt.gpt2_tiny(num_layers=2), device="cpu"), p0)
    ids, labels = (torch.from_numpy(a[0]).long() for a in _batches())
    model(ids, labels).backward()
    norm = fused.grad_global_norm([p.grad for p in model.parameters()],
                                  CLIP)
    assert float(norm[0]) > 2 * CLIP and float(norm[1]) < 0.5


@pytest.fixture(scope="module")
def window_runs():
    p0, losses, params, sched = _run_reference("parallel", False, "off",
                                               window=True)
    got = _run_port(p0, "parallel", False, "off", window=True)
    return losses, params, sched, got


def test_run_steps_learning_rates_and_scheduler_match_the_reference(
        window_runs):
    ref_losses, _, ref_sched, (losses, _, sched, lrs) = window_runs
    ref = _schedule(jlr)
    want = [ref()]
    for _ in range(STEPS - 1):
        ref.step()
        want.append(ref())
    assert lrs == want
    assert sched.last_epoch == ref_sched.last_epoch == STEPS - 1
    assert sched() == ref_sched()


def test_run_steps_losses_and_params_match_the_reference(window_runs):
    ref_losses, ref_params, _, (losses, params, _, _) = window_runs
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= LOSS_TOL
    for name, want in ref_params.items():
        np.testing.assert_allclose(params[name], want, atol=PARAM_TOL,
                                   rtol=0, err_msg=name)


def test_run_steps_without_stepping_keeps_the_learning_rate():
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(num_layers=1), device="cpu")
    sched = _schedule(tlr)
    sched.step()
    opt = AdamW(sched, parameters=model.parameters())
    step = ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu")
    ids, labels = (torch.from_numpy(a[:2]).long() for a in _batches())
    losses = step.run_steps((ids, labels), labels, step_scheduler=False)
    assert losses.shape == (2,) and sched.last_epoch == 1


@pytest.mark.parametrize("clip", [ClipGradByValue(1.0), ClipGradByNorm(1.0)])
@pytest.mark.parametrize("engine", [ParallelTrainStep, TrainStep])
def test_engines_refuse_the_clips_they_do_not_run(engine, clip):
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(num_layers=1), device="cpu")
    opt = AdamW(1e-3, parameters=model.parameters(), grad_clip=clip)
    with pytest.raises(NotImplementedError, match="skip it silently"):
        engine(model, lambda out, lbl: out, opt, device="cpu")


@pytest.mark.parametrize("remat", ["offload", "auto"])
def test_train_step_takes_offload_and_auto(remat):
    """The policies of the memory slice build and step: the losses of 3
    TrainStep steps are 'off''s bits, and 'auto' resolves (to 'off' on the
    CPU's 32 GB budget) under jit.train_step's gauge."""
    from paddle_tpu_torch.profiler.telemetry import get_telemetry

    ids, labels = (torch.from_numpy(a[0]).long() for a in _batches())
    losses = {}
    for r in ("off", remat):
        model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(num_layers=1),
                                    device="cpu")
        step = TrainStep(model, lambda out, lbl: out,
                         AdamW(1e-3, parameters=model.parameters()),
                         device="cpu", remat=r)
        losses[r] = [step((ids, labels), (labels,)) for _ in range(3)]
    for a, b in zip(losses[remat], losses["off"]):
        assert torch.equal(a, b)
    if remat == "auto":
        assert step.remat_policy_chosen == "off"
        assert get_telemetry().scalars()["gauge/remat/jit.train_step"] == 0


@pytest.mark.parametrize("kw", [dict(check_finite=True),
                                dict(guard_updates=True),
                                dict(fingerprint_every=10)])
def test_train_step_refuses_what_is_not_ported(kw):
    """The resilience arguments are ported (since the resilience slice)
    and taken as the reference takes them."""
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(num_layers=1), device="cpu")
    opt = AdamW(1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda out, lbl: out, opt, device="cpu", **kw)
    assert step._check_nan is bool(kw.get("check_finite")
                                   or kw.get("guard_updates"))
    assert step._guard_updates is kw.get("guard_updates", False)
    assert step.fingerprint_every == kw.get("fingerprint_every", 0)


def test_eval_step_is_the_eval_forward_without_autograd():
    cfg = tgpt.gpt2_tiny(num_layers=1, hidden_dropout=0.5)
    model = tgpt.GPTForCausalLM(cfg, device="cpu").train()
    ids = torch.from_numpy(_batches()[0][0]).long()
    out = EvalStep(model)(ids)
    assert not out.requires_grad and model.training
    model.eval()
    with torch.no_grad():
        assert torch.equal(out, model(ids))
