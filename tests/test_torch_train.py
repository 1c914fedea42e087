"""The port's training step (paddle_tpu_torch.distributed.fleet.engine)
against the reference's: GPT-2 tiny with the reference's weights, batch
2 x 64, Adam lr 1e-3, three steps of each engine on the CPU, in f32 and in
bf16 master-weight mode; step 1's gradients against `jax.grad` of the
reference's loss; the options that are not ported and the wrong option
types, refused; the dropout generator."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import (functionalize, get_params,
                                                load_jax_params, set_params)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

LR = 1e-3
STEPS = 3
# f32: the same math in another summation order (the port's LayerNorm is
# two-pass, the reference's one-pass) — losses agree to a few f32 ulps
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# Adam divides by sqrt(v): an element whose gradient is near 0 turns a
# 1e-7 gradient difference into a visible move; three steps at lr 1e-3
PARAM_TOL = 5e-5
# bf16: the reference rounds each token's loss to bf16 (one ulp is 0.03
# at 4-8) and rounds activations at other places
BF16_LOSS_TOL = 0.04
# bf16 masters: each step moves an element by at most ~lr, and a
# bf16-rounded gradient can flip its sign: at most 2·lr per step
BF16_PARAM_TOL = 2 * LR * STEPS


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (2, 64)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _jax_model():
    paddle.seed(7)
    return jgpt.GPTForCausalLM(jgpt.gpt2_tiny())


def _np(params):
    return {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}


def _run_reference(compute_dtype):
    model = _jax_model()
    p0 = _np(jfunc.get_params(model))
    opt = paddle.optimizer.Adam(learning_rate=LR,
                                parameters=model.parameters(),
                                multi_precision=compute_dtype is not None)
    step = JStep(model, loss_fn=lambda out, lbl: out, optimizer=opt,
                 mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                 compute_dtype=compute_dtype)
    ids, labels = _batch()
    losses = [float(np.asarray(step((ids, labels), (labels,)).numpy()))
              for _ in range(STEPS)]
    step.sync_to_layer()
    return p0, losses, _np(jfunc.get_params(model))


def _port_model(p0):
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    return load_jax_params(model, p0)


def _run_port(p0, compute_dtype):
    model = _port_model(p0)
    opt = Adam(LR, parameters=model.parameters(),
               multi_precision=compute_dtype is not None)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                             compute_dtype=compute_dtype)
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    losses = [step((ids, labels), (labels,)) for _ in range(STEPS)]
    step.sync_to_layer()
    return losses, _np({k: v.float() for k, v in get_params(model).items()})


@pytest.fixture(scope="module")
def f32_runs():
    p0, ref_losses, ref_params = _run_reference(None)
    losses, params = _run_port(p0, None)
    return p0, ref_losses, ref_params, losses, params


@pytest.fixture(scope="module")
def bf16_runs():
    p0, ref_losses, ref_params = _run_reference(jnp.bfloat16)
    losses, params = _run_port(p0, torch.bfloat16)
    return ref_losses, ref_params, losses, params


@pytest.mark.parametrize("i", range(STEPS))
def test_f32_loss_of_each_step_matches_reference(f32_runs, i):
    _, ref_losses, _, losses, _ = f32_runs
    assert losses[i].dtype == torch.float32 and losses[i].dim() == 0
    assert abs(float(losses[i]) - ref_losses[i]) <= LOSS_TOL


def test_f32_loss_falls(f32_runs):
    losses = [float(l) for l in f32_runs[3]]
    assert losses[-1] < losses[0]


def test_f32_params_after_three_steps_match_reference(f32_runs):
    p0, _, ref_params, _, params = f32_runs
    assert set(params) == set(ref_params)
    moved = max(float(np.abs(ref_params[n] - p0[n]).max()) for n in p0)
    assert moved > 10 * PARAM_TOL  # the comparison is not vacuous
    for name, ref in ref_params.items():
        np.testing.assert_allclose(params[name], ref, atol=PARAM_TOL,
                                   rtol=0, err_msg=name)


def test_step_one_grads_match_jax_grad(f32_runs):
    p0 = f32_runs[0]
    ids, labels = _batch()
    apply = jfunc.functionalize(_jax_model(), training=True)
    ref = jax.grad(lambda p: apply(p, {}, ids, labels)[0])(
        {k: jnp.asarray(v) for k, v in p0.items()})
    model = _port_model(p0)
    loss = model(*(torch.from_numpy(a).long() for a in (ids, labels)))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]),
                                   atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("i", range(STEPS))
def test_bf16_master_loss_matches_reference(bf16_runs, i):
    ref_losses, _, losses, _ = bf16_runs
    assert abs(float(losses[i]) - ref_losses[i]) <= BF16_LOSS_TOL


def test_bf16_master_params_match_reference(bf16_runs):
    _, ref_params, _, params = bf16_runs
    for name, ref in ref_params.items():
        np.testing.assert_allclose(params[name], ref, atol=BF16_PARAM_TOL,
                                   rtol=0, err_msg=name)


def _tiny_step(compute_dtype=None, **opt_kw):
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu", seed=3)
    opt = Adam(LR, parameters=model.parameters(), **opt_kw)
    return model, opt, ParallelTrainStep(model, lambda out, lbl: out, opt,
                                         device="cpu",
                                         compute_dtype=compute_dtype)


def test_master_mode_keeps_bf16_residents_and_f32_state():
    model, opt, step = _tiny_step(torch.bfloat16, multi_precision=True)
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    step((ids, labels), (labels,))
    for p in model.parameters():
        st = opt.state_for(p)
        assert p.dtype == torch.bfloat16
        assert sorted(st) == ["beta1_pow", "beta2_pow", "master", "moment1",
                              "moment2"]
        assert all(t.dtype == torch.float32 for t in st.values())
        assert torch.equal(st["master"].to(torch.bfloat16), p.detach())
        np.testing.assert_allclose(float(st["beta1_pow"]), 0.9, rtol=1e-7)


def test_sync_to_layer_puts_masters_in_the_layer_then_recasts():
    model, opt, step = _tiny_step(torch.bfloat16, multi_precision=True)
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    step((ids, labels), (labels,))
    step.sync_to_layer()
    params = get_params(model)
    for name, p in model.named_parameters():
        assert params[name].dtype == torch.float32
        assert torch.equal(params[name], opt.state_for(p)["master"])
    loss = step((ids, labels), (labels,))
    assert torch.isfinite(loss)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_step_records_steps_and_step_ms():
    tel = get_telemetry()
    tel.reset()
    _, _, step = _tiny_step()
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    for _ in range(3):
        step((ids, labels), (labels,))
    assert tel.counter_value("engine/steps") == 3
    assert tel.hist_summary("engine/step_ms")["count"] == 2


@pytest.mark.parametrize("kw", [
    dict(mesh=object()), dict(dp_axis="dp"), dict(zero_stage=1),
    dict(sp_axis="sp")])
def test_unported_engine_options_raise(kw):
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    opt = Adam(LR, parameters=model.parameters())
    with pytest.raises(NotImplementedError):
        ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                          **kw)


@pytest.mark.parametrize("kw", [dict(remat="offload"),
                                dict(recompute="auto")])
def test_offload_and_auto_engine_options_train(kw):
    """Ported with the memory slice: the engine builds and its first step
    gives the loss bits of the engine without recompute."""
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    losses = []
    for options in (kw, {}):
        model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
        step = ParallelTrainStep(model, lambda out, lbl: out,
                                 Adam(LR, parameters=model.parameters()),
                                 device="cpu", **options)
        losses.append(step((ids, labels), (labels,)))
    assert torch.equal(losses[0], losses[1])


def test_a_layer_on_another_device_is_refused():
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    opt = Adam(LR, parameters=model.parameters())
    with pytest.raises(ValueError, match="must be on meta"):
        ParallelTrainStep(model, lambda out, lbl: out, opt, device="meta")


@pytest.mark.parametrize("kw", [dict(lazy_mode=True),
                                dict(lr_ratio=lambda p: 0.5)])
def test_unported_optimizer_options_raise(kw):
    """Ported since; the engine updates as the reference's
    ``apply_optimizer_update`` does, which reads neither (dense gradients
    make lazy_mode moot, and lr_ratio is AdamW.step's alone): two steps
    give the bits of the engine without the option."""
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    runs = []
    for options in (kw, {}):
        model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
        step = ParallelTrainStep(model, lambda out, lbl: out,
                                 AdamW(LR, parameters=model.parameters(),
                                       **options), device="cpu")
        losses = [step((ids, labels), (labels,)) for _ in range(2)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("kw", [dict(grad_clip=object()),
                                dict(learning_rate=lambda: 0.1)])
def test_wrong_optimizer_option_types_are_refused(kw):
    """A clip that is no clip class, and a callable that is no
    scheduler."""
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    with pytest.raises(TypeError):
        Adam(parameters=model.parameters(), **kw)


def test_set_lr_reaches_the_device_scalar():
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    opt = Adam(0.1, parameters=model.parameters())
    assert float(opt.lr_device_scalar("cpu")) == pytest.approx(0.1)
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    assert float(opt.lr_device_scalar("cpu")) == 0.25


def _dropout_outputs(seed, p=0.5, train=True):
    cfg = tgpt.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                         num_heads=4, max_position_embeddings=256,
                         hidden_dropout=p)
    model = tgpt.GPTForCausalLM(cfg, device="cpu", seed=seed)
    model.train(train)
    ids = torch.from_numpy(_batch()[0]).long()
    return model(ids)


def test_dropout_masks_come_from_the_models_generator():
    torch.manual_seed(0)
    a = _dropout_outputs(seed=1)
    torch.manual_seed(123)  # the global RNG plays no part
    b = _dropout_outputs(seed=1)
    assert torch.equal(a, b)
    assert not torch.equal(a, _dropout_outputs(seed=1, p=0.0))  # it drops


def test_dropout_is_identity_in_eval_mode_and_at_zero():
    for p, train in ((0.5, False), (0.0, True)):
        out = _dropout_outputs(seed=1, p=p, train=train)
        assert torch.equal(out, _dropout_outputs(seed=1, p=0.0, train=False))


def test_same_seed_drops_the_same_elements():
    gen_a = torch.Generator().manual_seed(5)
    gen_b = torch.Generator().manual_seed(5)
    x = torch.ones(64, 32)
    da = tgpt.Dropout(0.5, generator=gen_a)
    db = tgpt.Dropout(0.5, generator=gen_b)
    ya, yb = da(x), db(x)
    assert torch.equal(ya == 0, yb == 0)
    assert 0 < int((ya == 0).sum()) < x.numel()
    assert torch.equal(ya[ya != 0], torch.full_like(ya[ya != 0], 2.0))


def test_functionalize_runs_in_the_given_mode_and_restores_it():
    cfg = tgpt.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=1,
                         num_heads=4, max_position_embeddings=256,
                         hidden_dropout=0.5)
    model = tgpt.GPTForCausalLM(cfg, device="cpu").eval()
    ids = torch.from_numpy(_batch()[0][:, :8]).long()
    train = functionalize(model, training=True)
    assert not torch.equal(train(ids), model(ids))  # dropout was on
    assert model.training is False
    assert torch.equal(functionalize(model, training=False)(ids), model(ids))


@pytest.mark.parametrize("ignored", [0, 5, 64])
def test_cross_entropy_matches_reference_with_ignore_index(ignored):
    rng = np.random.RandomState(ignored)
    logits = rng.randn(64, 1024).astype(np.float32) * 3
    labels = rng.randint(0, 1024, 64)
    labels[:ignored] = -100
    ref = paddle.nn.functional.cross_entropy(paddle.to_tensor(logits),
                                             paddle.to_tensor(labels))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(np.asarray(ref.numpy())),
                               atol=1e-5, rtol=1e-6)


def test_set_params_points_parameters_at_the_tensors():
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    w = torch.full_like(model.gpt.ln_f.weight, 3.0, dtype=torch.float64)
    set_params(model, {"gpt.ln_f.weight": w})
    assert model.gpt.ln_f.weight.dtype == torch.float64
    assert torch.equal(get_params(model)["gpt.ln_f.weight"], w)
    with pytest.raises(KeyError):
        set_params(model, {"nope": w})
