"""The parameter surface of the port against the reference: the Adam
kernel's plain version (#7, `ops.fused.fused_adam_step`) with fp16
gradients and resident copies and a per-tensor learning-rate scale;
per-parameter learning rates (`ParamAttr(learning_rate=)`) in every
optimizer and AdamW's `lr_ratio`; `ParamAttr` through the layers
(`weight_attr`, `bias_attr=False`, BatchNorm's and LayerNorm's
`weight_attr=False`);
tests/test_optimizer.py::TestMultiPrecision at fp16; pure fp16 O2 LeNet
with Adam masters and `GradScaler`; a Program's `ParamAttr` learning rate
through the Executor. Inputs come from numpy seeds; weights cross over
with `load_jax_params` or by value."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.nn.clip import clip_grads_global_norm_raw
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.vision.models import LeNet
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")
jamp = importlib.import_module("paddle_tpu.amp")

# f32 on both sides, the same formula per element (the plain version's
# lr · scale is one f32 product where the reference rounds lr·scale once
# from double): an f32 ulp or two
RTOL, ATOL = 1e-6, 1e-7
# an fp16 resident is its master rounded to fp16: one fp16 ulp where the
# two masters straddle a rounding boundary
FP16_RTOL = 2.0 ** -10


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(autouse=True)
def _reference_cost_gauges_dropped():
    """The reference's Executor publishes each program's XLA cost as
    process-wide gauges (``compile/<entry>/flops``, -1 where the CPU
    backend counts none), and its telemetry schema check rejects a
    negative one: drop the cost gauges a test added, for the suites that
    run after this one in the same process."""
    from paddle_tpu.profiler.telemetry import get_telemetry as jtelemetry

    before = set(jtelemetry().snapshot()["gauges"])
    yield
    jtelemetry().remove_gauges(
        lambda n: n.startswith("compile/") and n not in before)


# -- #7's plain version: fp16 gradients and copies, lr scales ---------------
def _reference_adam(p16, g16, masters, m, v, lr, scales, coeffs, clip):
    """The reference's eager master path per tensor: the global-norm clip
    of the fp16 gradients (``clip_grads_global_norm_raw``), AdamW's decay
    ``master · (1 − lr_s · c)`` and ``Adam._update`` on the f32 master at
    ``lr_s = lr · scale``, the fp16 resident re-cast from it."""
    opt = paddle.optimizer.Adam(0.1, parameters=[Parameter(jnp.zeros(1))])
    grads = {i: jnp.asarray(g) for i, g in enumerate(g16)}
    if clip is not None:
        grads = clip_grads_global_norm_raw(grads, clip)
    out = []
    for i in range(len(p16)):
        lr_s = lr * scales[i]
        master = jnp.asarray(masters[i])
        if coeffs[i]:
            master = master * (1.0 - lr_s * coeffs[i])
        st = {"moment1": jnp.asarray(m[i]), "moment2": jnp.asarray(v[i]),
              "beta1_pow": jnp.ones((), jnp.float32),
              "beta2_pow": jnp.ones((), jnp.float32)}
        new, st = opt._update(master, grads[i].astype(jnp.float32), st,
                              lr_s)
        out.append((np.asarray(new), np.asarray(new.astype(jnp.float16)),
                    np.asarray(st["moment1"]), np.asarray(st["moment2"])))
    return out


@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_adam_plain_fp16_with_lr_scales_matches_the_reference(clip):
    rng = np.random.RandomState(0)
    sizes = (300, 17, 1024, 5)
    masters = [rng.randn(n).astype(np.float32) for n in sizes]
    p16 = [a.astype(np.float16) for a in masters]
    g16 = [(rng.randn(n) * 0.3).astype(np.float16) for n in sizes]
    m = [rng.randn(n).astype(np.float32) * 0.01 for n in sizes]
    v = [np.abs(rng.randn(n)).astype(np.float32) * 0.01 for n in sizes]
    scales, coeffs, lr = [1.0, 0.5, 0.0, 0.25], [0.0, 0.1, 0.1, 0.0], 0.01
    want = _reference_adam(p16, g16, masters, m, v, lr, scales, coeffs,
                           clip)
    P = [torch.from_numpy(a.copy()) for a in p16]
    MS = [torch.from_numpy(a.copy()) for a in masters]
    M = [torch.from_numpy(a.copy()) for a in m]
    V = [torch.from_numpy(a.copy()) for a in v]
    tfused.fused_adam_step(
        P, [torch.from_numpy(g) for g in g16], M, V,
        [torch.ones(()) for _ in sizes], [torch.ones(()) for _ in sizes],
        torch.tensor(lr), masters=MS, decoupled_decay=coeffs,
        clip_norm=clip, lr_scale=scales)
    for i, (master, low, m1, m2) in enumerate(want):
        np.testing.assert_allclose(MS[i].numpy(), master, rtol=RTOL,
                                   atol=ATOL, err_msg=f"master {i}")
        np.testing.assert_allclose(M[i].numpy(), m1, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(V[i].numpy(), m2, rtol=RTOL, atol=ATOL)
        assert P[i].dtype == torch.float16
        assert torch.equal(P[i], MS[i].to(torch.float16))  # the copy rule
        np.testing.assert_allclose(P[i].float().numpy(),
                                   low.astype(np.float32), rtol=FP16_RTOL,
                                   atol=0)
    # a tensor at scale 0 keeps its master and copy bits
    assert np.array_equal(MS[2].numpy(), masters[2])
    assert np.array_equal(P[2].numpy(), p16[2])


def test_fp16_copy_overflow_is_inf_and_fails_the_check():
    """A master beyond fp16's 65504 rounds to inf in the copy, as the
    reference's ``.astype(float16)``; the check pass flags it."""
    p = torch.tensor([65504.0, 1.0], dtype=torch.float16)
    master = torch.tensor([65519.0, 1.0])
    g = torch.tensor([-1.0, 0.5], dtype=torch.float16)
    args = ([p], [g], [torch.zeros(2)], [torch.zeros(2)], [torch.ones(())],
            [torch.ones(())], torch.tensor(100.0))
    flags, ok = tfused.adam_finite_check(*args, masters=[master])
    assert flags.tolist() == [True, True, False, True] and int(ok) == 0
    tfused.fused_adam_step(*args, masters=[master])
    assert torch.isinf(p[0]) and master[0] > 65504
    assert float(jnp.asarray(master[0].item(), jnp.float32).astype(
        jnp.float16)) == float("inf")


# -- per-parameter learning rates --------------------------------------------
OPTIMIZERS = {
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.1, momentum=0.9),
    "LarsMomentum": dict(learning_rate=0.1, lars_coeff=0.01),
    "Adagrad": dict(learning_rate=0.1),
    "Adam": dict(learning_rate=0.01),
    "Adam_l2": dict(learning_rate=0.01, weight_decay=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1),
    "AdamW_lr_ratio": dict(learning_rate=0.01, weight_decay=0.1),
    "Adamax": dict(learning_rate=0.01),
    "Adadelta": dict(learning_rate=1.0),
    "RMSProp": dict(learning_rate=0.01, momentum=0.9),
    "Lamb": dict(learning_rate=0.01),
}


def _linear_pair(in_f, out_f, seed, weight_attr=None, bias_attr=None):
    """A reference Linear and the port's with the same attrs and weights."""
    rng = np.random.RandomState(seed)
    ref = jnn.Linear(in_f, out_f, weight_attr=weight_attr[0]
                     if weight_attr else None,
                     bias_attr=bias_attr[0] if bias_attr else None)
    port = tnn.Linear(in_f, out_f, weight_attr=weight_attr[1]
                      if weight_attr else None,
                      bias_attr=bias_attr[1] if bias_attr else None,
                      device="cpu")
    params = {n: rng.randn(*p.shape).astype(np.float32)
              for n, p in jfunc.get_params(ref).items()}
    jfunc.set_params(ref, {k: jnp.asarray(v) for k, v in params.items()})
    load_jax_params(port, params)
    return ref, port


def _attrs(lr):
    return (paddle.ParamAttr(learning_rate=lr), tnn.ParamAttr(
        learning_rate=lr))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_per_parameter_learning_rates_match_the_reference(name):
    """``ParamAttr(learning_rate=0.5)`` on the weights and ``0`` on a
    bias through three steps of each optimizer: the weights step at half
    the rate, the bias keeps its bits (but for the L2 fold, which moves
    nothing at rate 0 either)."""
    kw = OPTIMIZERS[name]
    cls = name.split("_")[0]
    x = np.random.RandomState(1).randn(6, 5).astype(np.float32)
    nets = [_linear_pair(5, 4, 2, _attrs(0.5), _attrs(0.0)),
            _linear_pair(4, 3, 3)]
    extra = {}
    if name == "AdamW_lr_ratio":
        extra = {"lr_ratio": lambda p: 3.0 if len(p.shape) == 2 else 1.0}
    results = []
    for side in (0, 1):
        layers = [pair[side] for pair in nets]
        params = [p for layer in layers for p in layer.parameters()]
        mod = paddle.optimizer if side == 0 else topt
        opt = getattr(mod, cls)(parameters=params, **kw, **extra)
        for _ in range(3):
            if side == 0:
                h = paddle.to_tensor(x)
            else:
                h = torch.from_numpy(x)
            for layer in layers:
                h = layer(h)
            (h * h).sum().backward()
            opt.step()
            opt.clear_grad()
        results.append([np.asarray(p._value) if side == 0
                        else p.detach().numpy() for p in params])
    bias0 = nets[0][1].bias.detach().numpy()
    for i, (got, want) in enumerate(zip(results[1], results[0])):
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6,
                                   err_msg=f"{name} param {i}")
    assert np.array_equal(bias0, results[0][1])  # rate 0 kept its bits


def test_param_attr_learning_rate_is_per_parameter_in_fused_adam():
    """Adam's step gives each tensor its scale in the kernel's table (the
    plain version here): a weight at 0.5 moves as an Adam step at half
    the rate, one at 0 not at all."""
    w = torch.nn.Parameter(torch.ones(8))
    w.optimize_attr = {"learning_rate": 0.5}
    z = torch.nn.Parameter(torch.ones(8))
    z.optimize_attr = {"learning_rate": 0.0}
    r = torch.nn.Parameter(torch.ones(8))
    opt = topt.Adam(0.1, parameters=[w, z, r])
    for p in (w, z, r):
        p.grad = torch.full((8,), 0.3)
    opt.step()
    assert torch.equal(z.detach(), torch.ones(8))
    half = topt.Adam(0.05, parameters=[q := torch.nn.Parameter(
        torch.ones(8))])
    q.grad = torch.full((8,), 0.3)
    half.step()
    torch.testing.assert_close(w.detach(), q.detach(), rtol=1e-7, atol=0)
    assert not torch.equal(r.detach(), w.detach())


def test_program_param_attr_learning_rate_steps_as_the_reference():
    """In a Program the reference's jitted step updates every parameter
    at the optimizer's rate (its Executor never reads ``optimize_attr``),
    and so does the port's Executor: three Adam runs of an fc whose
    weight has ``ParamAttr(learning_rate=0.5)``."""
    rng = np.random.RandomState(5)
    xv = rng.randn(8, 4).astype(np.float32)
    yv = rng.randn(8, 1).astype(np.float32)
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        x = jstatic.data("x", [None, 4], "float32")
        y = jstatic.data("y", [None, 1], "float32")
        out = jstatic.nn.fc(x, 1, weight_attr=paddle.ParamAttr(
            name="w", learning_rate=0.5), bias_attr=paddle.ParamAttr(
            name="b"))
        jloss = paddle.mean((out - y) ** 2)
        paddle.optimizer.Adam(learning_rate=0.1).minimize(jloss)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [None, 4], "float32", device="cpu")
        y = tstatic.data("y", [None, 1], "float32", device="cpu")
        out = tstatic.nn.fc(x, 1, weight_attr=tnn.ParamAttr(
            name="w", learning_rate=0.5), bias_attr=tnn.ParamAttr(name="b"))
        loss = ((out - y) ** 2).mean()
        topt.Adam(learning_rate=0.1).minimize(loss)
    tstatic.set_program_state(main, {p.name: np.asarray(p._value)
                                     for p in jmain.all_parameters()})
    jexe, exe = jstatic.Executor(), tstatic.Executor(tstatic.CPUPlace())
    feed = {"x": xv, "y": yv}
    for _ in range(3):
        want = jexe.run(jmain, feed=feed, fetch_list=[jloss])[0]
        got = exe.run(main, feed=feed, fetch_list=[loss])[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for p in jmain.all_parameters():
        tp = next(q for q in main.all_parameters()
                  if tstatic.param_name(q) == p.name)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p._value),
                                   rtol=1e-5, atol=1e-6)


# -- ParamAttr through the layers ----------------------------------------------
def _layer_cases():
    """id -> (builder(nn module, side) -> layer, input shape)."""
    I = {0: paddle.nn.initializer, 1: tnn.initializer}
    P = {0: paddle.ParamAttr, 1: tnn.ParamAttr}

    def kw(side):
        return {} if side == 0 else {"device": "cpu"}

    return {
        "linear_no_bias": (lambda nn, s: nn.Linear(
            5, 3, bias_attr=False, **kw(s)), (4, 5)),
        "linear_attrs": (lambda nn, s: nn.Linear(
            5, 3, weight_attr=P[s](name="lw", learning_rate=0.2,
                                   need_clip=False),
            bias_attr=P[s](initializer=I[s].Constant(0.5), trainable=False),
            **kw(s)), (4, 5)),
        "conv_attrs": (lambda nn, s: nn.Conv2D(
            2, 3, 3, padding=1, weight_attr=P[s](learning_rate=0.3),
            bias_attr=False, **kw(s)), (2, 2, 5, 5)),
        "conv_bias_attr": (lambda nn, s: nn.Conv2D(
            2, 3, 3, bias_attr=P[s](initializer=I[s].Constant(0.25)),
            **kw(s)), (2, 2, 5, 5)),
        "batch_norm_no_weight": (lambda nn, s: nn.BatchNorm2D(
            3, weight_attr=False, **kw(s)), (4, 3, 2, 2)),
        "batch_norm_attrs": (lambda nn, s: nn.BatchNorm2D(
            3, weight_attr=P[s](learning_rate=0.5),
            bias_attr=P[s](trainable=False), **kw(s)), (4, 3, 2, 2)),
        "embedding_padding": (lambda nn, s: nn.Embedding(
            10, 4, padding_idx=-1, weight_attr=P[s](name="emb"), **kw(s)),
            None),
        "bilinear": (lambda nn, s: nn.Bilinear(
            3, 4, 2, bias_attr=P[s](learning_rate=0.0), **kw(s)), (5, 3)),
        "layer_norm_no_bias_2d": (lambda nn, s: nn.LayerNorm(
            [3, 4], weight_attr=P[s](learning_rate=0.5), bias_attr=False,
            **kw(s)), (2, 5, 3, 4)),
        "layer_norm_no_weight": (lambda nn, s: nn.LayerNorm(
            6, epsilon=1e-3, weight_attr=False, **kw(s)), (3, 6)),
        "prelu_attr": (lambda nn, s: nn.PReLU(
            3, weight_attr=P[s](initializer=I[s].Constant(0.1),
                                learning_rate=2.0), **kw(s)), (2, 3, 4)),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_param_attr_through_layers_matches_the_reference(name):
    """The same parameters (names, shapes, learning-rate scale,
    trainable, need_clip), the reference's weights carried over by
    ``load_jax_params``, and the same output and input gradient."""
    build, shape = _layer_cases()[name]
    ref, port = build(paddle.nn, 0), build(tnn, 1)
    jnamed = dict(ref.named_parameters())
    tnamed = dict(port.named_parameters())
    assert list(tnamed) == list(jnamed)
    for n, jp in jnamed.items():
        tp = tnamed[n]
        assert tuple(tp.shape) == tuple(jp.shape)
        assert tp.optimize_attr["learning_rate"] == \
            jp.optimize_attr["learning_rate"]
        assert tp.requires_grad == jp.trainable
        assert tp.need_clip == jp.need_clip
    if name == "embedding_padding":
        assert not port.weight.detach()[9].any()
        assert not np.asarray(ref.weight.numpy())[9].any()
    rng = np.random.RandomState(7)
    params = {n: rng.randn(*p.shape).astype(np.float32)
              for n, p in jnamed.items()}
    jfunc.set_params(ref, {k: jnp.asarray(v) for k, v in params.items()})
    load_jax_params(port, params, buffers=_np(jfunc.get_buffers(ref)))
    if name == "embedding_padding":
        x = rng.randint(0, 10, (3, 4)).astype(np.int64)
        x[0, 0] = 9
        xs = (x,)
    elif name == "bilinear":
        xs = (rng.randn(*shape).astype(np.float32),
              rng.randn(5, 4).astype(np.float32))
    else:
        xs = (rng.randn(*shape).astype(np.float32),)
    want = np.asarray(ref(*[paddle.to_tensor(a) for a in xs]).numpy())
    got = port(*[torch.from_numpy(a) for a in xs]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if name == "embedding_padding":
        assert not got[0, 0].any()  # the padding lookup's output is 0


# -- multi_precision at fp16 (tests/test_optimizer.py::TestMultiPrecision) --
def _fp16_linear_pair():
    ref, port = _linear_pair(4, 4, 11)
    for _, p in ref.named_parameters():
        p._value = p._value.astype(jnp.float16)
    for p in port.parameters():
        p.data = p.data.half()
    return ref, port


@pytest.mark.parametrize("case", ["adamw_dygraph_keeps_master",
                                  "dygraph_step_and_state_roundtrip",
                                  "static_executor_master_mode"])
def test_multi_precision_at_fp16(case):
    """TestMultiPrecision's three cases with fp16 parameters: the f32
    masters and moments, fp16 residents re-cast from the masters, the
    state dict's masters round-trip, and (eagerly) the reference's
    values."""
    x = np.ones((2, 4), np.float32)
    if case == "static_executor_master_mode":
        main = tstatic.Program()
        with tstatic.program_guard(main):
            xv = tstatic.data("x", [None, 4], "float16", device="cpu")
            w = tstatic.nn.create_parameter([4, 4], "float16", device="cpu")
            loss = ((xv @ w).float() ** 2).mean()
            topt.Adam(learning_rate=0.1, multi_precision=True).minimize(
                loss)
        exe = tstatic.Executor(tstatic.CPUPlace())
        feed = {"x": np.ones((4, 4), np.float16)}
        l0 = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
        for _ in range(10):
            l1 = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
        assert l1 < l0, (l0, l1)
        opt = main._optimize[0]
        for p in main.all_parameters():
            assert p.dtype == torch.float16
            assert opt.state_for(p)["master"].dtype == torch.float32
        return
    ref, port = _fp16_linear_pair()
    cls, kw = (("AdamW", dict(learning_rate=0.05, weight_decay=0.01))
               if case == "adamw_dygraph_keeps_master"
               else ("Adam", dict(learning_rate=0.1)))
    jo = getattr(paddle.optimizer, cls)(parameters=ref.parameters(),
                                        multi_precision=True, **kw)
    to = getattr(topt, cls)(parameters=port.parameters(),
                            multi_precision=True, **kw)
    for _ in range(3):
        loss = (ref(paddle.to_tensor(x).astype("float16")).astype(
            "float32") ** 2).mean()
        loss.backward()
        jo.step()
        jo.clear_grad()
        tloss = (port(torch.from_numpy(x).half()).float() ** 2).mean()
        tloss.backward()
        to.step()
        to.clear_grad()
    for jp, tp in zip(ref.parameters(), port.parameters()):
        st = to.state_for(tp)
        assert tp.dtype == torch.float16
        assert st["master"].dtype == st["moment1"].dtype == torch.float32
        assert torch.equal(tp.detach(), st["master"].half())
        # fp16 forward and gradients on both sides: the masters agree to
        # an fp16 rounding of the gradients
        np.testing.assert_allclose(
            st["master"].numpy(),
            np.asarray(jo._accumulators[id(jp)]["master"]), rtol=1e-3,
            atol=1e-3)
    sd = to.state_dict()
    assert any(k.endswith("__master") for k in sd)
    to2 = getattr(topt, cls)(parameters=port.parameters(),
                             multi_precision=True, **kw)
    to2.set_state_dict(sd)
    for tp in port.parameters():
        assert torch.equal(to2.state_for(tp)["master"],
                           to.state_for(tp)["master"])


# -- pure fp16 O2 LeNet with masters and dynamic loss scaling ---------------
def test_lenet_o2_fp16_with_grad_scaler_matches_the_reference():
    """``amp.decorate(level='O2', dtype='float16')``, Adam with masters
    and ``GradScaler``, three steps under ``auto_cast(level='O2')``: the
    losses and the f32 masters follow the reference's (fp16 activations
    and gradients on both sides, rounded in other places: 1e-2 relative
    on the loss; an Adam step moves an element by about lr whatever its
    gradient's size, so an element whose fp16 gradient is noise may step
    the other way: every master within 2·lr a step of the reference's,
    and 95% of each tensor within lr/4)."""
    ref = paddle.vision.models.LeNet()
    port = LeNet(device="cpu")
    load_jax_params(port, _np(jfunc.get_params(ref)),
                    buffers=_np(jfunc.get_buffers(ref)))
    jamp.decorate(ref, level="O2", dtype="float16")
    tamp.decorate(port, level="O2", dtype="float16")
    assert all(p.dtype == torch.float16 for p in port.parameters())
    jo = paddle.optimizer.Adam(1e-3, parameters=ref.parameters(),
                               multi_precision=True)
    to = topt.Adam(1e-3, parameters=port.parameters(), multi_precision=True)
    js = jamp.GradScaler(init_loss_scaling=1024.0)
    ts = tamp.GradScaler(init_loss_scaling=1024.0)
    rng = np.random.RandomState(0)
    jce, tce = paddle.nn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    for step in range(3):
        x = rng.rand(8, 1, 28, 28).astype(np.float32)
        y = rng.randint(0, 10, (8, 1)).astype(np.int64)
        with jamp.auto_cast(level="O2", dtype="float16"):
            jl = jce(ref(paddle.to_tensor(x)), paddle.to_tensor(y))
        js.scale(jl).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        with tamp.auto_cast(level="O2", dtype="float16"):
            tl = tce(port(torch.from_numpy(x)), torch.from_numpy(y))
        ts.scale(tl).backward()
        ts.step(to)
        ts.update()
        to.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-2,
                                   err_msg=f"step {step}")
    assert ts._scale == js._scale
    for jp, tp in zip(ref.parameters(), port.parameters()):
        got = to.state_for(tp)["master"].numpy()
        want = np.asarray(jo._accumulators[id(jp)]["master"])
        np.testing.assert_allclose(got, want, rtol=0, atol=3 * 2 * 1e-3)
        assert np.mean(np.abs(got - want) <= 2.5e-4) >= 0.95


def test_grad_scaler_skips_a_non_finite_fp16_step():
    """An inf gradient: no parameter, master or moment moves, the scale
    halves, as in the reference; a row-sparse gradient is unscaled
    through its values."""
    net = tnn.Linear(4, 2, device="cpu")
    tamp.decorate(net, level="O2", dtype="float16")
    emb = tnn.Embedding(6, 2, sparse=True, device="cpu")
    opt = topt.Adam(0.1, parameters=[*net.parameters(),
                                     *emb.parameters()],
                    multi_precision=True)
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    x = torch.ones(3, 4, dtype=torch.float16)
    loss = net(x).float().sum() + emb(torch.tensor([1, 1, 4])).sum()
    scaler.scale(loss).backward()
    scaler.unscale_(opt)
    g = emb.weight.grad
    assert g.is_sparse and torch.equal(g.to_dense()[1], torch.full((2,), 2.))
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    before = [p.detach().clone() for p in net.parameters()]
    masters = [opt.state_for(p)["master"].clone() for p in net.parameters()]
    loss = net(x).float().sum() * float("inf")
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    assert scaler._scale == 4.0
    for p, b, m in zip(net.parameters(), before, masters):
        assert torch.equal(p.detach(), b)
        assert torch.equal(opt.state_for(p)["master"], m)
