"""Port multi-tensor Adam (paddle_tpu_torch.ops.fused.fused_adam_step and
its plain version `_adam_reference`) against the reference: the Pallas
`_adam_kernel` run in interpret mode, three steps of `Adam._update`, and
the engines' `apply_optimizer_update` in master-weight mode with members
whose beta powers differ, and in AdamW's decoupled-decay mode with a
tensor excluded by name; the CUDA kernel against the plain version on a
card (marked `cuda`)."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import apply_optimizer_update
from paddle_tpu.ops import fused as jfused
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch import optimizer as tfused_optimizer
import torch_threads  # noqa: F401  (one torch thread a worker)

B1, B2, EPS = 0.9, 0.999, 1e-8
# f32 on both sides; the only difference is where a rounding falls (the
# Pallas kernel raises beta to the power t, the port multiplies powers)
TOL = 1e-6


def _state(n, seed):
    rng = np.random.RandomState(seed)
    p = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    m = (rng.randn(n) * 0.1).astype(np.float32)
    v = (rng.rand(n) * 0.01).astype(np.float32)
    return p, g, m, v


def _port_step(params, grads, ms, vs, b1p, b2p, lr, masters=None, wd=0.0):
    """One plain-version step on torch copies; returns numpy results."""
    t = lambda xs: [torch.from_numpy(np.array(x)) for x in xs]
    P, G, M, V = t(params), t(grads), t(ms), t(vs)
    P1 = [torch.tensor(np.float32(x)) for x in b1p]
    P2 = [torch.tensor(np.float32(x)) for x in b2p]
    MS = t(masters) if masters is not None else None
    tfused.fused_adam_step(P, G, M, V, P1, P2, torch.tensor(np.float32(lr)),
                           masters=MS, beta1=B1, beta2=B2, eps=EPS,
                           weight_decay=wd)
    n = lambda xs: [x.float().numpy() for x in xs]
    return (n(P), n(M), n(V), [float(x) for x in P1], [float(x) for x in P2],
            n(MS) if MS is not None else None)


@pytest.mark.parametrize("t", [1, 3])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(t):
    n, block, lr = 4096, 1024, 1e-3
    p, g, m, v = _state(n, seed=t)
    spec = pl.BlockSpec((block,), lambda i: (i,))
    shape = jax.ShapeDtypeStruct((n,), jnp.float32)
    with jax.enable_x64(False):
        ref = pl.pallas_call(
            functools.partial(jfused._adam_kernel, b1=B1, b2=B2, eps=EPS),
            grid=(n // block,),
            in_specs=[spec] * 4 + [pl.BlockSpec(memory_space=pltpu.SMEM)] * 2,
            out_specs=[spec] * 3, out_shape=[shape] * 3, interpret=True)(
                p, g, m, v, jnp.asarray([lr], jnp.float32),
                jnp.asarray([t], jnp.float32))
    # beta powers after t - 1 steps, advanced by the step itself
    b1p = np.float32(1.0)
    b2p = np.float32(1.0)
    for _ in range(t - 1):
        b1p, b2p = np.float32(b1p * np.float32(B1)), np.float32(
            b2p * np.float32(B2))
    P, M, V, P1, P2, _ = _port_step([p], [g], [m], [v], [b1p], [b2p], lr)
    for got, want in zip((P[0], M[0], V[0]), ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    assert P1[0] == pytest.approx(B1 ** t, rel=1e-6)
    assert P2[0] == pytest.approx(B2 ** t, rel=1e-6)


def test_three_steps_match_adam_update():
    opt = paddle.optimizer.Adam(learning_rate=1e-3, beta1=B1, beta2=B2,
                                epsilon=EPS, parameters=[])
    sizes = (1, 300, 5000)
    params = [_state(n, seed=n)[0] for n in sizes]
    ref_p = [jnp.asarray(p) for p in params]
    ref_st = [opt._init_state(p) for p in ref_p]
    ms = [np.zeros(n, np.float32) for n in sizes]
    vs = [np.zeros(n, np.float32) for n in sizes]
    b1p, b2p = [1.0] * 3, [1.0] * 3
    for step in range(3):
        grads = [_state(n, seed=100 * step + n)[1] for n in sizes]
        for i in range(3):
            ref_p[i], ref_st[i] = opt._update(ref_p[i], jnp.asarray(grads[i]),
                                              ref_st[i],
                                              jnp.asarray(1e-3, jnp.float32))
        params, ms, vs, b1p, b2p, _ = _port_step(params, grads, ms, vs, b1p,
                                                 b2p, 1e-3)
    for i in range(3):
        np.testing.assert_allclose(params[i], np.asarray(ref_p[i]), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(ms[i], np.asarray(ref_st[i]["moment1"]),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(vs[i], np.asarray(ref_st[i]["moment2"]),
                                   atol=TOL, rtol=0)
        assert b1p[i] == pytest.approx(float(ref_st[i]["beta1_pow"]),
                                       rel=1e-7)
        assert b2p[i] == pytest.approx(float(ref_st[i]["beta2_pow"]),
                                       rel=1e-7)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_master_mode_matches_apply_optimizer_update(wd):
    """bf16 residents with f32 masters; three small members (the
    reference's grouped update) whose beta powers differ, and one member
    past the grouping size (its per-param update)."""
    opt = paddle.optimizer.Adam(learning_rate=2e-3, beta1=B1, beta2=B2,
                                epsilon=EPS, parameters=[],
                                multi_precision=True, weight_decay=wd or None)
    sizes = {"a": 64, "b": 1000, "c": 7, "big": 70000}
    steps_taken = {"a": 0, "b": 4, "c": 9, "big": 2}
    names = list(sizes)
    rng = np.random.RandomState(0)
    masters = {n: rng.randn(s).astype(np.float32) for n, s in sizes.items()}
    low = {n: jnp.asarray(m).astype(jnp.bfloat16) for n, m in masters.items()}
    grads = {n: jnp.asarray(rng.randn(s).astype(np.float32)).astype(
        jnp.bfloat16) for n, s in sizes.items()}
    state = {n: {"moment1": jnp.asarray(rng.randn(s).astype(np.float32)
                                        * 0.1),
                 "moment2": jnp.asarray(rng.rand(s).astype(np.float32)
                                        * 0.01),
                 "beta1_pow": jnp.asarray(np.float32(B1) ** k),
                 "beta2_pow": jnp.asarray(np.float32(B2) ** k),
                 "master": jnp.asarray(masters[n])}
             for (n, s), k in zip(sizes.items(), steps_taken.values())}
    named = {n: types.SimpleNamespace(regularizer=None) for n in names}
    new_p, new_st = apply_optimizer_update(
        opt, named, low, grads, state, jnp.asarray(2e-3, jnp.float32))

    P = [torch.from_numpy(np.asarray(low[n], np.float32)).to(torch.bfloat16)
         for n in names]
    G = [torch.from_numpy(np.asarray(grads[n], np.float32)).to(
        torch.bfloat16) for n in names]
    tn = lambda key: [torch.from_numpy(np.array(state[n][key], np.float32))
                      for n in names]
    M, V, P1, P2, MS = (tn(k) for k in ("moment1", "moment2", "beta1_pow",
                                        "beta2_pow", "master"))
    tfused.fused_adam_step(P, G, M, V, P1, P2, torch.tensor(2e-3), masters=MS,
                           beta1=B1, beta2=B2, eps=EPS, weight_decay=wd)
    for i, n in enumerate(names):
        np.testing.assert_allclose(MS[i].numpy(),
                                   np.asarray(new_st[n]["master"]), atol=TOL,
                                   rtol=0, err_msg=n)
        assert P[i].dtype == torch.bfloat16
        assert torch.equal(P[i], MS[i].to(torch.bfloat16))
        np.testing.assert_allclose(
            P[i].float().numpy(), np.asarray(new_p[n], np.float32),
            atol=float(np.abs(np.asarray(new_p[n], np.float32)).max())
            * 2 ** -8, rtol=0, err_msg=n)  # one bf16 ulp: a rounding flip
        for key, got in (("moment1", M[i]), ("moment2", V[i])):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(new_st[n][key]), atol=TOL,
                                       rtol=0, err_msg=f"{n} {key}")
        for key, got in (("beta1_pow", P1[i]), ("beta2_pow", P2[i])):
            assert float(got) == pytest.approx(float(new_st[n][key]),
                                               rel=1e-7), (n, key)


def test_lists_of_different_lengths_raise():
    t = torch.zeros(3)
    with pytest.raises(ValueError, match="differ in length"):
        tfused.fused_adam_step([t], [t, t], [t], [t], [t], [t],
                               torch.tensor(1.0))


def test_cpu_path_launches_no_kernel():
    before = tfused.fused_adam_step.launches
    _port_step(*[[x] for x in _state(10, 0)], [1.0], [1.0], 1e-3)
    assert tfused.fused_adam_step.launches == before


def test_other_devices_raise_instead_of_falling_back():
    t = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.fused_adam_step([t], [t], [t], [t], [t], [t], t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("master", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, master):
    sizes = (1, 1000, 65536, 300000)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda n: torch.randn(n, device=cuda_device, generator=gen)
    f32 = [rnd(n) for n in sizes]
    low = torch.bfloat16 if master else torch.float32
    state = lambda: dict(
        P=[p.to(low, copy=True) for p in f32],
        G=[rnd(n).to(low) for n in sizes],
        M=[torch.zeros(n, device=cuda_device) for n in sizes],
        V=[torch.zeros(n, device=cuda_device) for n in sizes],
        P1=[torch.full((), B1 ** i, device=cuda_device) for i in range(4)],
        P2=[torch.full((), B2 ** i, device=cuda_device) for i in range(4)],
        MS=[p.clone() for p in f32] if master else None)
    got = state()
    want = {k: ([t.clone() for t in v] if v is not None else None)
            for k, v in got.items()}
    want["G"] = got["G"]
    lr = torch.full((), 1e-3, device=cuda_device)
    for _ in range(3):
        before = tfused.fused_adam_step.launches
        tfused.fused_adam_step(got["P"], got["G"], got["M"], got["V"],
                               got["P1"], got["P2"], lr, masters=got["MS"])
        assert tfused.fused_adam_step.launches == before + 2
        tfused._adam_reference(want["P"], want["G"], want["M"], want["V"],
                               want["P1"], want["P2"], lr,
                               masters=want["MS"])
    torch.cuda.synchronize()
    for key in ("P", "M", "V", "P1", "P2", "MS"):
        for a, b in zip(got[key] or [], want[key] or []):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_matches_apply_optimizer_update_over_three_steps(master):
    """The port's AdamW (decoupled decay in `fused_adam_step`'s plain
    version) against the reference engine's update, f32 or bf16 residents
    with f32 masters; `apply_decay_param_fun` excludes the bias by its
    name, which the port learns from `name_parameters`."""
    lr, wd = 2e-3, 0.1
    sizes = {"layer.weight": 300, "layer.bias": 7, "emb.weight": 5000}
    decays = lambda name: not name.endswith("bias")
    ref_opt = paddle.optimizer.AdamW(
        learning_rate=lr, beta1=B1, beta2=B2, epsilon=EPS, parameters=[],
        weight_decay=wd, apply_decay_param_fun=decays,
        multi_precision=master)
    rng = np.random.RandomState(3)
    low = jnp.bfloat16 if master else jnp.float32
    init = {n: np.array(jnp.asarray(rng.randn(s).astype(np.float32))
                        .astype(low), np.float32)
            for n, s in sizes.items()}
    ref_p = {n: jnp.asarray(v).astype(low) for n, v in init.items()}
    ref_st = {}
    for n, v in init.items():
        st = ref_opt._init_state(jnp.asarray(v))
        if master:
            st["master"] = jnp.asarray(v)
        ref_st[n] = st
    named = {n: types.SimpleNamespace(regularizer=None) for n in sizes}

    tlow = torch.bfloat16 if master else torch.float32
    params = [torch.tensor(init[n]).to(tlow) for n in sizes]
    opt = tfused_optimizer.AdamW(lr, beta1=B1, beta2=B2, epsilon=EPS,
                                 parameters=params, weight_decay=wd,
                                 apply_decay_param_fun=decays,
                                 multi_precision=master)
    opt.name_parameters(zip(sizes, params))
    for step in range(3):
        grads = {n: rng.randn(s).astype(np.float32)
                 for n, s in sizes.items()}
        ref_p, ref_st = apply_optimizer_update(
            ref_opt, named, ref_p,
            {n: jnp.asarray(g).astype(low) for n, g in grads.items()},
            ref_st, jnp.asarray(lr, jnp.float32))
        for p, n in zip(params, sizes):
            p.grad = torch.from_numpy(grads[n]).to(tlow)
        opt.step()
    for p, n in zip(params, sizes):
        st = opt.state_for(p)
        want = np.asarray(ref_st[n]["master"] if master else ref_p[n],
                          np.float32)
        got = (st["master"] if master else p).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=n)
        for key in ("moment1", "moment2"):
            np.testing.assert_allclose(st[key].numpy(),
                                       np.asarray(ref_st[n][key]), atol=TOL,
                                       rtol=0, err_msg=f"{n} {key}")


def test_adamw_excluding_a_tensor_equals_adam_on_it():
    """One step of AdamW with the tensor excluded is Adam's step on it;
    with it included, the value is first scaled by 1 - lr·wd."""
    lr, wd = 1e-2, 0.5
    p0, g = _state(64, seed=11)[:2]
    out = {}
    for name, fun in (("excluded", lambda n: False),
                      ("decayed", lambda n: True), ("adam", None)):
        p = torch.from_numpy(p0.copy())
        cls = tfused_optimizer.Adam if fun is None else \
            tfused_optimizer.AdamW
        kw = {} if fun is None else dict(weight_decay=wd,
                                         apply_decay_param_fun=fun)
        opt = cls(lr, parameters=[p], **kw)
        opt.name_parameters([("w", p)])
        p.grad = torch.from_numpy(g)
        opt.step()
        out[name] = p.numpy()
    assert np.array_equal(out["excluded"], out["adam"])
    np.testing.assert_allclose(out["decayed"],
                               out["adam"] - lr * wd * p0, atol=1e-6)


def test_adamw_decay_fun_needs_names_and_lr_ratio_is_refused():
    """``apply_decay_param_fun`` still needs the parameters' names;
    ``lr_ratio`` is ported since: it scales each parameter's learning
    rate, the decoupled decay's too, as the reference's ``AdamW.step``
    does (three steps against it)."""
    p = torch.zeros(3)
    opt = tfused_optimizer.AdamW(1e-3, parameters=[p],
                                 apply_decay_param_fun=lambda n: True)
    p.grad = torch.ones(3)
    with pytest.raises(ValueError, match="names"):
        opt.step()
    rng = np.random.RandomState(4)
    p0 = [rng.randn(16).astype(np.float32), rng.randn(4, 4).astype(
        np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in p0]
             for _ in range(3)]
    ratio = lambda q: 0.25 if len(q.shape) == 1 else 2.0  # noqa: E731
    jps = [paddle.core.tensor.Parameter(jnp.asarray(a), name=f"w{i}")
           for i, a in enumerate(p0)]
    jo = paddle.optimizer.AdamW(0.01, parameters=jps, weight_decay=0.1,
                                lr_ratio=ratio)
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    to = tfused_optimizer.AdamW(0.01, parameters=tps, weight_decay=0.1,
                                lr_ratio=ratio)
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = paddle.core.tensor.wrap_raw(jnp.asarray(g))
            tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._value),
                                   rtol=1e-6, atol=1e-7)


def test_fused_step_decoupled_decay_is_one_coefficient_per_tensor():
    """`fused_adam_step`'s plain version: a zero coefficient leaves that
    tensor's update Adam's, a nonzero one scales the value first."""
    lr = torch.tensor(0.1)
    p, g, m, v = (torch.from_numpy(a) for a in _state(16, seed=5))
    base = [t.clone() for t in (p, p)]
    for target, c in zip(base, (0.0, 0.25)):
        tfused.fused_adam_step([target], [g], [m.clone()], [v.clone()],
                               [torch.tensor(1.0)], [torch.tensor(1.0)], lr,
                               decoupled_decay=[c])
    plain = p.clone()
    tfused.fused_adam_step([plain], [g], [m.clone()], [v.clone()],
                           [torch.tensor(1.0)], [torch.tensor(1.0)], lr)
    assert torch.equal(base[0], plain)
    torch.testing.assert_close(base[1], plain - 0.1 * 0.25 * p, atol=1e-6,
                               rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_adamw_mode_matches_plain(cuda_device):
    sizes = (1, 1000, 65536, 300000)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rnd = lambda n: torch.randn(n, device=cuda_device, generator=gen)
    p0 = [rnd(n) for n in sizes]
    grads = [rnd(n) for n in sizes]
    decay = [0.01, 0.0, 0.01, 0.3]
    state = lambda: dict(
        P=[p.clone() for p in p0],
        M=[torch.zeros(n, device=cuda_device) for n in sizes],
        V=[torch.zeros(n, device=cuda_device) for n in sizes],
        P1=[torch.ones((), device=cuda_device) for _ in sizes],
        P2=[torch.ones((), device=cuda_device) for _ in sizes])
    got, want = state(), state()
    lr = torch.full((), 1e-3, device=cuda_device)
    for _ in range(3):
        tfused.fused_adam_step(got["P"], grads, got["M"], got["V"],
                               got["P1"], got["P2"], lr,
                               decoupled_decay=decay)
        tfused._adam_reference(want["P"], grads, want["M"], want["V"],
                               want["P1"], want["P2"], lr,
                               decoupled_decay=decay)
    torch.cuda.synchronize()
    for key in got:
        for a, b in zip(got[key], want[key]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
