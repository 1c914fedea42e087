"""Dynamic loss scaling of the port (paddle_tpu_torch.amp.GradScaler)
against the reference's `AmpScaler` on the CPU:

- the same gradient sequences (some steps with an inf or a NaN, f32 and
  fp16 gradients) through `minimize` on both sides, under several
  schedules: the scale after each step, `found_inf`, which steps were
  skipped, and the parameters after each step;
- `backoff`, the getters and setters, and the state dict: the same keys,
  and one package's state loads into the other's scaler;
- `unscale_` then `step`: the port divides the gradients by the scale
  once, the reference twice (its `step` checks a flag its `unscale_`
  never sets) — both pinned;
- a skipped step changes no bit of any parameter, f32 master, moment,
  beta power or `global_step` of a multi_precision Adam; the scale halves
  and the next finite step updates again;
- the fp16 O1 loop (`auto_cast(dtype="float16")`, `scale(loss).backward()`,
  `minimize`) trains a small model.

Tolerances: the unscale multiplies by a power of two and SGD's f32
update is one multiply and one subtract per element on both sides:
scales and flags exactly, f32 parameters bit for bit. With fp16
parameters and gradients the reference's SGD (XLA) fuses ``p − lr·g``
without rounding ``lr·g`` to fp16 and the port's rounds it (one fp16 ulp
on 3 of 30 elements after a step, which later steps compound), so there
the unscaled gradients are compared, bit for bit, and the parameters
are not.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, wrap_raw
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear, ReLU, Sequential
from paddle_tpu_torch.optimizer import SGD, Adam
import torch_threads  # noqa: F401  (one torch thread a worker)

jscaler = importlib.import_module("paddle_tpu.amp.grad_scaler")

SHAPES = ((6, 5), (7,), (300,))


def _grads(n_steps, bad, dtype, seed=0):
    """Per step a list of gradients (already scaled by a loss scale), with
    an inf or a NaN in one tensor on the steps in ``bad``."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(n_steps):
        gs = [(rng.randn(*sh) * 100).astype(dtype) for sh in SHAPES]
        if s in bad:
            gs[s % len(gs)].flat[s % 5] = np.inf if s % 2 else np.nan
        out.append(gs)
    return out


def _params(seed=1, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*sh).astype(dtype) for sh in SHAPES]


def _ref_run(values, grads, scaler_kw, probe):
    params = [Parameter(jnp.asarray(v), name=f"p{i}")
              for i, v in enumerate(values)]
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=params)
    scaler = jscaler.AmpScaler(**scaler_kw)
    trace = []
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = wrap_raw(jnp.asarray(g))
        if probe:
            # the reference's minimize, with its unscale_ split off so the
            # unscaled gradients can be read
            scaler.unscale_(opt)
            seen = [np.asarray(p.grad._value) for p in params]
            if not scaler._found_inf:
                opt.step()
            scaler._update()
            opt.clear_grad()
        else:
            scaler.minimize(opt, None)
            seen = [np.asarray(p._value) for p in params]
        trace.append((scaler._scale, scaler._found_inf, seen))
    return trace


def _port_run(values, grads, scaler_kw, probe):
    params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
              for v in values]
    opt = SGD(0.1, parameters=params)
    scaler = amp.GradScaler(**scaler_kw)
    trace = []
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        if probe:
            scaler.unscale_(opt)
            seen = [p.grad.numpy().copy() for p in params]
            scaler.minimize(opt, None)  # does not unscale again
        else:
            scaler.minimize(opt, None)
            seen = [p.detach().numpy().copy() for p in params]
        trace.append((scaler._scale, scaler._found_inf, seen))
    return trace


@pytest.mark.parametrize("scaler_kw,bad,dtype", [
    ({"init_loss_scaling": 2.0**10, "incr_every_n_steps": 2},
     {2, 5, 6}, np.float32),
    ({"init_loss_scaling": 2.0**4, "incr_every_n_steps": 3,
      "decr_every_n_nan_or_inf": 2}, {1, 2, 4, 5, 6}, np.float32),
    ({"init_loss_scaling": 2.0, "decr_ratio": 0.25,
      "incr_every_n_steps": 100}, {0, 1, 3}, np.float32),
    ({"init_loss_scaling": 2.0**8, "use_dynamic_loss_scaling": False},
     {3}, np.float32),
    ({"init_loss_scaling": 2.0**6, "incr_every_n_steps": 2},
     {3, 4}, np.float16)])
def test_scale_trajectory_and_skips_match_reference(scaler_kw, bad, dtype):
    values = _params(dtype=dtype)  # a gradient has its parameter's dtype
    grads = _grads(8, bad, dtype)
    # fp16: compare the unscaled gradients (see the module's docstring)
    probe = dtype == np.float16
    ref = _ref_run(values, grads, scaler_kw, probe)
    got = _port_run(values, grads, scaler_kw, probe)
    for step, ((rs, rf, rp), (ts, tf, tp)) in enumerate(zip(ref, got)):
        assert (ts, tf) == (rs, rf), step
        assert tf == (step in bad)
        for a, b in zip(tp, rp):
            np.testing.assert_array_equal(a, b)
    assert amp.current_loss_scale() == got[-1][0]


def test_backoff_getters_and_state_dict_cross_packages():
    kw = {"init_loss_scaling": 2.0**12, "incr_ratio": 4.0,
          "decr_ratio": 0.125, "incr_every_n_steps": 7,
          "decr_every_n_nan_or_inf": 3}
    ref, port = jscaler.AmpScaler(**kw), amp.GradScaler(**kw)
    assert port.backoff() == ref.backoff() == 2.0**9
    assert port.backoff(factor=0.5, min_scale=2.0**8) == \
        ref.backoff(factor=0.5, min_scale=2.0**8) == 2.0**8
    assert port.state_dict() == ref.state_dict()
    port._good_steps = 5
    other = jscaler.AmpScaler()
    other.load_state_dict(port.state_dict())
    assert other.state_dict() == port.state_dict()
    back = amp.AmpScaler()
    back.load_state_dict(ref.state_dict())
    assert back.state_dict() == ref.state_dict()
    port.set_init_loss_scaling(3.0)
    assert port.get_init_loss_scaling() == 3.0
    assert float(port.get_loss_scaling()) == 3.0
    assert port.is_enable() and port.is_use_dynamic_loss_scaling()
    off = amp.GradScaler(enable=False)
    x = torch.ones(2)
    assert off.scale(x) is x


def test_unscale_then_step_unscales_once_where_the_reference_twice():
    values = _params()
    g = [(np.ones(sh) * 64).astype(np.float32) for sh in SHAPES]
    scale = 8.0
    # reference: unscale_ then step divides by the scale twice
    params = [Parameter(jnp.asarray(v), name=f"q{i}")
              for i, v in enumerate(values)]
    opt = paddle.optimizer.SGD(learning_rate=1.0, parameters=params)
    for p, gi in zip(params, g):
        p.grad = wrap_raw(jnp.asarray(gi))
    ref = jscaler.AmpScaler(init_loss_scaling=scale)
    ref.unscale_(opt)
    ref.step(opt)
    for p, v in zip(params, values):
        np.testing.assert_array_equal(np.asarray(p._value),
                                      v - 64 / scale / scale)
    # port: once
    tparams = [torch.nn.Parameter(torch.from_numpy(v.copy()))
               for v in values]
    topt = SGD(1.0, parameters=tparams)
    for p, gi in zip(tparams, g):
        p.grad = torch.from_numpy(gi.copy())
    port = amp.GradScaler(init_loss_scaling=scale)
    port.unscale_(topt)
    port.step(topt)
    port.update()
    for p, v in zip(tparams, values):
        np.testing.assert_array_equal(p.detach().numpy(), v - 64 / scale)
    assert not port._unscaled  # the next step unscales again


def test_a_skipped_step_changes_no_bit_of_the_adam_state():
    gen = torch.Generator().manual_seed(0)
    net = Sequential(Linear(8, 16, generator=gen), ReLU(),
                     Linear(16, 4, generator=gen)).to(torch.bfloat16)
    opt = Adam(1e-2, parameters=net.parameters(), multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=2.0**10)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rng.randint(0, 4, 6).astype(np.int64))

    def step(poison=False):
        loss = CrossEntropyLoss()(net(x).float(), y)
        scaled = scaler.scale(loss)
        scaled.backward()
        if poison:
            net[0].weight.grad[0, 0] = float("inf")
        scaler.minimize(opt, scaled)

    def snapshot():
        st = {f"{i}.{k}": v.clone() for i, p in enumerate(net.parameters())
              for k, v in opt.state_for(p).items()}
        st.update({f"p{i}": p.detach().clone()
                   for i, p in enumerate(net.parameters())})
        return st, opt._global_step

    step()
    before, gstep = snapshot()
    step(poison=True)
    after, gstep2 = snapshot()
    assert scaler._found_inf and scaler._scale == 2.0**9
    assert gstep2 == gstep == 1
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert all(p.grad is None for p in net.parameters())
    step()
    moved, gstep3 = snapshot()
    assert not scaler._found_inf and gstep3 == 2
    assert not torch.equal(moved["p0"], before["p0"])
    assert not torch.equal(moved["0.master"], before["0.master"])


def test_fp16_o1_loop_with_loss_scaling_trains():
    gen = torch.Generator().manual_seed(0)
    net = Sequential(Linear(8, 32, generator=gen), ReLU(),
                     Linear(32, 4, generator=gen))
    opt = SGD(0.5, parameters=net.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0**15)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    y = torch.from_numpy((rng.rand(64) * 4).astype(np.int64))
    losses = []
    for _ in range(30):
        with amp.auto_cast(dtype="float16"):
            out = net(x)
        assert out.dtype == torch.float16
        loss = CrossEntropyLoss()(out.float(), y)
        scaled = scaler.scale(loss)
        scaled.backward()
        assert all(p.grad.dtype == torch.float32 for p in net.parameters())
        scaler.minimize(opt, scaled)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
