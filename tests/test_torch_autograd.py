"""``paddle_tpu_torch.autograd`` on the CPU against ``paddle_tpu.autograd``:
``grad`` to third order, the gradient penalty (WGAN-GP), the freed-graph
error, ``create_graph=False`` results that cannot be differentiated again,
``PyLayer``, the eager autograd basics, and the kernels' refusal of a
second derivative. Tolerance: f32 values 1e-5 relative; second and third
derivatives 1e-4 relative (two libraries' f32 rounding compounds)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops.flash_tpu import (_flash_reference,
                                            flash_attention_blhd,
                                            flash_attention_full)
from paddle_tpu_torch.ops.fused import _ln_reference, fused_layer_norm
from torch_tensor_parity import on_cpu  # noqa: F401
import torch_threads  # noqa: F401  (one torch thread a worker)

pytestmark = pytest.mark.usefixtures("on_cpu")


def _both(a, stop_gradient=False):
    return (paddle.to_tensor(a, stop_gradient=stop_gradient),
            ptt.to_tensor(a, stop_gradient=stop_gradient))


def test_cubic_second_derivative_matches_the_reference():
    a = np.array([1.0, 2.0, -3.0], np.float32)
    outs = []
    for P, x in zip((paddle, ptt), _both(a)):
        (g,) = P.autograd.grad((x ** 3).sum(), [x], create_graph=True)
        (gg,) = P.autograd.grad((g ** 2).sum(), [x])
        outs.append((np.asarray(g.detach().numpy()),
                     np.asarray(gg.numpy())))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5)
    np.testing.assert_allclose(outs[1][1], 36 * a ** 3, rtol=1e-5)


def test_third_order_matches_the_reference():
    rng = np.random.RandomState(0)
    a = rng.randn(5).astype(np.float32)
    outs = []
    for P, x in zip((paddle, ptt), _both(a)):
        y = (P.tanh(x) * x ** 2).sum()
        (g1,) = P.grad(y, [x], create_graph=True)
        (g2,) = P.grad(g1.sum(), [x], create_graph=True)
        (g3,) = P.grad(g2.sum(), [x])
        outs.append(np.asarray(g3.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)
    x = ptt.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
    (g1,) = ptt.grad((x ** 4).sum(), [x], create_graph=True)
    (g2,) = ptt.grad(g1.sum(), [x], create_graph=True)
    (g3,) = ptt.grad(g2.sum(), [x])
    np.testing.assert_allclose(g3.numpy(), [48.0], rtol=1e-6)


def test_penalty_through_matmul_and_tanh_matches_the_reference():
    rng = np.random.RandomState(0)
    wa, xa = rng.randn(4, 4).astype(np.float32), rng.randn(2, 4).astype(
        np.float32)
    outs = []
    for P in (paddle, ptt):
        w = P.to_tensor(wa, stop_gradient=False)
        x = P.to_tensor(xa, stop_gradient=False)
        y = P.tanh(P.matmul(x, w)).sum()
        (gx,) = P.autograd.grad(y, [x], create_graph=True)
        (gw,) = P.autograd.grad((gx ** 2).sum(), [w])
        outs.append(np.asarray(gw.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)


def _gelu_critic(P, params, x):
    w1, b1, w2, b2 = params
    h = P.nn.functional.gelu(P.matmul(x, w1) + b1)
    return (P.matmul(h, w2) + b2).sum()


def test_wgan_gp_penalty_gradient_matches_the_reference():
    """The gradient penalty of WGAN-GP (lambda = 10; Gulrajani et al.
    2017) on a small GELU MLP critic: the penalty's gradient with respect
    to every critic parameter, both packages on the same weights and
    interpolates."""
    rng = np.random.RandomState(1)
    shapes = [(6, 16), (16,), (16, 1), (1,)]
    arrays = [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]
    real, fake = rng.randn(8, 6).astype(np.float32), rng.randn(8, 6).astype(
        np.float32)
    eps = rng.rand(8, 1).astype(np.float32)
    xhat = eps * real + (1 - eps) * fake
    outs = []
    for P in (paddle, ptt):
        params = [P.to_tensor(a, stop_gradient=False) for a in arrays]
        x = P.to_tensor(xhat, stop_gradient=False)
        (gx,) = P.grad(_gelu_critic(P, params, x), [x], create_graph=True)
        norm = P.sqrt((gx ** 2).sum(axis=1) + 1e-12)
        penalty = 10.0 * ((norm - 1.0) ** 2).mean()
        grads = P.grad(penalty, params[:3])  # b2 does not reach it
        outs.append([np.asarray(g.numpy()) for g in grads])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gradient_penalty_trains():
    ptt.seed(0)
    net = ptt.nn.Linear(3, 1, device="cpu")
    opt = ptt.optimizer.SGD(learning_rate=0.05, parameters=net.parameters())
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(15):
        x = ptt.to_tensor(rng.randn(8, 3).astype(np.float32),
                          stop_gradient=False)
        (gx,) = ptt.autograd.grad(net(x).sum(), [x], create_graph=True)
        loss = (((gx ** 2).sum(axis=1) - 1.0) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


def test_create_graph_false_gradients_cannot_be_differentiated():
    x = ptt.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
    (g,) = ptt.autograd.grad((x ** 3).sum(), [x], create_graph=False)
    assert not g.requires_grad
    with pytest.raises(RuntimeError, match="create_graph=False"):
        ptt.autograd.grad((g ** 2).sum(), [x])


def test_freed_graph_raises_the_clear_error():
    """As the reference's: after a backward that frees the graph, a
    create_graph sweep over it raises 'already been freed'."""
    for P in (paddle, ptt):
        x = P.to_tensor(np.array([3.0], np.float32), stop_gradient=False)
        y = x * x
        y.backward()
        with pytest.raises(RuntimeError, match="already been freed"):
            P.autograd.grad([y], [x], create_graph=True)


def test_grad_keeps_other_leaves_and_refuses_unreached_inputs():
    x = ptt.to_tensor([3.0], stop_gradient=False)
    w = ptt.to_tensor([2.0], stop_gradient=False)
    (w * 5).backward()
    y = x * x * w
    (gx,) = ptt.grad(y, x)
    np.testing.assert_allclose(gx.numpy(), [12.0])
    assert x.grad is None
    np.testing.assert_allclose(w.grad.numpy(), [5.0])
    # the graph is kept, as the reference keeps it: a second call works
    (gw,) = ptt.grad(y, w)
    np.testing.assert_allclose(gw.numpy(), [9.0])
    z = ptt.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="unreachable"):
        ptt.grad(y, [x, z])
    gx, gz = ptt.grad(y, [x, z], allow_unused=True)
    assert gz is None and gx is not None
    ptt.autograd.backward([x * 2, x * 3], [ptt.to_tensor([1.0]), None])
    np.testing.assert_allclose(x.grad.numpy(), [5.0])


def test_eager_autograd_basics_match_the_reference():
    """test_tensor_core's autograd cases, both packages."""
    for P in (paddle, ptt):
        x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0, 6.0])
        x = P.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
        b = P.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
        ((x + b) ** 2).sum().backward()
        np.testing.assert_allclose(b.grad.numpy(), np.full(4, 12.0))
        x = P.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        (x * 3).backward()
        np.testing.assert_allclose(x.grad.numpy(), [5.0])
        with P.no_grad():
            y = x * 2
        assert y.stop_gradient if P is paddle else not y.requires_grad
        x = P.to_tensor([1.0, 1.0], stop_gradient=False)
        (x * 3).backward(P.to_tensor([1.0, 2.0]))
        np.testing.assert_allclose(x.grad.numpy(), [3.0, 6.0])
        seen = []
        x = P.to_tensor([1.0], stop_gradient=False)
        x.register_hook(lambda g: seen.append(float(g.numpy()[0])))
        (x * 4).backward()
        assert seen == [4.0]
        x = P.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
        parts = P.split(x, 2)
        (parts[0].sum() * 2 + parts[1].sum() * 3).backward()
        np.testing.assert_allclose(x.grad.numpy(), [2, 2, 2, 3, 3, 3])


class _Double:
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


class _Scaled:
    """Two inputs, a keyword argument, ``extra`` and two outputs."""

    @staticmethod
    def forward(ctx, x, y, k=1.0):
        ctx.save_for_backward(x, y)
        ctx.extra["k"] = k
        return x * y * k, x + y

    @staticmethod
    def backward(ctx, ga, gb):
        x, y = ctx.saved_tensor()
        k = ctx.extra["k"]
        return ga * y * k + gb, ga * x * k + gb


def _pylayer(P, body):
    return type(body.__name__, (P.autograd.PyLayer,),
                {"forward": body.forward, "backward": body.backward})


def test_pylayer_matches_the_reference():
    rng = np.random.RandomState(0)
    xa, ya = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    res = []
    for P in (paddle, ptt):
        double, scaled = _pylayer(P, _Double), _pylayer(P, _Scaled)
        x = P.to_tensor(xa, stop_gradient=False)
        y = P.to_tensor(ya, stop_gradient=False)
        double.apply(x).sum().backward()
        gx1 = np.asarray(x.grad.numpy()).copy()
        x.clear_grad() if P is paddle else setattr(x, "grad", None)
        a, b = scaled.apply(x, y, k=3.0)
        (a * 2 + b).sum().backward()
        res.append((gx1, np.asarray(x.grad.numpy()),
                    np.asarray(y.grad.numpy()),
                    np.asarray(a.detach().numpy())))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # one torch.autograd.Function per subclass, made once
    scaled = _pylayer(ptt, _Scaled)
    x = ptt.to_tensor(xa, stop_gradient=False)
    scaled.apply(x, x)
    fn = scaled._torch_function
    scaled.apply(x, x, k=2.0)
    assert scaled._torch_function is fn
    assert issubclass(fn, torch.autograd.Function)


def test_straight_through_pylayer_matches_autograd_of_its_function():
    """A straight-through estimator (forward: round; backward: the
    identity) against autograd of the plain x + (round(x) - x).detach()."""

    class STE(ptt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return torch.round(x)

        @staticmethod
        def backward(ctx, g):
            return g

    rng = np.random.RandomState(2)
    a = rng.randn(4, 8).astype(np.float32) * 3
    x1 = ptt.to_tensor(a, stop_gradient=False)
    x2 = ptt.to_tensor(a, stop_gradient=False)
    w = torch.from_numpy(rng.randn(8, 3).astype(np.float32))
    y1 = (STE.apply(x1) @ w).tanh().sum()
    y2 = ((x2 + (torch.round(x2) - x2).detach()) @ w).tanh().sum()
    y1.backward()
    y2.backward()
    np.testing.assert_array_equal(y1.detach().numpy(), y2.detach().numpy())
    np.testing.assert_array_equal(x1.grad.numpy(), x2.grad.numpy())


def test_kernels_give_a_second_derivative_on_every_device():
    """The LayerNorm (#5/#6) and flash attention (#1-#4) Functions take
    create_graph=True: their backward is the kernels' (the plain versions
    here) with a differentiable backward of its own, so the second
    derivative equals that of the plain path differentiated twice by
    autograd (f32, within 1e-4 of each tensor's largest magnitude: the
    closed forms sum in other orders). A first derivative keeps its
    bits."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32)).requires_grad_()
    w, b = torch.randn(8), torch.randn(8)

    def second(f, t):
        (g,) = torch.autograd.grad((f(t) ** 3).sum(), t, create_graph=True)
        (gg,) = torch.autograd.grad((g ** 2).sum(), t)
        return gg

    def close(got, want):
        tol = 1e-4 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol

    close(second(lambda t: fused_layer_norm(t, w, b), x),
          second(lambda t: _ln_reference(t, w, b), x))
    (g,) = torch.autograd.grad((fused_layer_norm(x, w, b) ** 3).sum(), x)
    assert g.shape == x.shape and not g.requires_grad
    q = torch.from_numpy(rng.randn(1, 16, 2, 32).astype(np.float32)
                         ).requires_grad_()
    for fn, causal in ((flash_attention_blhd, True),
                       (flash_attention_full, False)):
        got = second(lambda t: fn(t, t, t)[0], q)
        close(got, second(lambda t: _flash_reference(t, t, t, causal)[0], q))
        out, _ = fn(q, q, q)
        (gq,) = ptt.grad((out ** 2).sum(), [q])
        ref, _ = _flash_reference(q, q, q, causal)
        (want,) = ptt.grad((ref ** 2).sum(), [q])
        assert torch.isfinite(gq).all() and not gq.requires_grad
        close(gq, want)
