"""Second and third derivatives through the LayerNorm (#5/#6) and flash
attention (#1-#4) Functions, against the reference's ``jax.grad`` of
``jax.grad`` on the CPU.

The port's Functions run their kernels' plain versions here, and under
``create_graph=True`` their backward is itself an autograd Function
(``_LayerNormBwdFn``: the closed-form ``_ln_bwd_vjp``; ``_FlashBwdFn``: the
vector-Jacobian product of ``_bwd_recompute``), the same code the card
runs around its kernels. The reference differentiates its custom VJPs'
jnp fallbacks twice (``nn.functional.layer_norm``'s two-pass path,
``flash_attention_blhd`` through ``xla_attention``). Inputs are made by
numpy from a seed; every comparison is f32 against f32."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import wrap_raw
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import attention as jatt
from paddle_tpu.ops import flash_tpu as jflash
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import flash_tpu as tflash
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32 on both sides through the same math in other orders and, for the
# LayerNorm, a closed form against autodiff: each tensor within this share
# of its largest magnitude (third order: one more product of sums)
SECOND_TOL = 2e-5
THIRD_TOL = 1e-4
# the WGAN-GP penalty's gradient through two blocks (LayerNorm, attention,
# GELU MLP, residuals) and a linear head, second order
GP_TOL = 1e-4
GP_LAMBDA = 10.0


def _worst(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
def _ln_inputs(seed=0, rows=6, hidden=32):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    return (f(rows, hidden), 1 + f(hidden, sc=0.3), f(hidden, sc=0.1),
            f(rows, hidden), np.linspace(0, 1, hidden).astype(np.float32))


def _ln_orders_jax(x, w, b, c, a):
    """(second, third) derivatives of the reference's layer_norm: a loss
    whose output gradient g depends on x, w and b (through y³), a penalty
    on the first derivative in x, w and b, then the sum of squares of the
    second."""
    def loss(x_, w_, b_):
        y = JF.layer_norm(wrap_raw(x_), x_.shape[-1], wrap_raw(w_),
                          wrap_raw(b_))._value
        return (y * c).sum() + 0.1 * (y ** 3).sum()

    def penalty(x_, w_, b_):
        gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(x_, w_, b_)
        return (gx ** 2).sum() + (gw ** 2 * a).sum() + (gb * a).sum()

    second = jax.grad(penalty, argnums=(0, 1, 2))

    def third(x_, w_, b_):
        return sum((g ** 2).sum() for g in second(x_, w_, b_))

    both = jax.jit(lambda *a: (second(*a),
                               jax.grad(third, argnums=(0, 1, 2))(*a)))
    return [[np.asarray(g) for g in gs]
            for gs in both(*(jnp.asarray(v) for v in (x, w, b)))]


def _ln_orders_port(x, w, b, c, a):
    tx, tw, tb = (_t(v) for v in (x, w, b))
    tc, ta = torch.from_numpy(c), torch.from_numpy(a)
    y = tfused.fused_layer_norm(tx, tw, tb)
    loss = (y * tc).sum() + 0.1 * (y ** 3).sum()
    gx, gw, gb = torch.autograd.grad(loss, [tx, tw, tb], create_graph=True)
    pen = (gx ** 2).sum() + (gw ** 2 * ta).sum() + (gb * ta).sum()
    second = torch.autograd.grad(pen, [tx, tw, tb], create_graph=True)
    third = torch.autograd.grad(sum((g ** 2).sum() for g in second),
                                [tx, tw, tb])
    return ([g.detach().numpy() for g in second],
            [g.numpy() for g in third])


@pytest.fixture(scope="module")
def ln_orders():
    inputs = _ln_inputs()
    return _ln_orders_port(*inputs), _ln_orders_jax(*inputs)


@pytest.mark.parametrize("i,name", enumerate(["x", "weight", "bias"]))
def test_layer_norm_second_derivative_matches_reference(ln_orders, i, name):
    (second, _), (want, _) = ln_orders
    assert _worst(second[i], want[i]) <= SECOND_TOL, name


@pytest.mark.parametrize("i,name", enumerate(["x", "weight", "bias"]))
def test_layer_norm_third_derivative_matches_reference(ln_orders, i, name):
    (_, third), (_, want) = ln_orders
    assert _worst(third[i], want[i]) <= THIRD_TOL, name


def test_layer_norm_double_backward_gives_each_cotangent_its_term():
    """``_ln_bwd_vjp`` with one cotangent at a time against autograd of
    the plain backward (``_ln_bwd_reference``), in x, weight and g."""
    x, w, _, g, _ = _ln_inputs(seed=1, rows=5, hidden=24)
    rng = np.random.RandomState(2)
    cts = [rng.randn(*s).astype(np.float32) for s in ((5, 24), (24,), (24,))]
    for k in range(3):
        tx, tw, tg = (_t(v) for v in (x, w, g))
        outs = tfused._ln_bwd_reference(tx, tw, tg)
        want = torch.autograd.grad(outs[k], [tx, tw, tg],
                                   torch.from_numpy(cts[k]),
                                   allow_unused=True)
        # autograd hands a Function zeros for an unused output
        given = [torch.zeros(s) for s in ((5, 24), (24,), (24,))]
        given[k] = torch.from_numpy(cts[k])
        got = tfused._ln_bwd_vjp(tx.detach(), tw.detach(), tg.detach(),
                                 *given, 1e-5)
        for gt, wt in zip(got, want):
            wt = torch.zeros_like(gt) if wt is None else wt
            assert _worst(gt.numpy(), wt.numpy()) <= SECOND_TOL, k


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_inputs(seed, shape=(2, 16, 2, 32), biased=False):
    rng = np.random.RandomState(seed)
    f = lambda: rng.randn(*shape).astype(np.float32)
    q, k, v, c = f(), f(), f(), f()
    bias = None
    if biased:
        bias = np.zeros(shape[:2], np.float32)
        bias[1, shape[1] - 5:] = -1e9
    return q, k, v, c, bias


def _attn_second_jax(q, k, v, c, causal, bias):
    def fwd(q_, k_, v_):
        if causal:
            return jflash.flash_attention_blhd(q_, k_, v_)
        b4 = None if bias is None else jnp.asarray(bias)[:, None, None, :]
        # the reference takes a bias in the [b, h, L, d] layout only
        t = lambda a: a.transpose(0, 2, 1, 3)
        return t(jatt.xla_attention(t(q_), t(k_), t(v_), causal=False,
                                    bias=b4))

    def penalty(q_, k_, v_):
        loss = lambda *a: ((fwd(*a) * c).sum() + (fwd(*a) ** 2).sum())
        gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q_, k_, v_)
        return (gq ** 2).sum() + (gk ** 3).sum() + (gv * c).sum()

    return [np.asarray(g) for g in jax.jit(jax.grad(
        penalty, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))]


def _attn_second_port(q, k, v, c, causal, bias):
    tq, tk, tv = (_t(a) for a in (q, k, v))
    tc = torch.from_numpy(c)
    if causal:
        out, _ = tflash.flash_attention_blhd(tq, tk, tv)
    else:
        out, _ = tflash.flash_attention_full(
            tq, tk, tv, None if bias is None else torch.from_numpy(bias))
    loss = (out * tc).sum() + (out ** 2).sum()
    gq, gk, gv = torch.autograd.grad(loss, [tq, tk, tv], create_graph=True)
    pen = (gq ** 2).sum() + (gk ** 3).sum() + (gv * tc).sum()
    return [g.numpy() for g in torch.autograd.grad(pen, [tq, tk, tv])]


@pytest.mark.parametrize("causal,biased", [(True, False), (False, False),
                                           (False, True)])
def test_attention_second_derivative_matches_reference(causal, biased):
    q, k, v, c, bias = _attn_inputs(seed=3 + biased, biased=biased)
    got = _attn_second_port(q, k, v, c, causal, bias)
    want = _attn_second_jax(q, k, v, c, causal, bias)
    for g, w, name in zip(got, want, "qkv"):
        assert _worst(g, w) <= SECOND_TOL, name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_gives_out_and_lse_no_gradient(causal):
    """``_FlashBwdFn`` recomputes P and delta from q, k and v, so ``out``
    and ``lse`` (here with graphs back to q, k and v) get no gradient, and
    the gradient of its outputs in (q, k, v, dout) is exactly the
    reference's: the vjp of the reference's attention gradient."""
    q, k, v, c, _ = _attn_inputs(seed=7)
    dout = np.random.RandomState(8).randn(*q.shape).astype(np.float32)
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, dout))
    out, lse = tflash._flash_reference(tq, tk, tv, causal)
    assert out.requires_grad and lse.requires_grad
    dq, dk, dv = tflash._FlashBwdFn.apply(tq, tk, tv, out, lse, tdo, causal,
                                          None)
    tc = torch.from_numpy(c)
    total = (dq * tc).sum() + (dk ** 2).sum() + (dv * tc ** 2).sum()
    assert torch.autograd.grad(total, [out, lse], retain_graph=True,
                               allow_unused=True) == (None, None)
    got = torch.autograd.grad(total, [tq, tk, tv, tdo])

    def grads_of(q_, k_, v_, do_):
        _, vjp = jax.vjp(lambda *a: jatt.xla_attention(
            *a, causal=causal, layout="blhd"), q_, k_, v_)
        gq, gk, gv = vjp(do_)
        return (gq * c).sum() + (gk ** 2).sum() + (gv * c ** 2).sum()

    want = jax.jit(jax.grad(grads_of, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (q, k, v, dout)))
    for g, w, name in zip(got, want, ("q", "k", "v", "dout")):
        assert _worst(g.numpy(), np.asarray(w)) <= SECOND_TOL, name


@pytest.mark.parametrize("causal,shared", [(True, False), (False, False),
                                           (True, True)])
def test_attention_third_derivative_matches_the_plain_path(causal, shared):
    """Second and third derivatives with create_graph at every order,
    through the flash Functions against torch autograd of the plain
    attention (``_flash_reference``): ``_FlashBwdFn``'s backward, itself
    differentiated, must count only the recompute's direct uses of q, k,
    v and dout (dout's own graph reaches them again, and q may be k and
    v)."""
    rng = np.random.RandomState(11)
    base = [rng.randn(1, 12, 2, 32).astype(np.float32) for _ in range(3)]
    if causal:
        fn = lambda *a: tflash.flash_attention_blhd(*a)[0]
    else:
        fn = lambda *a: tflash.flash_attention_full(*a)[0]

    def orders(f):
        q, k, v = (_t(a) for a in base)
        args = (q, q, q) if shared else (q, k, v)
        (g1,) = torch.autograd.grad((f(*args) ** 3).sum(), [q],
                                    create_graph=True)
        (g2,) = torch.autograd.grad((g1 ** 2).sum(), [q],
                                    create_graph=True)
        (g3,) = torch.autograd.grad((g2 ** 2).sum(), [q])
        return [g2.detach().numpy(), g3.numpy()]

    got = orders(fn)
    want = orders(lambda *a: tflash._flash_reference(*a, causal)[0])
    assert _worst(got[0], want[0]) <= SECOND_TOL
    assert _worst(got[1], want[1]) <= THIRD_TOL


def test_first_derivative_keeps_its_bits_under_create_graph():
    """With create_graph the first derivative is still the kernels' (the
    plain backward here): the same bits as without it."""
    q, k, v, _, _ = _attn_inputs(seed=9)
    x, w, b, _, _ = _ln_inputs(seed=9)
    for create in (False, True):
        tq, tk, tv, tx, tw, tb = (_t(a) for a in (q, k, v, x, w, b))
        loss = ((tflash.flash_attention_blhd(tq, tk, tv)[0] ** 2).sum()
                + (tfused.fused_layer_norm(tx, tw, tb) ** 3).sum())
        grads = torch.autograd.grad(loss, [tq, tk, tv, tx, tw, tb],
                                    create_graph=create)
        if not create:
            plain = [g.clone() for g in grads]
    assert all(torch.equal(a, b.detach()) for a, b in zip(plain, grads))


def test_grad_refuses_no_grad_vars_that_the_reference_ignores():
    """The reference's ``autograd.grad`` accepts ``no_grad_vars`` and never
    reads it; the port refuses it rather than ignore it."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no_grad_vars"):
        ptt.grad((x ** 2).sum(), [x], no_grad_vars=[x])


# ---------------------------------------------------------------------------
# WGAN-GP through GPT-2 blocks
# ---------------------------------------------------------------------------
class _JCritic(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.blocks = jnn.LayerList([jgpt.GPTBlock(cfg) for _ in range(2)])
        self.head = jnn.Linear(cfg.hidden_size, 1)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)


class _TCritic(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.blocks = torch.nn.ModuleList(
            [tgpt.GPTBlock(cfg, gen, "cpu") for _ in range(2)])
        self.head = Linear(cfg.hidden_size, 1, device="cpu")

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)


def _critic_cfg(mod):
    # GPT-2 tiny's widths (hidden 128, 4 heads of 32), two blocks, causal
    return mod.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                         num_heads=4, max_position_embeddings=256,
                         hidden_dropout=0.0, attention_dropout=0.0)


def test_wgan_gp_penalty_gradient_through_gpt2_blocks_matches_reference(
        monkeypatch):
    """The WGAN-GP penalty (Gulrajani et al. 2017), λ·(‖∇ₓD(x̂)‖ − 1)² on
    interpolated inputs, differentiated in the critic's weights: two GPT-2
    tiny blocks and a linear head, the reference's weights carried over.
    The port's attention is forced onto the flash Functions, so both
    LayerNorms and the attention of each block go through the
    differentiable backward Functions."""
    paddle.seed(11)
    jcritic = _JCritic(_critic_cfg(jgpt))
    params = {k: jnp.asarray(v) for k, v in jfunc.get_params(jcritic).items()}
    rng = np.random.RandomState(12)
    real, fake = (rng.randn(2, 16, 128).astype(np.float32) for _ in range(2))
    eps = rng.rand(2, 1, 1).astype(np.float32)
    xhat = eps * real + (1 - eps) * fake
    apply = jfunc.functionalize(jcritic, training=False)

    def penalty(p, x):
        gx = jax.grad(lambda x_: apply(p, {}, x_)[0].sum())(x)
        norm = jnp.sqrt((gx ** 2).sum(axis=(1, 2)) + 1e-12)
        return GP_LAMBDA * ((norm - 1.0) ** 2).mean()

    want_pen, want = jax.jit(jax.value_and_grad(penalty))(
        params, jnp.asarray(xhat))

    # the port's flash Functions (the reference reads the same variable:
    # set it after the reference has run)
    monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "flash_tpu")
    critic = load_jax_params(_TCritic(_critic_cfg(tgpt)),
                             {k: np.asarray(v) for k, v in params.items()})
    critic.eval()
    calls = {"ln": 0, "attn": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tfused, "_ln_bwd_vjp",
                        counted("ln", tfused._ln_bwd_vjp))
    monkeypatch.setattr(tflash, "_bwd_recompute",
                        counted("attn", tflash._bwd_recompute))
    x = _t(xhat)
    (gx,) = torch.autograd.grad(critic(x).sum(), [x], create_graph=True)
    norm = torch.sqrt((gx ** 2).sum(dim=(1, 2)) + 1e-12)
    pen = GP_LAMBDA * ((norm - 1.0) ** 2).mean()
    names, tensors = zip(*critic.named_parameters())
    # the head's bias does not reach ∇ₓD: no gradient (the reference's is
    # zero)
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad(pen, list(tensors), allow_unused=True), tensors)]
    # the second-order terms of each block's two LayerNorms and its
    # attention came from the backward Functions
    assert calls == {"ln": 4, "attn": 2}
    assert abs(float(pen.detach()) - float(want_pen)) <= \
        GP_TOL * float(want_pen)
    for name, g in zip(names, got):
        if not np.asarray(want[name]).any():
            assert not g.numpy().any(), name
            continue
        assert _worst(g.numpy(), want[name]) <= GP_TOL, name
