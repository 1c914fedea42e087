"""The port's optimizers (paddle_tpu_torch.optimizer) against the
reference's eager `step()`: every optimizer for 3 steps on the same
parameters and gradients, with `L2Decay`, `L1Decay` (folded as L2, as
the reference folds it) and a per-parameter `regularizer`, with the
three clips, and under `multi_precision`; the options that are not
ported raise, and the wrong types are refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, wrap_raw
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip
import torch_threads  # noqa: F401  (one torch thread a worker)

SHAPES = ((20, 15), (7,), (5000,))
STEPS = 3
# f32 on both sides, the same formula per element: the results agree to
# an f32 rounding or two (sums of squares, in the norms of Lars, Lamb and
# the clips, are taken in another order)
RTOL, ATOL = 1e-6, 1e-7
# bf16 residents: the f32 masters agree as above; a resident is the
# master rounded to bf16, so it may differ by one bf16 ulp where a master
# sits on a rounding boundary
BF16_RTOL = 2.0 ** -8


def _mod(side):
    return (paddle.optimizer, jreg, jclip) if side == "ref" else \
        (topt, treg, tclip)


def _cases():
    """id -> (optimizer name, kwargs builder(side), per-parameter
    regularizer coefficient or None, multi_precision)."""
    def kw(**fixed):
        return lambda side: dict(fixed)

    def with_reg(cls_name, coeff, **fixed):
        return lambda side: dict(weight_decay=getattr(_mod(side)[1],
                                                      cls_name)(coeff),
                                 **fixed)

    def with_clip(clip_name, *args, **fixed):
        return lambda side: dict(grad_clip=getattr(_mod(side)[2],
                                                   clip_name)(*args),
                                 **fixed)

    return {
        "sgd_l2": ("SGD", with_reg("L2Decay", 0.01, learning_rate=0.1),
                   None, False),
        "sgd_float_decay_own_reg": ("SGD", kw(learning_rate=0.1,
                                              weight_decay=0.05), 0.3, False),
        "momentum_l1": ("Momentum", with_reg("L1Decay", 0.02,
                                             learning_rate=0.1), None,
                        False),
        "momentum_nesterov_own_reg": ("Momentum", kw(
            learning_rate=0.1, use_nesterov=True), 0.2, False),
        "momentum_bf16_master": ("Momentum", with_reg(
            "L2Decay", 0.01, learning_rate=0.1, multi_precision=True), None,
            True),
        "lars": ("LarsMomentum", kw(learning_rate=0.1, lars_coeff=0.01),
                 None, False),
        "adagrad": ("Adagrad", kw(learning_rate=0.1, weight_decay=0.01,
                                  initial_accumulator_value=0.1), None,
                    False),
        "adam_l2_own_reg": ("Adam", with_reg("L2Decay", 0.01,
                                             learning_rate=0.01), 0.3,
                            False),
        "adam_l1": ("Adam", with_reg("L1Decay", 0.05, learning_rate=0.01),
                    None, False),
        "adam_global_norm": ("Adam", with_clip("ClipGradByGlobalNorm", 1.0,
                                               learning_rate=0.01), None,
                             False),
        "adam_bf16_master_clip": ("Adam", with_clip(
            "ClipGradByGlobalNorm", 1.0, learning_rate=0.01,
            multi_precision=True, weight_decay=0.01), 0.3, True),
        "adam_by_value": ("Adam", with_clip("ClipGradByValue", 0.5,
                                            learning_rate=0.01), None,
                          False),
        "adam_by_norm": ("Adam", with_clip("ClipGradByNorm", 2.0,
                                           learning_rate=0.01), None,
                         False),
        "adamw_decay_fun": ("AdamW", kw(
            learning_rate=0.01, weight_decay=0.1,
            apply_decay_param_fun=lambda n: not n.endswith("1")), 0.3,
            False),
        "adamw_bf16_master_clip": ("AdamW", with_clip(
            "ClipGradByGlobalNorm", 1.0, learning_rate=0.01,
            weight_decay=0.1, multi_precision=True), None, True),
        "adamax": ("Adamax", kw(learning_rate=0.01, weight_decay=0.01),
                   None, False),
        "adadelta": ("Adadelta", kw(learning_rate=1.0, rho=0.9), 0.1,
                     False),
        "rmsprop": ("RMSProp", kw(learning_rate=0.01, momentum=0.9), None,
                    False),
        "rmsprop_centered": ("RMSProp", with_reg("L1Decay", 0.01,
                                                 learning_rate=0.01,
                                                 centered=True), None,
                             False),
        "lamb": ("Lamb", kw(learning_rate=0.01, lamb_weight_decay=0.05,
                            exclude_from_weight_decay_fn=lambda p:
                            len(p.shape) == 1), None, False),
        "lamb_global_norm": ("Lamb", with_clip("ClipGradByGlobalNorm", 1.0,
                                               learning_rate=0.01), None,
                             False),
    }


CASES = _cases()


def _init(seed=0):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 2).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _run_reference(case):
    name, kw, own_reg, master = CASES[case]
    p0, grads = _init()
    dt = jnp.bfloat16 if master else jnp.float32
    params = [Parameter(jnp.asarray(p).astype(dt), name=f"w{i}")
              for i, p in enumerate(p0)]
    if own_reg is not None:
        params[2].regularizer = jreg.L2Decay(own_reg)
    opt = getattr(paddle.optimizer, name)(parameters=params, **kw("ref"))
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = wrap_raw(jnp.asarray(g).astype(dt))
        opt.step()
    out = [np.asarray(p._value, np.float32) for p in params]
    masters = [np.asarray(opt._accumulators[id(p)]["master"])
               for p in params] if master else None
    return out, masters


def _run_port(case):
    name, kw, own_reg, master = CASES[case]
    p0, grads = _init()
    dt = torch.bfloat16 if master else torch.float32
    params = [torch.nn.Parameter(torch.from_numpy(p).to(dt)) for p in p0]
    if own_reg is not None:
        params[2].regularizer = treg.L2Decay(own_reg)
    opt = getattr(topt, name)(parameters=params, **kw("port"))
    opt.name_parameters((f"w{i}", p) for i, p in enumerate(params))
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(dt)
        opt.step()
    out = [p.detach().float().numpy() for p in params]
    masters = [opt.state_for(p)["master"].numpy()
               for p in params] if master else None
    return out, masters


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_the_reference(case):
    want, want_masters = _run_reference(case)
    got, got_masters = _run_port(case)
    p0 = _init()[0]
    for i, (g, w) in enumerate(zip(got, want)):
        assert not np.array_equal(w, p0[i].astype(np.float32))  # it moved
        if want_masters is None:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} param {i}")
        else:
            np.testing.assert_allclose(got_masters[i], want_masters[i],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} master {i}")
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=0,
                                       err_msg=f"{case} resident {i}")


def test_l1_decay_folds_as_l2_as_in_the_reference():
    """The reference's L1Decay adds coeff·p to the gradient, as L2Decay
    does (its `_l1` flag is read nowhere): the port computes the same."""
    outs = []
    for reg in (treg.L1Decay(0.05), treg.L2Decay(0.05)):
        p = torch.nn.Parameter(torch.linspace(-1, 1, 9))
        opt = topt.SGD(learning_rate=0.5, parameters=[p], weight_decay=reg)
        p.grad = torch.zeros(9)
        opt.step()
        outs.append(p.detach().clone())
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], torch.linspace(-1, 1, 9) * (
        1 - 0.5 * 0.05), rtol=0, atol=1e-7)


def test_a_parameters_own_regularizer_wins():
    p, q = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    q.regularizer = treg.L2Decay(1.0)
    opt = topt.SGD(learning_rate=0.1, parameters=[p, q], weight_decay=0.5)
    p.grad, q.grad = torch.zeros(3), torch.zeros(3)
    opt.step()
    torch.testing.assert_close(p.detach(), torch.full((3,), 0.95))
    torch.testing.assert_close(q.detach(), torch.full((3,), 0.9))


@pytest.mark.parametrize("kw", [dict(learning_rate=lambda: 0.1),
                                dict(learning_rate="0.1"),
                                dict(grad_clip=object()),
                                dict(grad_clip=1.0)])
def test_wrong_option_types_are_refused(kw):
    with pytest.raises(TypeError):
        topt.SGD(parameters=[torch.nn.Parameter(torch.zeros(2))], **kw)


def test_unported_per_parameter_options_raise():
    """Ported since: a per-parameter ``optimize_attr`` learning rate
    scales that parameter's step (Momentum), and a row-sparse gradient
    into an optimizer without a row path (Adagrad) is densified, as the
    reference's `_lr_for` and `_update_sparse` do: three steps each
    against the reference's."""
    from paddle_tpu.core.selected_rows import RowSparseGrad as JRows

    rng = np.random.RandomState(3)
    p0 = rng.randn(6, 4).astype(np.float32)
    grads = [rng.randn(6, 4).astype(np.float32) for _ in range(3)]
    rows = np.array([1, 4, 1], np.int64)
    vals = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    for name, kw in (("Momentum", dict(learning_rate=0.1, momentum=0.9)),
                     ("Adagrad", dict(learning_rate=0.1))):
        jp = Parameter(jnp.asarray(p0), name="w")
        jp.optimize_attr["learning_rate"] = 0.5
        jo = getattr(paddle.optimizer, name)(parameters=[jp], **kw)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        tp.optimize_attr = {"learning_rate": 0.5}
        to = getattr(topt, name)(parameters=[tp], **kw)
        for g, v in zip(grads, vals):
            if name == "Adagrad":  # row-sparse, densified
                jp.grad = JRows(jnp.asarray(rows, jnp.int32),
                                jnp.asarray(v), 6)
                tp.grad = torch.sparse_coo_tensor(
                    torch.from_numpy(rows)[None], torch.from_numpy(v),
                    (6, 4))
            else:
                jp.grad = wrap_raw(jnp.asarray(g))
                tp.grad = torch.from_numpy(g)
            jo.step()
            to.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._value),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
