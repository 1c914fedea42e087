"""The port's losses (`nn.functional.loss` beyond cross_entropy, and the
loss layers of `nn.layer.loss`) against the reference's on the same seeded
numpy inputs: values and the gradients of the float inputs for one
cotangent, f32. `ctc_loss` is held to optax's through the reference, an
infeasible alignment included; the card tests hold the CUDA result to
the CPU's."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import functional as TF
from torch_parity import assert_close, port_call, ref_call
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32 on both sides; reductions and log-sum-exps are taken in other orders
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _probs(r, *shape):
    return (r.rand(*shape) * 0.9 + 0.05).astype(np.float32)


def _signs(r, *shape):
    return np.where(r.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _logp(r, n, c):
    x = _f32(r, n, c)
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def _ctc(r, label_lengths=(4, 3, 2), input_lengths=(12, 10, 8)):
    return (_f32(r, 12, 3, 6), r.randint(1, 6, (3, 5)).astype(np.int64),
            np.array(input_lengths, np.int64),
            np.array(label_lengths, np.int64))


def _ctc_repeats(r):
    logits, labels, il, ll = _ctc(r)
    labels[0, :4] = [2, 2, 3, 3]
    return logits, labels, il, ll


def _hsig(r, custom=False):
    x, lbl = _f32(r, 5, 4), r.randint(0, 6, (5, 1)).astype(np.int64)
    if not custom:
        return x, lbl, 6, _f32(r, 5, 4), _f32(r, 5, 1)
    table = np.array([[0, 2, -1], [1, 3, 4], [0, -1, -1], [4, 2, 1],
                      [3, 0, -1]], np.int64)
    code = r.randint(0, 2, (5, 3)).astype(np.int64)
    return x, lbl, 6, _f32(r, 6, 4), _f32(r, 6, 1), table, code


def _edit(r):
    return (r.randint(0, 5, (4, 7)).astype(np.int64),
            r.randint(0, 5, (4, 6)).astype(np.int64))


def _cases():
    """id -> (function, args maker(rng), kwargs, differentiable
    positions)."""
    cases = {
        "softmax_with_cross_entropy": ("softmax_with_cross_entropy",
                                       lambda r: (_f32(r, 6, 5), r.randint(
                                           0, 5, (6, 1)).astype(np.int64)),
                                       {}, (0,)),
        "softmax_with_cross_entropy_soft": (
            "softmax_with_cross_entropy",
            lambda r: (_f32(r, 6, 5), _probs(r, 6, 5)),
            dict(soft_label=True), (0,)),
        "softmax_with_cross_entropy_softmax": (
            "softmax_with_cross_entropy",
            lambda r: (_f32(r, 6, 5), r.randint(0, 5, (6, 1)).astype(
                np.int64)), dict(return_softmax=True), (0,)),
        "square_error_cost": ("square_error_cost",
                              lambda r: (_f32(r, 4, 3), _f32(r, 4, 3)), {},
                              (0, 1)),
        "nll_loss_weight_ignore": (
            "nll_loss", lambda r: (_logp(r, 8, 5), np.array(
                [0, 3, -100, 4, 1, 1, 2, -100], np.int64),
                _probs(r, 5) + 0.5), {}, (0,)),
        "nll_loss_3d": ("nll_loss", lambda r: (
            np.log(_probs(r, 3, 4, 5)), r.randint(0, 4, (3, 5)).astype(
                np.int64)), dict(reduction="none"), (0,)),
        "binary_cross_entropy_weight": (
            "binary_cross_entropy",
            lambda r: (_probs(r, 4, 3), (r.rand(4, 3) > 0.5).astype(
                np.float32), _probs(r, 4, 3)), {}, (0,)),
        "bce_with_logits_pos_weight": (
            "binary_cross_entropy_with_logits",
            lambda r: (_f32(r, 4, 3), _probs(r, 4, 3)),
            dict(reduction="sum"), (0, 1)),
        "kl_div_batchmean": ("kl_div", lambda r: (np.log(_probs(r, 4, 5)),
                                                  _probs(r, 4, 5)),
                             dict(reduction="batchmean"), (0, 1)),
        "smooth_l1_loss": ("smooth_l1_loss", lambda r: (
            _f32(r, 5, 4), _f32(r, 5, 4)), dict(delta=0.5), (0, 1)),
        "margin_ranking_loss": ("margin_ranking_loss", lambda r: (
            _f32(r, 8), _f32(r, 8), _signs(r, 8)), dict(margin=0.3),
            (0, 1)),
        "hinge_embedding_loss": ("hinge_embedding_loss", lambda r: (
            _f32(r, 4, 5), _signs(r, 4, 5)), dict(margin=0.7), (0,)),
        "cosine_embedding_loss": ("cosine_embedding_loss", lambda r: (
            _f32(r, 6, 4), _f32(r, 6, 4), _signs(r, 6)),
            dict(margin=0.1, reduction="sum"), (0, 1)),
        "log_loss": ("log_loss", lambda r: (_probs(r, 5, 1),
                                            (r.rand(5, 1) > 0.5).astype(
                                                np.float32)), {}, (0,)),
        "sigmoid_focal_loss": ("sigmoid_focal_loss", lambda r: (
            _f32(r, 6, 3), (r.rand(6, 3) > 0.6).astype(np.float32),
            np.array([3.0], np.float32)), {}, (0,)),
        "sigmoid_focal_loss_mean": ("sigmoid_focal_loss", lambda r: (
            _f32(r, 6, 3), (r.rand(6, 3) > 0.6).astype(np.float32)),
            dict(reduction="mean", alpha=0.4, gamma=1.5), (0,)),
        "triplet_margin_loss": ("triplet_margin_loss", lambda r: (
            _f32(r, 5, 4), _f32(r, 5, 4), _f32(r, 5, 4)), {}, (0, 1, 2)),
        "triplet_margin_loss_swap_p1": ("triplet_margin_loss", lambda r: (
            _f32(r, 5, 4), _f32(r, 5, 4), _f32(r, 5, 4)),
            dict(swap=True, p=1.0, margin=2.0, reduction="none"), (0, 1, 2)),
        "ctc_loss_mean": ("ctc_loss", _ctc, {}, (0,)),
        "ctc_loss_sum_repeats": ("ctc_loss", _ctc_repeats,
                                 dict(reduction="sum", blank=0), (0,)),
        "ctc_loss_none_blank5": ("ctc_loss", _ctc,
                                 dict(reduction="none", blank=5), (0,)),
        # label 0 (length 5) cannot fit in 3 frames: optax's large finite
        # loss (log 0 taken as -1e5), not torch's inf
        "ctc_loss_infeasible": ("ctc_loss", lambda r: _ctc(
            r, (5, 3, 2), (3, 10, 8)), dict(reduction="none"), (0,)),
        "edit_distance": ("edit_distance", _edit, {}, ()),
        "edit_distance_raw_lengths_ignored": (
            "edit_distance", lambda r: (*_edit(r), False, [0, 3],
                                        np.array([7, 5, 0, 3], np.int64),
                                        np.array([6, 2, 4, 0], np.int64)),
            {}, ()),
        "hsigmoid_loss_default_tree": ("hsigmoid_loss", _hsig, {},
                                       (0, 3, 4)),
        "hsigmoid_loss_custom_tree": (
            "hsigmoid_loss", lambda r: _hsig(r, custom=True)[:5],
            "custom", (0, 3, 4)),
        "dice_loss": ("dice_loss", lambda r: (_probs(r, 4, 3, 5), r.randint(
            0, 5, (4, 3, 1)).astype(np.int64)), {}, (0,)),
        "npair_loss": ("npair_loss", lambda r: (
            _f32(r, 6, 4), _f32(r, 6, 4),
            np.array([0, 1, 0, 2, 1, 3], np.int64)), {}, (0, 1)),
    }
    for red in ("mean", "sum", "none"):
        cases[f"mse_loss_{red}"] = ("mse_loss", lambda r: (
            _f32(r, 4, 3), _f32(r, 4, 3)), dict(reduction=red), (0, 1))
        cases[f"l1_loss_{red}"] = ("l1_loss", lambda r: (
            _f32(r, 4, 3), _f32(r, 4, 3)), dict(reduction=red), (0, 1))
        cases[f"kl_div_{red}"] = ("kl_div", lambda r: (
            np.log(_probs(r, 4, 5)), _probs(r, 4, 5)), dict(reduction=red),
            (0,))
        cases[f"nll_loss_{red}"] = ("nll_loss", lambda r: (
            _logp(r, 8, 5), r.randint(0, 5, (8,)).astype(np.int64)),
            dict(reduction=red), (0,))
    return cases


CASES = _cases()


def _args_kwargs(name, r):
    fn, build, kw, grad = CASES[name]
    args = list(build(r))
    if kw == "custom":  # the tree's table and code are keyword arguments
        x, lbl, n, w, b, table, code = _hsig(np.random.RandomState(0),
                                             custom=True)
        return fn, [x, lbl, n, w, b], dict(path_table=table,
                                            path_code=code), grad
    if name == "bce_with_logits_pos_weight":
        kw = dict(kw, weight=_probs(r, 3), pos_weight=_probs(r, 3) + 1)
    return fn, args, kw, grad


def _kw_to(kw, conv):
    return {k: conv(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _run_both(name, device="cpu"):
    fn, args, kw, grad = _args_kwargs(name, np.random.RandomState(0))
    want = ref_call(getattr(JF, fn), args, _kw_to(kw, paddle.to_tensor),
                    grad)
    got = port_call(getattr(TF, fn), args, _kw_to(
        kw, lambda a: torch.from_numpy(a).to(device)), grad, device)
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_the_reference(name):
    (got, got_g), (want, want_g) = _run_both(name)
    assert_close([got], [want], what=name, **VALUE_TOL)
    if name == "ctc_loss_infeasible":
        assert np.isfinite(got).all() and got[0] > 1e4
        # the infeasible sequence's paths all sit near -1e5, where an f32
        # ulp is 0.0078: its gradient (|g| <= 0.55) holds to 2e-3; the
        # feasible sequences' to GRAD_TOL
        assert_close([got_g[0][:, 0]], [want_g[0][:, 0]], what=name,
                     rtol=0, atol=2e-3)
        got_g, want_g = [got_g[0][:, 1:]], [want_g[0][:, 1:]]
    assert_close(got_g, want_g, what=name, **GRAD_TOL)


def test_edit_distance_returns_the_sequence_count():
    a, b = _edit(np.random.RandomState(0))
    dist, num = TF.edit_distance(torch.from_numpy(a), torch.from_numpy(b))
    jd, jn = JF.edit_distance(paddle.to_tensor(a), paddle.to_tensor(b))
    assert dist.dtype == num.dtype == torch.float32
    np.testing.assert_array_equal(num.numpy(), jn.numpy())
    np.testing.assert_allclose(dist.numpy(), jd.numpy(), **VALUE_TOL)


def _layer_cases():
    """id -> (build(nn, side) -> layer, inputs maker(rng), positions
    of the inputs to differentiate)."""
    def kw(s):
        return {} if s == "ref" else {"device": "cpu"}

    two = lambda r: (_f32(r, 4, 3), _f32(r, 4, 3))  # noqa: E731
    return {
        "MSELoss": (lambda nn, s: nn.MSELoss("sum"), two, (0,)),
        "L1Loss": (lambda nn, s: nn.L1Loss(), two, (0, 1)),
        "NLLLoss": (lambda nn, s: nn.NLLLoss(ignore_index=2), lambda r: (
            _logp(r, 6, 4), r.randint(0, 4, (6,)).astype(np.int64)), (0,)),
        "BCELoss": (lambda nn, s: nn.BCELoss(reduction="none"), lambda r: (
            _probs(r, 4, 3), _probs(r, 4, 3)), (0,)),
        "BCEWithLogitsLoss": (lambda nn, s: nn.BCEWithLogitsLoss(),
                              lambda r: (_f32(r, 4, 3), _probs(r, 4, 3)),
                              (0,)),
        "KLDivLoss": (lambda nn, s: nn.KLDivLoss("batchmean"), lambda r: (
            np.log(_probs(r, 4, 5)), _probs(r, 4, 5)), (0,)),
        "SmoothL1Loss": (lambda nn, s: nn.SmoothL1Loss(delta=0.3), two,
                         (0,)),
        "MarginRankingLoss": (lambda nn, s: nn.MarginRankingLoss(0.2),
                              lambda r: (_f32(r, 6), _f32(r, 6),
                                         _signs(r, 6)), (0, 1)),
        "HingeEmbeddingLoss": (lambda nn, s: nn.HingeEmbeddingLoss(0.5),
                               lambda r: (_f32(r, 4, 3), _signs(r, 4, 3)),
                               (0,)),
        "CosineEmbeddingLoss": (lambda nn, s: nn.CosineEmbeddingLoss(0.2),
                                lambda r: (_f32(r, 5, 3), _f32(r, 5, 3),
                                           _signs(r, 5)), (0, 1)),
        "CTCLoss": (lambda nn, s: nn.CTCLoss(blank=0), _ctc, (0,)),
        "TripletMarginLoss": (lambda nn, s: nn.TripletMarginLoss(
            swap=True), lambda r: (_f32(r, 5, 3), _f32(r, 5, 3),
                                   _f32(r, 5, 3)), (0, 1, 2)),
        "HSigmoidLoss": (lambda nn, s: nn.HSigmoidLoss(4, 6, **kw(s)),
                         lambda r: _hsig(r)[:2], (0,)),
        "HSigmoidLoss_custom": (
            lambda nn, s: nn.HSigmoidLoss(4, 6, is_custom=True, **kw(s)),
            lambda r: _hsig(r, custom=True)[:2] + _hsig(
                r, custom=True)[5:], (0,)),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_loss_layer_matches_the_reference(name):
    """The layer built in both packages (the reference's node weights
    carried over), the same loss and input gradients."""
    build, inputs, grad = _layer_cases()[name]
    ref, port = build(paddle.nn, "ref"), build(tnn, "port")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in jfunc.get_params(ref).items()})
    args = list(inputs(np.random.RandomState(3)))
    got = port_call(port, args, grad=grad)
    want = ref_call(ref, args, grad=grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)


def test_hsigmoid_layer_refuses_a_one_class_default_tree():
    with pytest.raises(ValueError, match="num_classes"):
        tnn.HSigmoidLoss(4, 1, device="cpu")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_on_the_card_matches_the_cpu(name):
    fn, args, kw, grad = _args_kwargs(name, np.random.RandomState(0))
    cpu = port_call(getattr(TF, fn), args, _kw_to(kw, torch.from_numpy),
                    grad)
    card = port_call(getattr(TF, fn), args, _kw_to(
        kw, lambda a: torch.from_numpy(a).cuda()), grad, "cuda")
    assert_close([card[0]], [cpu[0]], what=name, **VALUE_TOL)
    assert_close(card[1], cpu[1], what=name, **GRAD_TOL)
