"""The port's cross entropy (paddle_tpu_torch.nn.functional.cross_entropy
and nn.CrossEntropyLoss) against the reference's in every mode — hard and
soft labels, label smoothing, class weights, the three reductions,
`ignore_index`, another `axis`, labels with a size-1 class axis and
`use_softmax=False` — values and gradients (autograd against the
reference's `jax.vjp`, with the same cotangent), in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import wrap_raw
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn.functional import cross_entropy
import torch_threads  # noqa: F401  (one torch thread a worker)

N, C, L = 12, 9, 5
# f32 on both sides: log-softmax and the sums are taken in other orders
TOL = dict(rtol=1e-5, atol=1e-6)


def _cases():
    """id -> (kwargs, label kind, axis, 3-D input)."""
    cases = {}
    for red in ("mean", "sum", "none"):
        cases[f"hard_{red}"] = (dict(reduction=red), "hard", -1, False)
        cases[f"hard_ignore_{red}"] = (dict(reduction=red, ignore_index=3),
                                       "hard_ignored", -1, False)
        cases[f"hard_weight_{red}"] = (dict(reduction=red), "hard_weighted",
                                       -1, False)
        cases[f"soft_{red}"] = (dict(reduction=red, soft_label=True),
                                "soft", -1, False)
    cases.update({
        "hard_smoothing": (dict(label_smoothing=0.1), "hard_ignored", -1,
                           False),
        "hard_smoothing_weight_sum": (dict(label_smoothing=0.2,
                                           reduction="sum"),
                                      "hard_weighted", -1, False),
        "soft_smoothing": (dict(soft_label=True, label_smoothing=0.1),
                           "soft", -1, False),
        "soft_weight": (dict(soft_label=True), "soft_weighted", -1, False),
        "hard_axis1": (dict(), "hard_ignored", 1, True),
        "hard_axis1_none": (dict(reduction="none"), "hard", 1, True),
        "soft_axis1": (dict(soft_label=True, reduction="sum"), "soft", 1,
                       True),
        "hard_column_labels": (dict(), "hard_column", -1, False),
        "probabilities": (dict(use_softmax=False), "hard_ignored", -1,
                          False),
    })
    return cases


CASES = _cases()


def _inputs(kind, axis, three_d, seed=0, ignore_index=-100):
    rng = np.random.RandomState(seed)
    shape = (N, C, L) if three_d else (N, C)
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    weight = None
    lbl_shape = (N, L) if three_d else (N,)
    if kind.startswith("soft"):
        soft = rng.rand(*shape).astype(np.float32)
        label = soft / soft.sum(axis=axis, keepdims=True)
    else:
        label = rng.randint(0, C, lbl_shape)
        if kind == "hard_ignored":
            label.flat[::4] = ignore_index
        if kind == "hard_column":
            label = label[:, None]
    if kind.endswith("weighted"):
        weight = (rng.rand(C) + 0.5).astype(np.float32)
    return logits, label, weight


def _reference(logits, label, weight, kw, axis, ct):
    F = paddle.nn.functional
    lbl = wrap_raw(jnp.asarray(label))
    w = None if weight is None else wrap_raw(jnp.asarray(weight))

    def f(x):
        return F.cross_entropy(wrap_raw(x), lbl, weight=w, axis=axis,
                               **kw)._value

    out, vjp = jax.vjp(f, jnp.asarray(logits))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct(out.shape)))[0])


def _port(logits, label, weight, kw, axis, ct, layer=False):
    x = torch.from_numpy(logits).requires_grad_(True)
    lbl = torch.from_numpy(label)
    w = None if weight is None else torch.from_numpy(weight)
    if layer:
        out = CrossEntropyLoss(weight=w, axis=axis, **kw)(x, lbl)
    else:
        out = cross_entropy(x, lbl, weight=w, axis=axis, **kw)
    out.backward(torch.from_numpy(ct(tuple(out.shape))))
    return out.detach().numpy(), x.grad.numpy()


def _cotangent(shape):
    rng = np.random.RandomState(1)
    return np.asarray(rng.rand(*shape) + 0.5, dtype=np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_values_and_gradients_match_the_reference(case):
    kw, kind, axis, three_d = CASES[case]
    logits, label, weight = _inputs(kind, axis, three_d,
                                    ignore_index=kw.get("ignore_index", -100))
    if kw.get("use_softmax") is False:
        logits = np.abs(logits) / np.abs(logits).sum(axis, keepdims=True)
    want, want_grad = _reference(logits, label, weight, kw, axis,
                                 _cotangent)
    got, got_grad = _port(logits, label, weight, kw, axis, _cotangent)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)
    assert np.abs(got_grad).max() > 0


@pytest.mark.parametrize("case", ["hard_weight_mean", "soft_weight",
                                  "hard_axis1"])
def test_the_layer_is_the_functional(case):
    kw, kind, axis, three_d = CASES[case]
    logits, label, weight = _inputs(kind, axis, three_d, seed=2)
    got = _port(logits, label, weight, kw, axis, _cotangent, layer=True)
    want = _port(logits, label, weight, kw, axis, _cotangent)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bf16_logits_give_an_f32_loss():
    logits, label, _ = _inputs("hard", -1, False)
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    loss = cross_entropy(x, torch.from_numpy(label), label_smoothing=0.1)
    loss.backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == torch.bfloat16


def test_an_unknown_reduction_is_refused():
    with pytest.raises(ValueError, match="reduction"):
        cross_entropy(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                      reduction="avg")
