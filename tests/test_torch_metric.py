"""The port's metrics (paddle_tpu_torch.metric) against the reference's on
the same seeded scores and labels: the functional top-k accuracy, and
Accuracy (top-k, labels [N] and [N, 1] and one-hot), Precision, Recall and
Auc accumulated over several batches. Accumulated values are exact counts
on both sides, compared with equality (the functional accuracy as an f32
mean, to 1e-7)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as tm
import torch_threads  # noqa: F401  (one torch thread a worker)


def _scores(n, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c).astype(np.float32),
            rng.randint(0, c, (n,)).astype(np.int64))


@pytest.mark.parametrize("k", [1, 3, 20])
@pytest.mark.parametrize("label_shape", ["n", "n1"])
def test_functional_accuracy_matches_reference(k, label_shape):
    pred, lbl = _scores(50, 10, 0)
    if label_shape == "n1":
        lbl = lbl[:, None]
    ref = float(jm.accuracy(paddle.to_tensor(pred), paddle.to_tensor(lbl),
                            k=k).numpy())
    got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(lbl), k=k)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - ref) <= 1e-7


@pytest.mark.parametrize("topk", [(1,), (1, 5), 2])
@pytest.mark.parametrize("label_kind", ["n", "n1", "onehot"])
def test_accuracy_metric_matches_reference(topk, label_kind):
    ref, port = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert port.name() == ref.name()
    for seed in range(3):
        pred, lbl = _scores(32, 10, seed)
        if label_kind == "n1":
            lbl = lbl[:, None]
        elif label_kind == "onehot":
            lbl = np.eye(10, dtype=np.float32)[lbl]
        rc = ref.compute(paddle.to_tensor(pred), paddle.to_tensor(lbl))
        pc = port.compute(torch.from_numpy(pred), torch.from_numpy(lbl))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc.numpy()))
        assert port.update(pc) == ref.update(rc)
    assert port.accumulate() == ref.accumulate()
    port.reset()
    assert port.accumulate() == (0.0 if len(port.topk) == 1
                                 else [0.0] * len(port.topk))


def _top1_hits(pred, label):
    m = tm.Accuracy()
    return m.update(m.compute(pred, torch.tensor([label])))


def test_accuracy_ties_go_to_the_lower_class():
    pred = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert _top1_hits(pred, 1) == 1.0 and _top1_hits(pred, 2) == 0.0


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_reference(cls):
    ref, port = getattr(jm, cls)(), getattr(tm, cls)()
    for seed in range(3):
        rng = np.random.RandomState(seed)
        p = rng.rand(40).astype(np.float32)
        lab = (rng.rand(40) < 0.4).astype(np.int64)
        if cls == "Auc" and seed == 2:
            p = np.stack([1 - p, p], axis=1)  # [N, 2]: column 1
        ref.update(paddle.to_tensor(p), paddle.to_tensor(lab))
        port.update(torch.from_numpy(p), torch.from_numpy(lab))
    assert port.accumulate() == ref.accumulate()
    assert 0.0 < port.accumulate() < 1.0
    assert port.name() == ref.name()
    port.reset()
    assert port.accumulate() == 0.0
