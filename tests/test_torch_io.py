"""The port's data pipeline (paddle_tpu_torch.io, vision.datasets)
against the reference's: the synthetic MNIST / FashionMNIST / Cifar /
FakeData / Flowers arrays bit for bit, the samplers' orders after the same
numpy seed, and DataLoader batches (order and values) at num_workers 0
and 2 against the reference's single-process loader, with shuffle,
drop_last, batch samplers, iterable datasets and collation of nested
samples. Batches are CPU tensors, pinned only for the card."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu.vision import datasets as jds
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.vision import datasets as tds
import torch_threads  # noqa: F401  (one torch thread a worker)


def _np(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch.numpy() if hasattr(batch, "numpy") else batch)


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls,kw", [
    ("MNIST", {"mode": "train"}), ("MNIST", {"mode": "test"}),
    ("FashionMNIST", {"mode": "test"}), ("Cifar10", {"mode": "test"}),
    ("Cifar100", {"mode": "train"}), ("Flowers", {}),
    ("FakeData", {"num_samples": 64, "image_shape": (3, 8, 8), "seed": 5})])
def test_synthetic_datasets_are_the_references_bit_for_bit(cls, kw):
    ref, port = getattr(jds, cls)(**kw), getattr(tds, cls)(**kw)
    assert len(port) == len(ref)
    for i in (0, 1, len(ref) // 2, len(ref) - 1):
        _assert_same(list(port[i]), list(ref[i]))
    if cls in ("MNIST", "FashionMNIST"):
        np.testing.assert_array_equal(port.images, ref.images)
        np.testing.assert_array_equal(port.labels, ref.labels)


def test_mnist_reads_local_idx_files(tmp_path):
    imgs = np.arange(3 * 28 * 28, dtype=np.uint8).reshape(3, 28, 28)
    (tmp_path / "img").write_bytes(
        np.array([2051, 3, 28, 28], ">u4").tobytes() + imgs.tobytes())
    (tmp_path / "lbl").write_bytes(
        np.array([2049, 3], ">u4").tobytes() + bytes([7, 1, 4]))
    kw = dict(image_path=str(tmp_path / "img"),
              label_path=str(tmp_path / "lbl"))
    port, ref = tds.MNIST(**kw), jds.MNIST(**kw)
    _assert_same(list(port[2]), list(ref[2]))
    assert port[2][1].tolist() == [4] and port[2][0].shape == (1, 28, 28)


def test_samplers_follow_the_reference_order():
    ds = tds.FakeData(num_samples=37)
    for cls in ("SequenceSampler", "RandomSampler"):
        np.random.seed(3)
        ref = list(getattr(jio, cls)(ds))
        np.random.seed(3)
        assert list(getattr(tio, cls)(ds)) == ref
    np.random.seed(4)
    ref = list(jio.BatchSampler(ds, shuffle=True, batch_size=5,
                                drop_last=True))
    np.random.seed(4)
    port = tio.BatchSampler(ds, shuffle=True, batch_size=5, drop_last=True)
    assert list(port) == ref and len(port) == 7
    assert len(tio.BatchSampler(ds, batch_size=5)) == 8
    for rank in (0, 1):
        r = jio.DistributedBatchSampler(ds, 4, num_replicas=2, rank=rank,
                                        shuffle=True)
        p = tio.DistributedBatchSampler(ds, 4, num_replicas=2, rank=rank,
                                        shuffle=True)
        for _ in range(2):  # two epochs: RandomState(epoch)
            assert list(p) == list(r)
        assert len(p) == len(r)
    one = tio.DistributedBatchSampler(ds, 8)
    assert sum(len(b) for b in one) == 37


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_batches_follow_the_reference(num_workers, shuffle,
                                                 drop_last):
    """The same numpy seed, the same batches in the same order; workers
    change nothing."""
    ds_ref, ds_port = jds.MNIST(mode="test"), tds.MNIST(mode="test")
    np.random.seed(11)
    ref = [_np(b) for b in jio.DataLoader(ds_ref, batch_size=60,
                                          shuffle=shuffle,
                                          drop_last=drop_last)]
    np.random.seed(11)
    loader = tio.DataLoader(ds_port, batch_size=60, shuffle=shuffle,
                            drop_last=drop_last, num_workers=num_workers,
                            places="cpu")
    got = list(loader)
    assert len(got) == len(ref) == len(loader)
    for b in got:
        assert isinstance(b, list) and all(isinstance(t, torch.Tensor)
                                           for t in b)
        assert b[0].dtype == torch.float32 and b[1].dtype == torch.int64
        assert not b[0].is_pinned()
    _assert_same([_np(b) for b in got], ref)


def test_dataloader_with_a_batch_sampler_and_nested_samples():
    class Nested(tio.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32), "n": i,
                    "pair": (np.int64(i), np.float32(-i))}

    class RefNested(jio.Dataset):
        __len__ = Nested.__len__
        __getitem__ = Nested.__getitem__

    batches = [[3, 1], [0, 9, 4]]
    got = [_np(b) for b in tio.DataLoader(Nested(), batch_sampler=batches,
                                          places="cpu")]
    ref = [_np(b) for b in jio.DataLoader(RefNested(),
                                          batch_sampler=batches)]
    _assert_same(got, ref)
    assert got[1]["n"].tolist() == [0, 9, 4]


def test_dataloader_over_an_iterable_dataset():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            for i in range(7):
                yield np.array([i], np.int64)

    got = [b.numpy().ravel().tolist()
           for b in tio.DataLoader(Stream(), batch_size=3, places="cpu")]
    assert got == [[0, 1, 2], [3, 4, 5], [6]]
    got = list(tio.DataLoader(Stream(), batch_size=3, drop_last=True,
                              places="cpu"))
    assert len(got) == 2
    with pytest.raises(TypeError):
        len(tio.DataLoader(Stream(), batch_size=3, places="cpu"))


def test_dataloader_defaults_to_the_card():
    """Built for the card (the default), batches are pinned; without a
    card that default raises, as every entry point's does."""
    if torch.cuda.is_available():
        b = next(iter(tio.DataLoader(tds.FakeData(8), batch_size=4)))
        assert b[0].is_pinned()
    else:
        with pytest.raises(RuntimeError):
            tio.DataLoader(tds.FakeData(8), batch_size=4)


def test_datasets_compose_as_the_reference():
    a = tio.TensorDataset([np.arange(6).reshape(3, 2), np.arange(3)])
    assert len(a) == 3 and [x.tolist() for x in a[1]] == [[2, 3], 1]
    c = tio.ConcatDataset([a, a])
    assert len(c) == 6 and c[-1][1] == 2 and c[4][1] == 1
    s = tio.Subset(a, [2, 0])
    assert [s[i][1] for i in range(2)] == [2, 0]
    comp = tio.ComposeDataset([a, tio.Subset(a, [0, 1, 2])])
    assert len(comp[0]) == 4
    chain = tio.ChainDataset([[1, 2], [3]])
    assert list(chain) == [1, 2, 3]
    parts = tio.random_split(a, [2, 1],
                             generator=torch.Generator().manual_seed(0))
    assert sorted(parts[0].indices + parts[1].indices) == [0, 1, 2]
    with pytest.raises(ValueError):
        tio.random_split(a, [2, 2])
    assert tio.get_worker_info() is None


def test_collate_matches_the_reference():
    samples = [(np.ones((2, 2), np.float32) * i, i, "s",
                {"k": np.float64(i)}) for i in range(3)]
    _assert_same(_np(tio.default_collate_fn(samples)[:2]),
                 _np(jio.default_collate_fn(samples)[:2]))
    got = tio.default_collate_fn(samples)
    assert got[2] == ["s", "s", "s"] and got[3]["k"].tolist() == [0, 1, 2]
    t = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(t, torch.Tensor) and t.shape == (2, 2)
