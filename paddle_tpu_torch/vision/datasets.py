"""Vision datasets — counterpart of ``paddle_tpu.vision.datasets`` (MNIST,
FashionMNIST, Cifar10/100, Flowers, FakeData).

A dataset reads its local files when they exist (``image_path`` /
``label_path`` / ``data_file``); otherwise it gives the reference's
deterministic synthetic arrays, bit for bit, from the same numpy seeds,
so pipelines run without network access. Samples are numpy arrays
(images f32 in [0, 1], labels int64 of shape [1]); the DataLoader makes
the batches tensors.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData",
           "Flowers"]


class FakeData(Dataset):
    """Sample ``idx`` is ``rand(*image_shape)`` and a label in
    ``[0, num_classes)``, from ``np.random.RandomState(seed + idx)``."""

    def __init__(self, num_samples=1024, image_shape=(1, 28, 28),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = np.array([rng.randint(0, self.num_classes)], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """MNIST from its idx files, else 2048 (train) or 512 (test) synthetic
    digits whose bright bar's size follows the label."""

    NUM_CLASSES = 10
    _shape = (1, 28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        else:
            n = 2048 if mode == "train" else 512
            rng = np.random.RandomState(42 if mode == "train" else 7)
            self.labels = rng.randint(0, 10, size=(n, 1)).astype(np.int64)
            self.images = np.zeros((n, 28, 28), np.float32)
            for i, lab in enumerate(self.labels[:, 0]):
                img = rng.rand(28, 28).astype(np.float32) * 0.1
                img[2 + lab:26, 4:6 + lab] += 0.8  # label-correlated pattern
                self.images[i] = np.clip(img, 0, 1)

    @staticmethod
    def _read_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols).astype(np.float32) / 255.0

    @staticmethod
    def _read_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(-1, 1).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        elif img.ndim == 2:
            img = img[None].astype(np.float32)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """CIFAR from its python tarball, else 1024 (train) or 256 (test)
    synthetic 3x32x32 images."""

    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self.data = self._load_tar(data_file, mode)
        else:
            n = 1024 if mode == "train" else 256
            rng = np.random.RandomState(11 if mode == "train" else 13)
            self.data = [(rng.rand(3, 32, 32).astype(np.float32),
                          np.int64(rng.randint(self.NUM_CLASSES)))
                         for _ in range(n)]

    def _load_tar(self, path, mode):
        out = []
        names = ([f"data_batch_{i}" for i in range(1, 6)] if mode == "train"
                 else ["test_batch"])
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if any(m.name.endswith(n) for n in names):
                    d = pickle.load(tf.extractfile(m), encoding="bytes")
                    imgs = d[b"data"].reshape(-1, 3, 32, 32).astype(
                        np.float32) / 255.0
                    labels = d.get(b"labels", d.get(b"fine_labels"))
                    out.extend((img, np.int64(lab))
                               for img, lab in zip(imgs, labels))
        return out

    def __getitem__(self, idx):
        img, label = self.data[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label], np.int64)

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(FakeData):
    """512 synthetic 3x64x64 images of 102 classes (the files are not
    read)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        super().__init__(num_samples=512, image_shape=(3, 64, 64),
                         num_classes=102, transform=transform)
