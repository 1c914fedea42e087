"""Datasets — counterpart of ``paddle_tpu.io.dataset``.

The classes subclass torch's ``Dataset`` / ``IterableDataset``, so
``torch.utils.data`` takes them as it takes its own. ``random_split``
draws its permutation from an explicit ``torch.Generator`` (the
reference draws from its global JAX key, which the port does not have:
the same seed gives another split)."""
from __future__ import annotations

import bisect
from typing import Optional, Sequence

import numpy as np
import torch
import torch.utils.data as tud

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset(tud.Dataset):
    """A map-style dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset, tud.IterableDataset):
    """A stream of samples: ``__iter__`` only."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        # TypeError (the reference raises RuntimeError): list() asks for
        # a length hint and takes only a TypeError as "none"
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of tensors (or arrays) that share their first dimension."""

    def __init__(self, tensors):
        if not all(tensors[0].shape[0] == t.shape[0] for t in tensors):
            raise ValueError("all tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Datasets of one length side by side: a sample is the fields of
    each dataset's sample in turn."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("ComposeDataset: lengths differ")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    """Iterable datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Map-style datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    """The samples of ``dataset`` at ``indices``."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths: Sequence[int],
                 generator: Optional[torch.Generator] = None):
    """Disjoint ``Subset``s of the given lengths, from one permutation
    drawn with ``generator`` (a generator seeded with 0 when None)."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError("sum of lengths must equal dataset size")
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    perm = torch.randperm(total, generator=gen).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
