"""Batch collation — counterpart of ``paddle_tpu.io.collate``: samples
are stacked into numpy arrays (torch tensors stack as tensors), recursing
through dicts, lists and tuples; the loader turns the arrays into
tensors."""
from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = ["default_collate_fn", "default_convert_fn"]


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch, dim=0)
    if isinstance(sample, numbers.Number):
        return np.array(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    raise TypeError("batch data must be numeric/ndarray/dict/list, got "
                    f"{type(sample)}")


def default_convert_fn(batch):
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch
    if isinstance(batch, dict):
        return {k: default_convert_fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [default_convert_fn(b) for b in batch]
    return batch
