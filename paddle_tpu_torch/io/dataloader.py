"""DataLoader — counterpart of ``paddle_tpu.io.dataloader``.

``DataLoader(dataset, batch_size, shuffle, drop_last, collate_fn,
num_workers, batch_sampler, ...)`` gives batches as CPU tensors: the
collated numpy arrays become tensors, pinned when the loader is built for
the card (``places``, default ``"cuda"``; pass ``places="cpu"`` on a
machine without one), so that the step's ``.to(device,
non_blocking=True)`` overlaps the copy.

The batch order is the reference's for the same seed: the batch sampler
(``io.sampler``, numpy's global generator) runs in this process, once per
epoch, at the start of iteration. With ``num_workers > 0`` the batches
are collated in ``torch.utils.data``'s worker processes (started with
``spawn``, as the reference's are: a dataset must be importable), which
give the same batches in the same order as ``num_workers=0``;
``get_worker_info()`` inside a worker describes it.

Not ported yet: the reference's shared-memory ring transport
(``_shm_transport.py``; ``use_shared_memory`` and ``shm_capacity`` are
taken and not used) and its respawn of a dead worker
(``_MultiProcessIter._respawn``): a worker that dies ends the epoch with
torch's error. Both wait for the resilience port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.data as tud

from ..core.place import resolve_device
from ..profiler.telemetry import get_telemetry
from .collate import default_collate_fn
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "get_worker_info", "WorkerInfo"]


class WorkerInfo:
    """The worker a dataset's code runs in: ``id`` of ``num_workers``,
    its copy of ``dataset`` and its ``seed``."""

    def __init__(self, id, num_workers, dataset, seed=0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def get_worker_info() -> Optional[WorkerInfo]:
    """This worker's ``WorkerInfo``; None in the loading process."""
    info = tud.get_worker_info()
    if info is None:
        return None
    return WorkerInfo(info.id, info.num_workers, info.dataset, info.seed)


def _to_tensors(batch):
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_tensors(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_tensors(v) for k, v in batch.items()}
    return batch


def _pin(batch):
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch


def _nbytes(batch) -> int:
    if isinstance(batch, (list, tuple)):
        return sum(_nbytes(b) for b in batch)
    if isinstance(batch, dict):
        return sum(_nbytes(b) for b in batch.values())
    if isinstance(batch, torch.Tensor):
        return batch.numel() * batch.element_size()
    return 0


class _TensorCollate:
    """``collate_fn`` then numpy arrays to tensors (picklable, for the
    workers)."""

    def __init__(self, collate_fn):
        self.collate_fn = collate_fn

    def __call__(self, samples):
        return _to_tensors(self.collate_fn(samples))


class _IterableBatchCfg:
    def __init__(self, batch_size, drop_last):
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self):
        # TypeError, not the reference's RuntimeError: list(loader) asks
        # for a length hint and takes only a TypeError as "none"
        raise TypeError("IterableDataset loader has no length")


class DataLoader:
    """Batches of ``dataset``; see the module's docstring."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, shm_capacity=64 << 20):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.persistent_workers = bool(persistent_workers)
        self.pin_memory = resolve_device(places).type == "cuda"
        self._is_iterable_ds = isinstance(dataset, tud.IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        else:
            self.batch_size = batch_size
            if self._is_iterable_ds:
                self.batch_sampler = _IterableBatchCfg(batch_size, drop_last)
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)
        self._workers: Optional[tud.DataLoader] = None

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        it = (self._worker_iter() if self.num_workers > 0
              else self._single_process_iter())
        tel = get_telemetry()
        for batch in it:
            tel.counter("reader/batches")
            tel.counter("reader/bytes", _nbytes(batch))
            yield batch

    def _worker_iter(self):
        if self._workers is None:
            if self._is_iterable_ds:
                kw = dict(batch_size=self.batch_sampler.batch_size,
                          drop_last=self.batch_sampler.drop_last)
            else:
                kw = dict(batch_sampler=self.batch_sampler)
            self._workers = tud.DataLoader(
                self.dataset, collate_fn=_TensorCollate(self.collate_fn),
                num_workers=self.num_workers, pin_memory=self.pin_memory,
                timeout=self.timeout, worker_init_fn=self.worker_init_fn,
                prefetch_factor=self.prefetch_factor,
                persistent_workers=self.persistent_workers,
                multiprocessing_context="spawn", **kw)
        return iter(self._workers)

    def _single_process_iter(self):
        collate = _TensorCollate(self.collate_fn)
        finish = _pin if self.pin_memory else (lambda b: b)
        if self._is_iterable_ds:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield finish(collate(batch))
                    batch = []
            if batch and not self.batch_sampler.drop_last:
                yield finish(collate(batch))
            return
        for indices in self.batch_sampler:
            yield finish(collate([self.dataset[i] for i in indices]))
