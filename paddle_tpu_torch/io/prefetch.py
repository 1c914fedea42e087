"""The device prefetcher — counterpart of ``paddle_tpu.io.prefetch``:
``ShapeBuckets`` and ``DevicePrefetcher``.

``DevicePrefetcher(source, depth)`` runs the source iterator ``depth``
batches ahead on a background thread, pads each batch into shape buckets
when asked, and copies it to the card while the device runs the step
before it:

- every tensor leaf is copied with ``non_blocking=True`` on a side CUDA
  stream (from pinned memory: the port's ``DataLoader`` pins its batches
  for the card, and an unpinned leaf is pinned first), and the batch's
  copies end in an event;
- the consumer makes its current stream wait on that event and calls
  ``record_stream`` on every leaf, so the caching allocator does not hand
  a leaf's memory to the side stream again while the step still reads it;
- the thread sets its device before it stages anything.

Order, re-iteration, ``close()``, the context manager and the
re-raising of a source exception at the position it happened are the
reference's, as are the telemetry names: ``prefetch/batches``,
``prefetch/bucket_hits`` and ``prefetch/bucket_misses`` counters, the
``prefetch/queue_depth`` gauge, ``prefetch/h2d_bytes`` and
``prefetch/h2d_ms`` histograms (the host time to issue a batch's
copies). The consumer's wait is the goodput ledger's ``input_wait``. A
failed staging is retried through ``resilience.retry_call``.

The default device is ``"cuda"`` (it raises without a card);
``device="cpu"`` stages on the CPU (the tests), and ``to_device=False``
runs the pad stage only. ``sharding`` waits for the multi-GPU port and
raises.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.place import resolve_device
from ..profiler import goodput as _goodput
from ..profiler.telemetry import get_telemetry
from ..resilience.retry import retry_call

__all__ = ["DevicePrefetcher", "ShapeBuckets"]


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


class ShapeBuckets:
    """Pad one ragged axis of every array leaf into a fixed set of sizes.

    A leaf whose ``shape[axis]`` equals a bucket size, or pads up to the
    next one, is a *hit*; a dim larger than every bucket is a *miss*: the
    leaf is left unpadded, never truncated. Leaves with ``ndim <= axis``
    (``[batch]`` labels under the default ``axis=1``) pass through and are
    not counted. Tensors are padded with ``F.pad`` on their own device,
    numpy arrays with ``np.pad``."""

    def __init__(self, sizes: Sequence[int], axis: int = 1, pad_value=0):
        if not sizes:
            raise ValueError("ShapeBuckets needs at least one size")
        self.sizes = tuple(sorted(int(s) for s in sizes))
        if self.sizes[0] <= 0:
            raise ValueError(f"bucket sizes must be positive: {sizes}")
        self.axis = int(axis)
        self.pad_value = pad_value

    def target(self, dim: int) -> Optional[int]:
        """Smallest bucket >= dim, or None when dim exceeds them all."""
        for s in self.sizes:
            if s >= dim:
                return s
        return None

    def _pad_leaf(self, arr):
        """Returns (padded_array, hit_delta, miss_delta)."""
        if not hasattr(arr, "ndim") or arr.ndim <= self.axis:
            return arr, 0, 0
        dim = arr.shape[self.axis]
        t = self.target(dim)
        if t is None:
            return arr, 0, 1
        if t == dim:
            return arr, 1, 0
        if isinstance(arr, torch.Tensor):
            # F.pad's widths run from the last axis backwards
            widths = [0, 0] * (arr.ndim - 1 - self.axis) + [0, t - dim]
            return F.pad(arr, widths, value=self.pad_value), 1, 0
        widths = [(0, 0)] * arr.ndim
        widths[self.axis] = (0, t - dim)
        return np.pad(np.asarray(arr), widths,
                      constant_values=self.pad_value), 1, 0

    def pad_tree(self, tree):
        """Pad every array leaf; returns ``(tree, hits, misses)``."""
        hits = misses = 0

        def pad(leaf):
            nonlocal hits, misses
            out, h, m = self._pad_leaf(leaf)
            hits += h
            misses += m
            return out

        return _tree_map(pad, tree), hits, misses


# queue sentinel (identity-compared; never visible to consumers)
_STOP = object()


class _WorkerError:
    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb


def _host_leaf(leaf) -> torch.Tensor:
    """A leaf as a CPU or device tensor (numpy arrays and scalars become
    tensors)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.asarray(leaf))


class DevicePrefetcher:
    """Wrap a batch iterator with a bounded device-resident prefetch
    queue (see the module's docstring).

    One-shot, like a file handle: construct one per epoch and iterate;
    the worker ends when the source drains. ``close()`` (or the context
    manager) tears the pipeline down mid-epoch.

    Args:
        source: an iterator or iterable of batches (nested dicts, lists
            and tuples of tensors or numpy arrays).
        depth: how many staged batches may wait ahead of the consumer
            (>= 1).
        stage_retries: retries (deterministic backoff) of a staging that
            raised ``RuntimeError``; default ``PADDLE_TPU_H2D_RETRIES``
            (2). Errors of the source are not retried.
        buckets: ``ShapeBuckets``, or sizes for ``ShapeBuckets(sizes)``.
        sharding: not ported (the multi-GPU port); must be None.
        to_device: False runs the pad stage only (leaves as given).
        device: where the batches go (default ``"cuda"``).
    """

    def __init__(self, source: Iterable, depth: int = 2,
                 buckets: Union[ShapeBuckets, Sequence[int], None] = None,
                 sharding=None, to_device: bool = True,
                 stage_retries: Optional[int] = None, device=None):
        if sharding is not None:
            raise NotImplementedError(
                "DevicePrefetcher: sharding waits for the multi-GPU port")
        self.depth = max(1, int(depth))
        self._stage_retries = (int(os.environ.get("PADDLE_TPU_H2D_RETRIES",
                                                  2))
                               if stage_retries is None
                               else int(stage_retries))
        if buckets is not None and not isinstance(buckets, ShapeBuckets):
            buckets = ShapeBuckets(buckets)
        self._buckets = buckets
        self._to_device = to_device
        self._device = None
        if to_device:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._device = dev
        self._source = source
        self._src = iter(source)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._closed = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._worker, name="DevicePrefetcher", daemon=True)
        self._started = False

    # -- producer ----------------------------------------------------------
    def _copy(self, batch, stream):
        """Issue the batch's copies to the device; returns ``(batch,
        event)`` (the event None off the card)."""
        dev = self._device
        if stream is None:
            return _tree_map(lambda t: t.to(dev), batch), None
        with torch.cuda.stream(stream):
            out = _tree_map(lambda t: (t if t.is_pinned() or t.is_cuda
                                       else t.pin_memory()).to(
                dev, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _stage(self, batch, stream):
        """Bucket-pad, then issue the copies (only the copies are
        retried: retrying the pad would count its buckets twice)."""
        tel = get_telemetry()
        if self._buckets is not None:
            batch, hits, misses = self._buckets.pad_tree(batch)
            if hits:
                tel.counter("prefetch/bucket_hits", hits)
            if misses:
                tel.counter("prefetch/bucket_misses", misses)
        event = None
        if self._to_device:
            batch = _tree_map(_host_leaf, batch)
            t0 = time.perf_counter()
            batch, event = retry_call(self._copy, batch, stream,
                                      retries=self._stage_retries,
                                      base=0.05, retry_on=(RuntimeError,),
                                      counter="resilience/io_retries")
            tel.observe("prefetch/h2d_ms", (time.perf_counter() - t0) * 1e3)
        tel.counter("prefetch/batches")
        tel.observe("prefetch/h2d_bytes", sum(
            int(getattr(l, "nbytes", 0)) for l in _tree_leaves(batch)))
        return batch, event

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close(). False if closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        tel = get_telemetry()
        try:
            stream = None
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            for batch in self._src:
                if self._closed.is_set():
                    return
                if not self._put(self._stage(batch, stream)):
                    return
                tel.gauge("prefetch/queue_depth", self._q.qsize())
        except BaseException as e:  # propagate to the consumer, in order
            self._put(_WorkerError(e, traceback.format_exc()))
            return
        self._put(_STOP)

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if not self._started:
            self._started = True
            self._thread.start()
        # the consumer's block on the queue is the ledger's input_wait
        with _goodput.activity("input_wait"):
            while True:
                try:
                    item = self._q.get(timeout=0.2)
                    break
                except queue.Empty:
                    if self._closed.is_set():
                        raise StopIteration from None
                    if not self._thread.is_alive():
                        # the worker may have put its last items between
                        # the timed-out get and this check: one more
                        # non-blocking get decides
                        try:
                            item = self._q.get_nowait()
                            break
                        except queue.Empty:
                            self._exhausted = True
                            raise StopIteration from None
        get_telemetry().gauge("prefetch/queue_depth", self._q.qsize())
        if item is _STOP:
            self._exhausted = True
            self._thread.join(timeout=2.0)
            raise StopIteration
        if isinstance(item, _WorkerError):
            self._exhausted = True
            self._thread.join(timeout=2.0)
            raise item.exc from RuntimeError(
                f"DevicePrefetcher worker raised:\n{item.tb}")
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for leaf in _tree_leaves(batch):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(current)
        return batch

    def __len__(self):
        return len(self._source)

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Tear down mid-epoch: stop the worker, drop staged batches."""
        if self._exhausted and not self._started:
            return
        self._closed.set()
        self._exhausted = True
        # drain so a producer blocked on a full queue reaches the event
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
