"""Train-state checkpoints and the auto-checkpoint epoch loop —
counterpart of ``paddle_tpu.incubate.checkpoint``.

- ``save_train_state(state, path)`` / ``restore_train_state(path)``: a
  tree of tensors and numpy arrays saved atomically as a directory (the
  reference's layout): written to ``path + ".tmp-save"``, fsynced, then
  swapped in by renames, so a crash mid-save leaves the previous state at
  ``path`` or at ``path + ".tmp-old"`` (which ``restore_train_state``
  reads when ``path`` is missing).
- ``CheckpointSaver``: numbered checkpoints ``<root>/ckpt-<n>/`` with a
  ``LATEST`` pointer and retention (``keep_max``).
- ``train_epoch_range``: the epoch loop that restores the last completed
  epoch's state for a job and saves at each epoch's end.

The payload inside a directory is one ``framework.io.save`` file in place
of the reference's orbax tree: tensors come back as CPU tensors (a bf16
tensor widened to f32, which ``copy_`` into a bf16 tensor restores to the
same bits), numpy arrays and Python values as they were. The files cross
one way only: neither package reads the other's train-state directories.
I/O goes through ``resilience.retry_call`` (``PADDLE_TPU_CKPT_RETRIES``,
default 3, and ``PADDLE_TPU_CKPT_RETRY_BASE``, default 0.2 s).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

from ...framework import io as _io

__all__ = ["CheckpointSaver", "train_epoch_range", "save_train_state",
           "restore_train_state"]

_PAYLOAD = "state.pdstate"  # the one file of a saved state directory


def _io_retry(fn, *args, **kwargs):
    """Checkpoint reads and writes behind deterministic exponential
    backoff, counted in ``resilience/io_retries``."""
    from ...resilience.retry import retry_call

    return retry_call(
        fn, *args,
        retries=int(os.environ.get("PADDLE_TPU_CKPT_RETRIES", 3)),
        base=float(os.environ.get("PADDLE_TPU_CKPT_RETRY_BASE", 0.2)),
        retry_on=(OSError,), **kwargs)


def _write_dir(directory: str, state) -> None:
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.makedirs(directory)
    _io.save(state, os.path.join(directory, _PAYLOAD))


def _read_dir(directory: str):
    return _io.load(os.path.join(directory, _PAYLOAD))


def save_train_state(state: Dict[str, Any], path: str) -> None:
    """Save ``state`` atomically as the directory ``path``: write a temp
    sibling, fsync it, then swap — a crash mid-save never loses the
    previous checkpoint (it survives at ``path`` or ``path + '.tmp-old'``,
    and ``restore_train_state`` checks both)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp-save"
    old = path + ".tmp-old"
    # a stale tmp is always garbage; old may only go while the committed
    # path exists — otherwise it is the sole survivor of a crashed swap
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    if os.path.exists(old) and os.path.exists(path):
        shutil.rmtree(old)
    _io_retry(_write_dir, tmp, state)
    # flush the tree before the commit rename: the rename must never
    # point at data still in the page cache when a preemption lands
    _io.fsync_tree(tmp)
    if os.path.exists(path):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(tmp, path)
    _io.fsync_dir(os.path.dirname(path))
    if os.path.exists(old):
        shutil.rmtree(old)


def _resolve_ckpt_path(path: str) -> str:
    """The committed checkpoint, or the .tmp-old survivor of a crashed
    swap."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        return path
    old = path + ".tmp-old"
    if os.path.exists(old):
        return old
    return path


def restore_train_state(path: str):
    """What ``save_train_state`` saved at ``path`` (tensors on the CPU)."""
    return _io_retry(_read_dir, _resolve_ckpt_path(path))


class CheckpointSaver:
    """Numbered checkpoints under a root directory, with retention.

    Layout: ``<root>/ckpt-<n>/`` (a saved state) and ``<root>/LATEST``
    (JSON: the number and the caller's meta). A save writes
    ``ckpt-<n>.tmp``, fsyncs and renames it, and updates ``LATEST``
    last."""

    def __init__(self, root: str, keep_max: int = 3):
        self.root = os.path.abspath(root)
        self.keep_max = keep_max
        os.makedirs(self.root, exist_ok=True)

    def _ckpt_dir(self, n: int) -> str:
        return os.path.join(self.root, f"ckpt-{n}")

    def _latest(self) -> Optional[dict]:
        f = os.path.join(self.root, "LATEST")
        if not os.path.exists(f):
            return None
        with open(f) as fh:
            return json.load(fh)

    def latest(self) -> Optional[int]:
        rec = self._latest()
        return None if rec is None else rec["number"]

    def latest_meta(self) -> Optional[dict]:
        rec = self._latest()
        return None if rec is None else rec.get("meta", {})

    def numbers(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("ckpt-"):
                try:
                    out.append(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, number: int, state: Dict[str, Any],
             meta: Optional[dict] = None) -> None:
        tmp = self._ckpt_dir(number) + ".tmp"
        final = self._ckpt_dir(number)

        def _write():
            if os.path.exists(final):
                shutil.rmtree(final)
            _write_dir(tmp, state)

        _io_retry(_write)
        _io.fsync_tree(tmp)
        os.rename(tmp, final)
        _io.fsync_dir(self.root)

        def _write_latest(tmp_path):
            with open(tmp_path, "w") as fh:
                json.dump({"number": number, "meta": meta or {}}, fh)

        _io.atomic_replace(os.path.join(self.root, "LATEST"), _write_latest)
        self._gc()

    def restore(self, number: Optional[int] = None):
        number = self.latest() if number is None else number
        if number is None:
            return None
        return _io_retry(_read_dir, self._ckpt_dir(number))

    def _gc(self) -> None:
        nums = self.numbers()
        latest = self.latest()
        while len(nums) > self.keep_max:
            n = nums.pop(0)
            if n == latest:
                continue
            shutil.rmtree(self._ckpt_dir(n), ignore_errors=True)


def train_epoch_range(max_epoch: int, root: str,
                      get_state: Callable[[], Dict[str, Any]],
                      set_state: Callable[[Dict[str, Any]], None],
                      keep_max: int = 2, save_every: int = 1):
    """The auto-checkpoint epoch loop::

        for epoch in train_epoch_range(10, dir, get_state, set_state):
            ...train one epoch...

    A fresh run yields 0 .. max_epoch-1 and saves the state after every
    ``save_every`` epochs and after the last; a restart restores the last
    saved state and resumes from the epoch after it."""
    saver = CheckpointSaver(root, keep_max=keep_max)
    last = saver.latest()
    start = 0
    if last is not None:
        set_state(saver.restore(last))
        start = last + 1
    for epoch in range(start, max_epoch):
        yield epoch
        if (epoch + 1) % save_every == 0 or epoch == max_epoch - 1:
            saver.save(epoch, get_state(), meta={"epoch": epoch})
