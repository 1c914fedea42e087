"""The hook through which a Program being recorded sees the port's ops —
counterpart of ``paddle_tpu.core.tensor``'s ``_op_recorder``, the hook
that ``static.program_guard`` installs into the reference's op layer.

The port has no op layer of its own: ``static.program_guard`` pushes a
``torch.overrides.TorchFunctionMode`` (``static.program._Recorder``) that
sees every torch call, and makes it this thread's ``active()`` recorder.
A torch function mode does not see a ``torch.autograd.Function`` (only
the torch calls inside its ``forward``) nor a kernel launched through
``ctypes``, so the port's Functions go through ``record_opaque``: while a
Program records, the Function runs with the recorder quiet and is
recorded as one op, which replays as the same ``.apply`` — with its
kernel on the card and its hand-written backward.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

__all__ = ["active", "record_opaque"]


class _Local(threading.local):
    def __init__(self):
        self.recorder = None


_local = _Local()


def active() -> Optional[Any]:
    """This thread's recorder while a Program records, else None."""
    return _local.recorder


def set_active(recorder) -> Optional[Any]:
    """Make ``recorder`` (or None) this thread's recorder; returns the
    previous one."""
    prev, _local.recorder = _local.recorder, recorder
    return prev


def record_opaque(fn: Callable, *args):
    """``fn(*args)``; while a Program records, also one op of it."""
    rec = _local.recorder
    if rec is None:
        return fn(*args)
    return rec.record_opaque(fn, args)
