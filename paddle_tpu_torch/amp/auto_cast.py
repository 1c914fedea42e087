"""Automatic mixed precision — counterpart of ``paddle_tpu.amp.auto_cast``.

The port keeps its own thread-local AMP state with the reference's op
lists, and does not use ``torch.autocast``: torch decides for itself what
ops such as ``batch_norm``, ``mean`` and ``sum`` run in, and the
reference's lists decide it here. Only the white-listed functionals
consult the state (``nn.layer.common.linear`` and the
``nn.functional.conv`` convolutions): under ``auto_cast`` they cast their
float inputs and weights to the low-precision dtype. Everything else runs
in the dtype of what it is given: BatchNorm takes a bf16 activation,
keeps its statistics in f32 and returns bf16; the loss runs in f32.

With AMP off, which is the default, ``maybe_cast_inputs`` returns its
arguments as they are, so no path that does not enter ``auto_cast``
changes. ``decorate`` (level O2) casts a model's float parameters and
buffers to the low-precision dtype, as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["white_list", "black_list", "auto_cast", "amp_guard",
           "amp_state", "maybe_cast_inputs", "decorate"]

# ops that run in low precision (matmul-class, conv-class)
white_list = {"conv2d", "conv1d", "conv3d", "matmul", "linear", "mul",
              "einsum", "bmm", "attention"}
# ops that must stay fp32 (reductions / transcendental-heavy)
black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "layer_norm", "batch_norm", "group_norm",
    "instance_norm",
}

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.float16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    """This thread's AMP state."""
    return _state


def _convert_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"auto_cast: unknown dtype {dtype!r} "
                         f"({', '.join(_DTYPES)})") from None


def _should_cast(op_name: str) -> bool:
    if not _state.enabled:
        return False
    if op_name in _state.custom_black:
        return False
    if _state.level == "O2":
        return op_name not in black_list
    return op_name in white_list or op_name in _state.custom_white


def maybe_cast_inputs(op_name: str, *ts):
    """``ts`` with each float tensor cast to the AMP dtype when ``op_name``
    runs in low precision under the current state; else ``ts`` as given."""
    if not _should_cast(op_name):
        return ts
    d = _state.dtype
    return tuple(t.to(d) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in ts)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="float16"):
    """Run the enclosed ops under AMP: at ``level`` O2 every op that is
    not black-listed casts to ``dtype``; at any other level (as in the
    reference) the white-listed ops and ``custom_white_list`` do. The
    previous state comes back on exit."""
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = _convert_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="float16",
             master_weight=None, save_dtype=None):
    """Pure low precision: at level O2 cast each model's float parameters
    and buffers (BatchNorm's running statistics among them) to ``dtype``
    (in place), as the reference's ``_convert_dtype`` does; the
    parameters stay the same tensors. Returns the models, and the
    optimizers with them when given, as the reference does. The f32
    masters are the optimizer's (``multi_precision=True``);
    ``master_weight`` and ``save_dtype`` are taken and, as in the
    reference, not read."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        d = _convert_dtype(dtype)
        for m in model_list:
            m.to(d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
