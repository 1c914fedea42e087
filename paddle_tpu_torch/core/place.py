"""Device resolution — counterpart of ``paddle_tpu.core.place``.

The port's entry points take ``device=None`` and run on the card by
default (``static.Executor`` takes a ``CPUPlace`` or ``CUDAPlace``). A
missing card is an error, never a silent move to the CPU: the CPU is used
only when the caller names it.

The tensor API's creation functions (``to_tensor``, ``zeros``,
``randn``, ...) take no device: they make their tensors on the current
device, ``"gpu:0"`` (``cuda:0``) until ``set_device`` names another.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "NPUPlace", "TPUPlace", "XPUPlace", "Place",
           "set_device", "get_device", "current_device", "place_to_device",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]

DEFAULT_DEVICE = "cuda"


class Place:
    """A device identity: its kind and index."""

    _kind = "unknown"

    def __init__(self, index: int = 0):
        self.index = int(index)

    def get_device_id(self) -> int:
        return self.index

    def __eq__(self, other):
        return (isinstance(other, Place) and self._kind == other._kind
                and self.index == other.index)

    def __hash__(self):
        return hash((self._kind, self.index))


class CPUPlace(Place):
    """The host, as ``static.Executor``'s ``place``."""

    _kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    """CUDA device ``index``, as ``static.Executor``'s ``place``."""

    _kind = "gpu"

    def __repr__(self):
        return f"CUDAPlace({self.index})"


class CUDAPinnedPlace(Place):
    """Page-locked host memory: tensors made there are pinned CPU
    tensors."""

    _kind = "gpu_pinned"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CUDAPinnedPlace"


class NPUPlace(Place):
    """An Ascend NPU: named for the reference's surface; the port runs on
    none, and using it as a place raises."""

    _kind = "npu"

    def __repr__(self):
        return f"NPUPlace({self.index})"


class TPUPlace(Place):
    """A TPU, the reference's device: named for its surface; the port
    runs on none, and using it as a place raises."""

    _kind = "tpu"

    def __repr__(self):
        return f"TPUPlace({self.index})"


class XPUPlace(Place):
    """A Kunlun XPU: named for the reference's surface; the port runs on
    none, and using it as a place raises."""

    _kind = "xpu"

    def __repr__(self):
        return f"XPUPlace({self.index})"


_current_device = "gpu:0"


def is_compiled_with_cuda() -> bool:
    """True: the port's kernels are CUDA kernels."""
    return True


def is_compiled_with_tpu() -> bool:
    return False


def place_to_device(place) -> torch.device:
    """A place (a ``Place``, a ``torch.device``, or a name such as "cpu",
    "gpu", "gpu:1", "cuda:0") as a ``torch.device``; a CUDA device that
    this process lacks raises, as ``resolve_device`` does."""
    if isinstance(place, Place):
        if place._kind in ("cpu", "gpu_pinned"):
            return torch.device("cpu")
        if place._kind == "gpu":
            return resolve_device(f"cuda:{place.index}")
        raise ValueError(f"{place!r}: the port runs on no {place._kind}")
    if isinstance(place, str):
        name, _, idx = place.partition(":")
        if name == "gpu":
            place = "cuda" + (":" + idx if idx else ":0")
        elif name in ("npu", "xpu", "tpu"):
            raise ValueError(f"{place!r}: the port runs on no {name}")
    return resolve_device(place)


def set_device(device) -> str:
    """Make ``device`` ("cpu", "gpu", "gpu:N", or a place) the current
    device of the tensor API's creation functions; returns its name."""
    global _current_device
    dev = place_to_device(device)
    _current_device = ("cpu" if dev.type == "cpu"
                       else f"gpu:{dev.index if dev.index is not None else 0}")
    return _current_device


def get_device() -> str:
    """The current device's name: "gpu:0" (the default) or "cpu"."""
    return _current_device


def current_device() -> torch.device:
    """The current device as a ``torch.device`` (raises where it is a
    card this process lacks)."""
    return place_to_device(_current_device)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and this
    process has none."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    return dev
