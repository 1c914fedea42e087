"""Device resolution — counterpart of ``paddle_tpu.core.place``.

The port's entry points take ``device=None`` and run on the card by
default (``static.Executor`` takes a ``CPUPlace`` or ``CUDAPlace``). A
missing card is an error, never a silent move to the CPU: the CPU is used
only when the caller names it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "CPUPlace", "CUDAPlace"]

DEFAULT_DEVICE = "cuda"


class CPUPlace:
    """The host, as ``static.Executor``'s ``place``."""

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    """CUDA device ``index``, as ``static.Executor``'s ``place``."""

    def __init__(self, index: int = 0):
        self.index = int(index)

    def __repr__(self):
        return f"CUDAPlace({self.index})"


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
