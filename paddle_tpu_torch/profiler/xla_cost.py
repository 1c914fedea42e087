"""The card's capacity and peaks — the part of
``paddle_tpu.profiler.xla_cost`` that ``ops.remat_policy`` reads:
``hbm_capacity_bytes``, ``cost_analysis_mode`` and ``chip_peaks``.

- ``hbm_capacity_bytes(device)``: ``PADDLE_TPU_DEVICE_HBM_BYTES`` when it
  is a positive number (an invalid value is ignored), else the card's
  ``total_memory``, else (the CPU) the reference's fallback of 32 GB;
- ``cost_analysis_mode()``: ``PADDLE_TPU_COST_ANALYSIS`` read as the
  reference reads it (``0`` turns ``remat='auto'``'s measurement off);
- ``chip_peaks(device)``: dense bf16 FLOP/s and HBM bytes/s — an H100's
  989e12 and 3.35e12 (NVIDIA's data sheet for the SXM part at 700 W),
  any other device the reference's fallback peaks; ``PADDLE_TPU_PEAK_
  FLOPS`` and ``PADDLE_TPU_HBM_GBPS`` override them. Read at every call
  (the reference caches them until its ``reset()``).

The reference's compile cost registry, MFU publishing and HLO stash wait
for the port of the attribution layer.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

__all__ = ["hbm_capacity_bytes", "cost_analysis_mode", "chip_peaks",
           "H100_BF16_DENSE_FLOPS", "H100_HBM_BYTES_PER_S"]

# NVIDIA's data sheet for the H100 SXM at its 700 W power limit: dense
# bf16 tensor-core peak and HBM3 bandwidth (``bench``'s MFU reads the same)
H100_BF16_DENSE_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
# device name substring (lowercased) -> (peak dense bf16 FLOP/s, HBM B/s)
_CHIP_PEAKS = (("h100", (H100_BF16_DENSE_FLOPS, H100_HBM_BYTES_PER_S)),)
_FALLBACK_PEAKS = (1e12, 100e9)
_FALLBACK_HBM = 32e9


def _cuda_device(device) -> Optional[torch.device]:
    """``device`` as a CUDA device, or None for the CPU (``None`` means
    the current card when this process has one)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def _positive_env(name: str) -> Optional[float]:
    try:
        v = float(os.environ.get(name) or 0)
    except ValueError:
        return None
    return v if v > 0 else None


def hbm_capacity_bytes(device: Union[str, torch.device, None] = None
                       ) -> float:
    """The device's memory in bytes — the budget ``remat='auto'`` sizes
    policies against."""
    override = _positive_env("PADDLE_TPU_DEVICE_HBM_BYTES")
    if override is not None:
        return override
    dev = _cuda_device(device)
    if dev is None:
        return _FALLBACK_HBM
    return float(torch.cuda.get_device_properties(dev).total_memory)


def cost_analysis_mode() -> str:
    """'off' | 'on' | 'full' (``PADDLE_TPU_COST_ANALYSIS``)."""
    v = os.environ.get("PADDLE_TPU_COST_ANALYSIS", "1").strip().lower()
    if v in ("0", "false", "off", "no"):
        return "off"
    return "full" if v == "full" else "on"


def chip_peaks(device: Union[str, torch.device, None] = None
               ) -> Dict[str, Union[float, str]]:
    """``{"flops": peak FLOP/s, "bytes_per_s": HBM bytes/s, "kind": the
    device's name, lowercased}``."""
    dev = _cuda_device(device)
    kind = "cpu" if dev is None else torch.cuda.get_device_name(dev).lower()
    flops, bps = _FALLBACK_PEAKS
    for sub, peaks in _CHIP_PEAKS:
        if sub in kind:
            flops, bps = peaks
            break
    flops = _positive_env("PADDLE_TPU_PEAK_FLOPS") or flops
    gbps = _positive_env("PADDLE_TPU_HBM_GBPS")
    return {"flops": flops, "bytes_per_s": gbps * 1e9 if gbps else bps,
            "kind": kind}
