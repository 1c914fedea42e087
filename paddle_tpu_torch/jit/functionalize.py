"""Named parameters of a module — counterpart of
``paddle_tpu.jit.functionalize``, kept to what serving needs.

``get_params`` names parameters exactly as the reference's ``get_params``
does (``gpt.h.{i}.attn.qkv.weight`` ...), and the port keeps the
reference's [in, out] ``Linear`` layout, so a reference parameter dict
maps onto a port model name for name and shape for shape.
``load_jax_params`` carries weights across.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["get_params", "load_jax_params"]


def get_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Named parameter dict (detached tensors sharing the model's
    storage)."""
    return {name: p.detach() for name, p in model.named_parameters()}


def load_jax_params(model: nn.Module,
                    np_params: Mapping[str, np.ndarray]) -> nn.Module:
    """Fill ``model`` with the reference's weights, given as numpy arrays
    (``{k: np.asarray(v) for k, v in paddle_tpu.jit.functionalize.
    get_params(m).items()}``). Names and shapes must match one for one —
    no transpose is needed because both sides keep ``Linear`` weights as
    [in, out]. Values are cast to each parameter's dtype and device."""
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(np_params))
    extra = sorted(set(np_params) - set(named))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in named.items():
            a = np.array(np_params[name], dtype=np.float32)  # own copy
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))
    return model
