"""A layer's state — counterpart of the state methods of
``paddle_tpu.nn.layer_base.Layer``.

The port's layers are ``nn.Module``s, so ``module.state_dict()`` comes
from torch: parameters and persistent buffers (BatchNorm's ``_mean`` and
``_variance``) under their structured names; a non-persistent buffer
(the reference's ``_non_persistable_buffer_names``) is left out, as in the
reference. ``set_state_dict`` loads one with the reference's semantics.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["set_state_dict"]


@torch.no_grad()
def set_state_dict(module: nn.Module, state_dict: Mapping
                   ) -> Tuple[List[str], List[str]]:
    """Load ``state_dict`` (tensors or numpy arrays, by structured name)
    into ``module`` and return ``(missing, unexpected)``: the module's
    names the dict lacks, and the dict's names the module lacks. A shape
    mismatch raises ``ValueError``. Each value is cast to its target's
    dtype and copied into it in place (``copy_``): the parameters stay the
    same tensors, so an optimizer's state (keyed by ``id(p)``) and the
    Adam kernel's pointer table still find them."""
    own = module.state_dict(keep_vars=True)
    unexpected = []
    for k, v in state_dict.items():
        target = own.get(k)
        if target is None:
            unexpected.append(k)
            continue
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{list(src.shape)} vs parameter "
                             f"{list(target.shape)}")
        target.copy_(src.detach().to(target.dtype))
    missing = [k for k in own if k not in state_dict]
    return missing, unexpected
