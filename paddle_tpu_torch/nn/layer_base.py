"""A layer's parameters and state — counterpart of
``paddle_tpu.nn.layer_base.Layer``'s ``create_parameter`` and its state
methods.

``create_parameter`` makes a parameter from a ``ParamAttr`` as the
reference's does: its initializer (else Xavier-uniform for a weight,
zeros for a bias), its name, its learning-rate scale
(``optimize_attr['learning_rate']``, which the optimizers' ``step``
multiplies into the learning rate), its regularizer, ``trainable`` (the
parameter's ``requires_grad``) and ``need_clip``; ``attr=False`` makes
none.

The port's layers are ``nn.Module``s, so ``module.state_dict()`` comes
from torch: parameters and persistent buffers (BatchNorm's ``_mean`` and
``_variance``) under their structured names; a non-persistent buffer
(the reference's ``_non_persistable_buffer_names``) is left out, as in the
reference. ``set_state_dict`` loads one with the reference's semantics.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import initializer as I
from .param_attr import ParamAttr

__all__ = ["create_parameter", "set_state_dict"]


def create_parameter(shape, attr=None, dtype=None, is_bias: bool = False,
                     default_initializer: Optional[I.Initializer] = None,
                     device=None,
                     generator: Optional[torch.Generator] = None
                     ) -> Optional[nn.Parameter]:
    """A parameter of ``shape`` made as ``attr`` (a ``ParamAttr``, a
    name, an initializer, None, or False for no parameter) says: its
    initializer, else ``default_initializer``, else Xavier-uniform (zeros
    for a bias), drawn from ``generator`` (else the initializers' own),
    in ``dtype`` (default f32) on ``device``."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierUniform())
    dtype = dtype if dtype is not None else torch.float32
    p = nn.Parameter(init(list(shape), dtype, device, generator=generator),
                     requires_grad=bool(attr.trainable))
    if attr.name:
        from ..static.program import set_param_name

        set_param_name(p, attr.name)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.trainable = bool(attr.trainable)
    return p


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
