"""Named parameters and buffers of a module — counterpart of
``paddle_tpu.jit.functionalize``.

``get_params`` names parameters exactly as the reference's ``get_params``
does (``gpt.h.{i}.attn.qkv.weight`` ...), and the port keeps the
reference's [in, out] ``Linear`` layout, so a reference parameter dict
maps onto a port model name for name and shape for shape. ``get_buffers``
does the same for buffers (BatchNorm's ``bn1._mean``, ``bn1._variance``).
``load_jax_params`` carries weights, and buffers when given, across;
``set_params`` / ``set_buffers`` point a module's parameters / buffers at
given tensors; ``functionalize`` runs a module in a given train/eval
mode, optionally on casts of its float parameters. Buffers are the
module's own: a train-mode forward updates BatchNorm's running
statistics in place, and a cast mode leaves them in their dtype.
``TracedLayer`` calls a layer in a fixed mode under ``no_grad``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

__all__ = ["get_params", "set_params", "get_buffers", "set_buffers",
           "load_jax_params", "functionalize", "TracedLayer"]


def get_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Named parameter dict (detached tensors sharing the model's
    storage)."""
    return {name: p.detach() for name, p in model.named_parameters()}


def set_params(model: nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Make each named parameter of ``model`` hold the given tensor (its
    storage, dtype and device); names must exist in the model."""
    named = dict(model.named_parameters())
    unknown = sorted(set(params) - set(named))
    if unknown:
        raise KeyError(f"set_params: no parameters named {unknown[:5]}")
    for name, v in params.items():
        named[name].data = v.detach()


def get_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Named buffer dict (the model's own tensors)."""
    return dict(model.named_buffers())


def set_buffers(model: nn.Module, buffers: Mapping[str, torch.Tensor]
                ) -> None:
    """Make each named buffer of ``model`` hold the given tensor; names
    must exist in the model."""
    named = dict(model.named_buffers())
    unknown = sorted(set(buffers) - set(named))
    if unknown:
        raise KeyError(f"set_buffers: no buffers named {unknown[:5]}")
    for name, v in buffers.items():
        named[name].data = v.detach()


def functionalize(model: nn.Module, training: bool,
                  compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """``apply(*args, **kwargs)``: ``model``'s forward in train mode
    (``training=True``) or eval mode (``False``), with the model's own
    mode restored afterwards. The port's autograd works on the model's
    parameters in place, so unlike the reference's ``functionalize`` no
    parameter pytree goes in or out.

    With ``compute_dtype`` the forward runs on its float parameters cast
    to that dtype, the casts made anew at each call under autograd
    (``torch.func.functional_call``): gradients reach the parameters in
    their own dtype, through the casts' backward."""

    def forward(*args, **kwargs):
        if compute_dtype is None:
            return model(*args, **kwargs)
        casts = {n: p.to(compute_dtype) if p.is_floating_point() else p
                 for n, p in model.named_parameters()}
        return functional_call(model, casts, args, kwargs)

    def apply(*args, **kwargs):
        prev = model.training
        model.train(training)
        try:
            return forward(*args, **kwargs)
        finally:
            model.train(prev)

    return apply


def load_jax_params(model: nn.Module,
                    np_params: Mapping[str, np.ndarray],
                    buffers: Optional[Mapping[str, np.ndarray]] = None
                    ) -> nn.Module:
    """Fill ``model`` with the reference's weights, given as numpy arrays
    (``{k: np.asarray(v) for k, v in paddle_tpu.jit.functionalize.
    get_params(m).items()}``), and with its buffers when ``buffers`` is
    given (the same from ``get_buffers(m)``). Names and shapes must match
    one for one — no transpose is needed because both sides keep
    ``Linear`` weights as [in, out] and convolution weights as
    [out, in/groups, *k]. Values are cast to each tensor's dtype and
    device."""
    _copy_named("parameter", dict(model.named_parameters()), np_params)
    if buffers is not None:
        _copy_named("buffer", dict(model.named_buffers()), buffers)
    return model


def _copy_named(kind: str, named: Mapping[str, torch.Tensor],
                arrays: Mapping[str, np.ndarray]) -> None:
    missing = sorted(set(named) - set(arrays))
    extra = sorted(set(arrays) - set(named))
    if missing or extra:
        raise KeyError(f"{kind} names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, t in named.items():
            a = np.array(arrays[name], dtype=np.float32)  # own copy
            if a.shape != tuple(t.shape):
                raise ValueError(f"{name}: shape {a.shape} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(a))


class TracedLayer:
    """A layer's forward in a fixed mode (eval unless ``training``),
    called under ``no_grad``: outputs without gradient, buffers updated
    as the forward updates them (the reference's jitted functionalized
    apply)."""

    def __init__(self, layer: nn.Module, training: bool = False,
                 donate_buffers: bool = False):
        self._layer = layer
        self._apply = functionalize(layer, training=training)

    def __call__(self, *args):
        with torch.no_grad():
            out = self._apply(*args)
        if isinstance(out, (list, tuple)):
            return type(out)(o.detach() for o in out)
        return out.detach()
