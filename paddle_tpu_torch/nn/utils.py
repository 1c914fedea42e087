"""Weight reparametrizations — counterpart of ``paddle_tpu.nn.utils``:
``weight_norm`` / ``remove_weight_norm`` and ``spectral_norm``.

Each replaces a layer's parameter by the parameters it is computed from,
named as the reference names them so that they cross over by name:
``{name}_g`` and ``{name}_v`` for ``weight_norm`` (``g`` [shape[dim]], or a
scalar for ``dim=None``, the whole-tensor norm), ``{name}_orig`` and the
sublayer ``{name}_sn`` (``weight_u``, ``weight_v``) for ``spectral_norm``.
A forward pre-hook recomputes ``layer.{name}`` before every call (and once
when the reparametrization is made), so gradients reach the new
parameters.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _norm_except(w: torch.Tensor, dim) -> torch.Tensor:
    if dim is None:
        return torch.sqrt((w * w).sum())
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt((w * w).sum(axes, keepdim=True))


def _weight_from(v: torch.Tensor, g: torch.Tensor, dim) -> torch.Tensor:
    n = _norm_except(v, dim)
    return v / n * g.reshape(n.shape)


def weight_norm(layer: nn.Module, name: str = "weight", dim=0) -> nn.Module:
    """``layer.{name} = g · v / ‖v‖`` (the norm over every axis but
    ``dim``), with ``g`` and ``v`` starting from the current weight."""
    w = getattr(layer, name)
    with torch.no_grad():
        norm = _norm_except(w, dim)
        g = nn.Parameter(norm.reshape(-1) if dim is not None
                         else norm.reshape(()))
        v = nn.Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_g", g)
    layer.register_parameter(name + "_v", v)

    def pre_hook(mod, inputs):
        setattr(mod, name, _weight_from(getattr(mod, name + "_v"),
                                        getattr(mod, name + "_g"), dim))

    layer._weight_norm_handle = layer.register_forward_pre_hook(pre_hook)
    layer._weight_norm_cfg = (name, dim)
    pre_hook(layer, ())
    return layer


def remove_weight_norm(layer: nn.Module, name: str = "weight") -> nn.Module:
    """Fold ``g`` and ``v`` back into a plain ``{name}`` parameter."""
    handle = getattr(layer, "_weight_norm_handle", None)
    if handle is not None:
        handle.remove()
    _, dim = getattr(layer, "_weight_norm_cfg", (name, 0))
    v = layer._parameters.pop(name + "_v")
    g = layer._parameters.pop(name + "_g")
    with torch.no_grad():
        w = nn.Parameter(_weight_from(v, g, dim))
    if name in layer.__dict__:
        del layer.__dict__[name]
    layer.register_parameter(name, w)
    return layer


def spectral_norm(layer: nn.Module, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim=None) -> nn.Module:
    """``layer.{name} = SpectralNorm(...)({name}_orig)`` (``dim=None`` is
    axis 0); the sublayer's u and v are drawn on the weight's device."""
    from .layer.norm import SpectralNorm

    w = getattr(layer, name)
    sn = SpectralNorm(list(w.shape), dim=0 if dim is None else dim,
                      power_iters=n_power_iterations, eps=eps,
                      device=w.device)
    layer.add_module(name + "_sn", sn)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig",
                             nn.Parameter(w.detach().clone()))

    def pre_hook(mod, inputs):
        setattr(mod, name, sn(getattr(mod, name + "_orig")))

    layer.register_forward_pre_hook(pre_hook)
    pre_hook(layer, ())
    return layer
