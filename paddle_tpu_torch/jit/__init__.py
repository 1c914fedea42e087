"""``paddle_tpu_torch.jit`` — ``to_static``, ``save`` / ``load``,
``InputSpec``, ``not_to_static``, ``TracedLayer``, and the functional
views of a module (``functionalize``) — counterpart of
``paddle_tpu.jit``.

The reference's ``to_static`` is ``jax.jit`` of the function after the
dy2static converter (``dy2static.py``) has rewritten its tensor control
flow; its numbers are the eager numbers. The port calls the converted
function eagerly, with no compile: as the reference's, the call runs
under ``torch.no_grad``, the outputs are tensors with no gradient, and a
Layer's buffers update as its forward updates them (BatchNorm's running
statistics in train mode). Inside ``program_guard`` the converted
function records its ``if`` / ``while`` as ``static`` control flow.

``save(layer, path)`` writes ``path.pdiparams`` (the layer's state dict,
``framework.io``) and ``path.pdmodel`` (its class name), as the reference
does; with an ``input_spec`` it also writes ``path.pdexport``, the
``torch.export`` program of the layer's eval forward with its weights
(``inference/_export.py``), which ``inference.create_predictor`` serves.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import torch
from torch import nn

from ..static.program import InputSpec
from . import dy2static
from .functionalize import (TracedLayer, functionalize, get_buffers,
                            get_params, load_jax_params, set_buffers,
                            set_params)

__all__ = ["to_static", "save", "load", "not_to_static", "TracedLayer",
           "StaticFunction", "InputSpec", "dy2static", "functionalize",
           "get_params", "get_buffers", "load_jax_params", "set_params",
           "set_buffers"]


def _detached(out):
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, (list, tuple)):
        return type(out)(_detached(o) for o in out)
    if isinstance(out, dict):
        return {k: _detached(v) for k, v in out.items()}
    return out


class StaticFunction:
    """A converted function or Layer forward, called eagerly under
    ``no_grad``; its outputs carry no gradient."""

    def __init__(self, fn: Callable, input_spec=None,
                 layer: Optional[nn.Module] = None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec

    def __call__(self, *args, **kwargs):
        with torch.no_grad():
            return _detached(self._fn(*args, **kwargs))

    @property
    def concrete_program(self):
        return self


def to_static(function=None, input_spec=None, build_strategy=None,
              **kwargs):
    """Decorator: a function, or a Layer (its ``forward``), with its
    tensor control flow converted (``dy2static.convert_to_static``)."""
    from .dy2static import convert_to_static

    def decorate(fn):
        if isinstance(fn, nn.Module):
            raw = getattr(fn.forward, "__func__", None)
            if raw is not None:
                conv = convert_to_static(raw)
                if getattr(conv, "_dy2static_converted", False):
                    fn.forward = conv.__get__(fn)
            return StaticFunction(fn, input_spec, layer=fn)
        return StaticFunction(convert_to_static(fn), input_spec)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Leave ``fn`` as it is when ``to_static`` converts its caller."""
    fn._not_to_static = True
    return fn


class _Serving(nn.Module):
    """The exported forward: ``layer`` with its float inputs cast to
    ``dtype`` and its float outputs cast back to float32 (a precision
    export), or ``layer`` as it is (``dtype`` None)."""

    def __init__(self, layer: nn.Module, dtype: Optional[torch.dtype]):
        super().__init__()
        self.layer = layer
        self.dtype = dtype

    def forward(self, *xs):
        if self.dtype is None:
            return self.layer(*xs)
        xs = [x.to(self.dtype) if x.is_floating_point() else x for x in xs]
        out = self.layer(*xs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        outs = tuple(o.float() if o.is_floating_point() else o for o in outs)
        return outs if isinstance(out, (list, tuple)) else outs[0]


def _float_dtype(layer: nn.Module) -> str:
    for p in layer.parameters():
        if p.is_floating_point():
            return str(p.dtype).replace("torch.", "")
    return "float32"


def save(layer, path: str, input_spec=None, **configs) -> None:
    """``path.pdiparams`` (the state dict) and ``path.pdmodel`` (the
    class name); with ``input_spec`` (``InputSpec``s, None/-1 for a
    dynamic dim) also ``path.pdexport``, the exported eval forward.
    ``precision='bfloat16' | 'float16'`` bakes weights cast to that dtype
    into the artifact (its float inputs are cast, its float outputs come
    back as float32). ``encrypt_key`` (AES key bytes) encrypts both the
    ``.pdiparams`` and the ``.pdexport`` (``framework.io_crypto``). The
    layer is put in eval mode. An export that fails raises."""
    from ..framework.io import save as _save_state

    if isinstance(layer, StaticFunction):
        layer = layer._layer
    precision = configs.get("precision")
    if precision and precision not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"unsupported export precision {precision!r} "
                         "(float32, bfloat16, float16)")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    _save_state(layer.state_dict(), path + ".pdiparams",
                cipher_key=configs.get("encrypt_key"))
    meta = {"class": type(layer).__name__}
    if input_spec:
        meta["in_specs"] = _export_layer(layer, path, input_spec, precision,
                                         configs.get("encrypt_key"))
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f)


def _export_layer(layer, path, input_spec, precision, encrypt_key=None):
    """Write ``path.pdexport``; returns its input specs."""
    import copy

    from ..inference._export import export_module, write_pdexport
    from ..static.program import convert_dtype

    layer.eval()
    cast = None
    if precision and precision != "float32":
        cast = getattr(torch, precision)
        layer = copy.deepcopy(layer).to(cast)
    device = next((t.device for t in layer.parameters()),
                  torch.device("cpu"))
    specs = [(list(s.shape), convert_dtype(s.dtype)) for s in input_spec]
    ep = export_module(_Serving(layer, cast), specs, device)
    n_out = len([n for n in ep.graph_signature.output_specs
                 if n.kind.name == "USER_OUTPUT"])
    in_specs = [([None if d is None or d < 0 else int(d) for d in shape],
                 str(dt).replace("torch.", "")) for shape, dt in specs]
    write_pdexport(path, ep,
                   [s.name or f"x{i}" for i, s in enumerate(input_spec)],
                   [f"output{i}" for i in range(n_out)], in_specs,
                   dtype=precision or _float_dtype(layer),
                   encrypt_key=encrypt_key)
    return in_specs


class _Loaded:
    def __init__(self, state, meta):
        self.state_dict_data = state
        self.meta = meta

    def state_dict(self):
        return self.state_dict_data


def load(path: str, **configs) -> _Loaded:
    """What ``save`` wrote: ``.state_dict()`` (load it into the layer's
    class with ``set_state_dict``) and ``.meta``."""
    from ..framework.io import load as _load_state

    state = _load_state(path + ".pdiparams",
                        cipher_key=configs.get("cipher_key"))
    meta = {}
    if os.path.exists(path + ".pdmodel"):
        with open(path + ".pdmodel", "rb") as f:
            meta = pickle.load(f)
    return _Loaded(state, meta)
