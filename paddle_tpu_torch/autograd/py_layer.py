"""Custom autograd ops — counterpart of ``paddle_tpu.autograd.py_layer``.

A ``PyLayer`` subclass gives ``forward(ctx, *args)`` and
``backward(ctx, *grads)`` as static methods over tensors; ``apply`` runs
them as one ``torch.autograd.Function`` made for the subclass (once, at
its first ``apply``). ``ctx`` is a ``PyLayerContext``: ``save_for_backward``,
``saved_tensor()`` and the ``extra`` dict.
"""
from __future__ import annotations

import torch


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.extra = {}

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


class _Ctx(PyLayerContext):
    """The context handed to the subclass's methods, tied to torch's."""

    def __init__(self, fn_ctx):
        super().__init__()
        self._fn_ctx = fn_ctx

    def save_for_backward(self, *tensors):
        self._fn_ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return self._fn_ctx.saved_tensors


def _function_of(cls):
    """The subclass's ``torch.autograd.Function``, made at its first
    ``apply``. Keyword arguments ride by position, their names first
    (torch's Functions take none)."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(fn_ctx, kw_names, *flat):
        ctx = fn_ctx.pylayer_ctx = _Ctx(fn_ctx)
        n_args = len(flat) - len(kw_names)
        outs = cls.forward(ctx, *flat[:n_args],
                           **dict(zip(kw_names, flat[n_args:])))
        fn_ctx.n_in = len(flat)
        return tuple(outs) if isinstance(outs, list) else outs

    def backward(fn_ctx, *grads):
        got = cls.backward(fn_ctx.pylayer_ctx, *grads)
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        got += [None] * (fn_ctx.n_in - len(got))
        return (None, *got[:fn_ctx.n_in])

    fn = type(cls.__name__ + "Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    @staticmethod
    def forward(ctx: PyLayerContext, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        names = tuple(kwargs)
        return _function_of(cls).apply(names, *args,
                                       *(kwargs[n] for n in names))
