"""Statistics — counterpart of ``paddle_tpu.tensor.stat``.

``median`` and ``nanmedian`` average the two middle values of an even
count (jnp's rule; torch's own ``median`` takes the lower one), and
``median(mode="min")`` over an axis takes the lower, as the reference
does.
"""
from __future__ import annotations

import torch

from ._util import as_tensor, dims, from_host, to_float
from .creation import numel  # noqa: F401  (re-export)
from .math import mean  # noqa: F401  (re-export)

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile", "nanquantile", "numel"]


def _moments(fn, x, axis, unbiased, keepdim):
    t = to_float(as_tensor(x))
    d = dims(axis, t.dim())
    out = fn(t, dim=d, correction=1 if unbiased else 0, keepdim=keepdim)
    return out


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moments(torch.std, x, axis, unbiased, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moments(torch.var, x, axis, unbiased, keepdim)


def _to_last(t, axis):
    """``t`` with the reduced axes flattened into one last axis, and the
    shape that ``keepdim`` keeps."""
    d = dims(axis, t.dim())
    rest = [i for i in range(t.dim()) if i not in d]
    kept = [1 if i in d else s for i, s in enumerate(t.shape)]
    moved = t.permute(*rest, *d) if t.dim() else t.reshape(1)
    return moved.reshape(*[t.shape[i] for i in rest], -1), kept


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    t = to_float(as_tensor(x))
    flat, kept = _to_last(t, axis)
    s = torch.sort(flat, dim=-1).values
    n = s.shape[-1]
    lo = s[..., (n - 1) // 2]
    if mode == "min" and axis is not None:
        out = lo
    else:
        out = (lo + s[..., n // 2]) / 2
    return out.reshape(kept) if keepdim else out


def nanmedian(x, axis=None, keepdim=False, name=None):
    t = to_float(as_tensor(x))
    flat, kept = _to_last(t, axis)
    out = torch.nanquantile(flat, 0.5, dim=-1)
    return out.reshape(kept) if keepdim else out


def _quantile(fn, x, q, axis, keepdim, interpolation):
    t = as_tensor(x)
    t = t if t.dtype == torch.float64 else t.float()
    qq = q.to(t) if isinstance(q, torch.Tensor) else from_host(
        q, t.dtype, t.device)
    flat, kept = _to_last(t, axis)
    out = fn(flat, qq, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(*qq.shape, *kept)
    return out


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)
