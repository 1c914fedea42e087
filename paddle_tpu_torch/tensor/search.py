"""Search and sort — counterpart of ``paddle_tpu.tensor.search``.

Ties keep the reference's order: ``argsort``, ``sort``, ``topk`` and
``kthvalue`` are stable (among equal values the lowest index comes
first; ``topk`` is a stable sort cut to k, since ``torch.topk`` promises
no order among ties on CUDA); ``argmax`` / ``argmin`` take the first
extreme; ``mode`` takes the largest of the most frequent values and its
last position.
"""
from __future__ import annotations

import torch

from ._util import as_tensor, pair
from .manipulation import index_sample, masked_select, nonzero, where  # noqa: F401

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "searchsorted", "kthvalue",
    "mode", "index_sample", "masked_select", "where", "nonzero",
]


def _arg_extreme(fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        t = as_tensor(x)
        if axis is None:
            out = fn(t.reshape(-1))
            return out.reshape((1,) * t.dim()) if keepdim else out
        return fn(t, int(axis), keepdim=keepdim)

    return op


argmax = _arg_extreme(torch.argmax)
argmin = _arg_extreme(torch.argmin)


def argsort(x, axis=-1, descending=False, name=None):
    return torch.sort(as_tensor(x), dim=axis, descending=descending,
                      stable=True).indices


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(as_tensor(x), dim=axis, descending=descending,
                      stable=True).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    t = as_tensor(x)
    kk = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    ax = -1 if axis is None else int(axis)
    vals, idx = torch.sort(t, dim=ax, descending=largest, stable=True)
    return vals.narrow(ax, 0, kk), idx.narrow(ax, 0, kk)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq, v = pair(sorted_sequence, values)
    seq, v = seq.detach(), v.detach()
    if seq.dim() > 1:
        seq = seq.reshape(-1, seq.shape[-1])
        out = torch.searchsorted(seq, v.reshape(seq.shape[0], -1),
                                 out_int32=out_int32, right=right)
        return out.reshape(v.shape)
    return torch.searchsorted(seq, v, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    vals, idx = torch.sort(as_tensor(x), dim=axis, stable=True)
    vals = vals.select(axis, k - 1)
    idx = idx.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the largest among equally
    frequent ones) and its last position there; computed on the device
    by comparing each element with every other of its row."""
    t = as_tensor(x).detach()
    a = t.movedim(axis, -1)
    counts = (a.unsqueeze(-1) == a.unsqueeze(-2)).sum(-1)
    most = counts.amax(-1, keepdim=True)
    lowest = (torch.finfo(a.dtype).min if a.is_floating_point()
              else torch.iinfo(a.dtype).min)
    best = torch.where(counts == most, a,
                       torch.full((), lowest, dtype=a.dtype,
                                  device=a.device)).amax(-1)
    pos = torch.arange(a.shape[-1], device=a.device)
    last = torch.where(a == best.unsqueeze(-1), pos, -1).amax(-1)
    if keepdim:
        best, last = best.unsqueeze(axis), last.unsqueeze(axis)
    return best, last
