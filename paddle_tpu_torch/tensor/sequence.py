"""Sequence (LoD) functions — counterpart of ``paddle_tpu.tensor.sequence``.

A batch of variable-length rows is padded data with per-row lengths:
``x[B, T, ...]`` with ``lengths[B]``. The functions whose output has a
fixed shape (mask, pool, softmax, reverse, enumerate) are torch ops on
those two tensors, on their device, and a Program records them as it
records any torch op. Those whose output is ragged (pad, unpad, expand,
concat, slice) read the rows on the host and return new tensors, as the
reference does.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ._util import as_tensor, device_of

__all__ = [
    "sequence_mask",
    "sequence_pad",
    "sequence_unpad",
    "sequence_pool",
    "sequence_softmax",
    "sequence_reverse",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_concat",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_slice",
    "sequence_enumerate",
]


def _lens(lengths, like=None) -> torch.Tensor:
    t = as_tensor(lengths, like)
    return t if t.dtype in (torch.int32, torch.int64) else t.to(torch.int64)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _trail(t, data):
    """``t`` with a trailing 1 for each of ``data``'s axes past its first
    two. Axes are added, never a recorded size: a Program replays this at
    any batch."""
    for _ in range(data.dim() - 2):
        t = t.unsqueeze(-1)
    return t


def _valid(data, lens):
    """[B, T, 1, ...]: step t of row b is within its length."""
    pos = torch.arange(data.shape[1], device=data.device)
    return _trail(pos < lens.unsqueeze(-1), data)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[i, j] = j < x[i]``; ``maxlen`` None takes max(x), read on
    the host."""
    lens = _lens(x)
    if maxlen is None:
        maxlen = int(lens.max())
    pos = torch.arange(int(maxlen), device=lens.device, dtype=lens.dtype)
    return (pos < lens.unsqueeze(-1)).to(dtype_mod.convert_dtype(dtype))


def _rows_of(x, lengths):
    """The rows as numpy arrays: from a list of rows, a padded [B, T, ...]
    batch with lengths, or flat values with lengths."""
    if isinstance(x, (list, tuple)):
        return [_host(r) for r in x]
    data, lens = _host(x), _host(lengths)
    if data.ndim >= 2 and data.shape[0] == len(lens):
        return [data[i, :int(lens[i])] for i in range(len(lens))]
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return [data[offs[i]:offs[i + 1]] for i in range(len(lens))]


def _pad_rows(rows, pad_value, maxlen, device):
    lens = np.asarray([len(r) for r in rows], np.int64)
    t = int(maxlen) if maxlen is not None else int(lens.max() if len(lens)
                                                   else 0)
    tail = rows[0].shape[1:] if rows and rows[0].ndim > 1 else ()
    pv = _host(pad_value) if isinstance(pad_value, torch.Tensor) else (
        pad_value)
    out = np.full((len(rows), t) + tail, pv,
                  dtype=rows[0].dtype if rows else np.float32)
    for i, r in enumerate(rows):
        n = min(len(r), t)
        out[i, :n] = r[:n]
        lens[i] = n
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(lens).to(device))


def sequence_pad(x, pad_value=0.0, maxlen=None, length=None, name=None):
    """Rows padded to ``[B, maxlen, ...]``; returns (padded, lengths)."""
    return _pad_rows(_rows_of(x, length), pad_value, maxlen,
                     device_of(x, length))


def sequence_unpad(x, length, name=None):
    """The valid rows of a padded batch, as a list."""
    dev = device_of(x, length)
    data, lens = _host(x), _host(length).astype(np.int64)
    return [torch.from_numpy(np.ascontiguousarray(data[i, :int(lens[i])])
                             ).to(dev) for i in range(len(lens))]


def sequence_pool(x, pool_type: str, lengths=None, pad_value=0.0, name=None):
    """Each row pooled over its valid steps: [B, T, ...] -> [B, ...], for
    pool_type sum, average (mean), sqrt, max, min, first, last; a row of
    length 0 gives ``pad_value``."""
    if lengths is None:
        raise ValueError("sequence_pool needs lengths (padded+lengths "
                         "ragged form)")
    pool_type = pool_type.lower()
    data = as_tensor(x)
    lens = _lens(lengths, data)
    mask = _valid(data, lens)
    lensf = _trail(lens.clamp(min=1), data).to(data.dtype)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if pool_type == "sum":
        out = torch.where(mask, data, zero).sum(1)
    elif pool_type in ("average", "mean"):
        out = torch.where(mask, data, zero).sum(1) / lensf
    elif pool_type == "sqrt":
        out = torch.where(mask, data, zero).sum(1) / lensf.sqrt()
    elif pool_type == "max":
        out = torch.where(mask, data, zero - float("inf")).amax(1)
    elif pool_type == "min":
        out = torch.where(mask, data, zero + float("inf")).amin(1)
    elif pool_type == "first":
        out = data[:, 0]
    elif pool_type == "last":
        idx = _trail((lens - 1).clamp(min=0).unsqueeze(-1), data)
        out = torch.take_along_dim(data, idx, 1).squeeze(1)
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    empty = _trail(lens == 0, data)
    return torch.where(empty, torch.full((), pad_value, dtype=data.dtype,
                                         device=data.device), out)


def sequence_first_step(x, lengths=None):
    return sequence_pool(x, "first", lengths)


def sequence_last_step(x, lengths=None):
    return sequence_pool(x, "last", lengths)


def sequence_softmax(x, lengths=None, name=None):
    """Softmax over the valid steps of each row (axis 1); padding gets
    0."""
    if lengths is None:
        raise ValueError("sequence_softmax needs lengths")
    data = as_tensor(x)
    mask = _valid(data, _lens(lengths, data))
    z = torch.where(mask, data, torch.full((), -float("inf"),
                                           dtype=data.dtype,
                                           device=data.device))
    z = z - z.amax(1, keepdim=True).detach()
    e = torch.where(mask, z.exp(), torch.zeros((), dtype=data.dtype,
                                               device=data.device))
    return e / e.sum(1, keepdim=True).clamp(min=1e-38)


def sequence_reverse(x, lengths=None, name=None):
    """Each row's valid prefix reversed, the padding left in place."""
    if lengths is None:
        raise ValueError("sequence_reverse needs lengths")
    data = as_tensor(x)
    lens = _lens(lengths, data).unsqueeze(-1)
    pos = torch.arange(data.shape[1], device=data.device).unsqueeze(0)
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    return torch.take_along_dim(data, _trail(src, data), 1)


def sequence_expand(x, ref_lengths, x_lengths=None, name=None):
    """Row i of ``x`` repeated ``ref_lengths[i]`` times (the first level
    of the reference's ``sequence_expand``)."""
    dev = device_of(x, ref_lengths)
    reps = _host(ref_lengths).astype(np.int64)
    rows = (_rows_of(x, x_lengths) if x_lengths is not None
            else list(_host(x)))
    out = [r for i, r in enumerate(rows)
           for _ in range(int(reps[i]) if i < len(reps) else 1)]
    if not out:
        return torch.zeros((0,) + tuple(np.asarray(rows[0]).shape),
                           dtype=torch.float32, device=dev)
    return torch.from_numpy(np.stack(out)).to(dev)


def sequence_expand_as(x, y_lengths, name=None):
    return sequence_expand(x, y_lengths)


def sequence_concat(xs: Sequence, lengths_list: Sequence, name=None):
    """Row i of the result is row i of every input, concatenated; returns
    (padded, lengths)."""
    groups = [_rows_of(x, n) for x, n in zip(xs, lengths_list)]
    rows = [np.concatenate([g[i] for g in groups])
            for i in range(len(groups[0]))]
    return _pad_rows(rows, 0.0, None, device_of(*xs))


def sequence_slice(x, offset, length, lengths=None, name=None):
    """Row i cut to [offset[i], offset[i] + length[i]); returns (padded,
    lengths)."""
    rows = _rows_of(x, lengths)
    off = _host(offset).astype(np.int64).reshape(-1)
    ln = _host(length).astype(np.int64).reshape(-1)
    out = [r[int(off[i]):int(off[i] + ln[i])] for i, r in enumerate(rows)]
    return _pad_rows(out, 0.0, None, device_of(x))


def sequence_enumerate(x, win_size: int, pad_value=0, lengths=None,
                       name=None):
    """Sliding windows: ``out[i, j] = [x[i, j], ..., x[i, j + w - 1]]``,
    with ``pad_value`` past a row's length: [B, T] -> [B, T, win_size]."""
    data = as_tensor(x)
    t = data.shape[1]
    dev = data.device
    pos = (torch.arange(t, device=dev).unsqueeze(1)
           + torch.arange(win_size, device=dev).unsqueeze(0))
    gathered = data[:, pos.clamp(max=t - 1)]
    limit = (_lens(lengths, data).reshape(-1, 1, 1) if lengths is not None
             else t)
    return torch.where(pos.unsqueeze(0) < limit, gathered,
                       torch.full((), pad_value, dtype=data.dtype,
                                  device=dev))
