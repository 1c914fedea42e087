"""Shape and layout — counterpart of ``paddle_tpu.tensor.manipulation``.

Paddle's rules are kept: ``reshape`` copies the input's dimension where
the new shape says 0, ``unsqueeze`` / ``expand`` / ``tile`` take their
list forms, ``scatter`` overwrites or (``overwrite=False``) zeroes the
named rows and sums the updates into them, and ``pad`` pairs apply to
the trailing axes from the last inward. ``masked_select``, ``nonzero``,
``unique``, ``unique_consecutive`` and ``repeat_interleave`` with tensor
repeats compute on the tensor's device; their output size is read back
once, the one sync that a data-dependent shape needs. The in-place
variants write into their first argument and return it.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod
from ..core.enforce import InvalidArgumentError, enforce
from ._util import as_tensor, int_list, promote, scalar_as

__all__ = [
    "reshape", "reshape_", "flatten_", "transpose", "flatten", "squeeze", "squeeze_",
    "unsqueeze", "unsqueeze_", "concat", "stack", "split", "chunk", "tile",
    "expand", "expand_as", "broadcast_to", "gather", "gather_nd", "scatter",
    "scatter_", "scatter_nd", "scatter_nd_add", "slice", "strided_slice",
    "index_select", "masked_select", "where", "roll", "flip", "rot90",
    "unbind", "unique", "unique_consecutive", "pad", "repeat_interleave",
    "take_along_axis", "put_along_axis", "moveaxis", "swapaxes", "unstack",
    "flip", "cast", "crop", "tensordot", "as_complex", "as_real", "tolist",
    "nonzero", "index_sample", "masked_fill", "shard_index", "multiplex",
]

_slice = builtins.slice


def _axis(axis) -> int:
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def _contiguous_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= max(s, 1)
    return tuple(reversed(strides))


def _reshape_in_place(x, shape):
    """``x`` given ``shape`` in place (its elements keep their order)."""
    if not x.is_contiguous():
        raise ValueError("an in-place reshape needs a contiguous tensor")
    return x.as_strided_(shape, _contiguous_strides(shape),
                         x.storage_offset())


def cast(x, dtype):
    return as_tensor(x).to(dtype_mod.convert_dtype(dtype))


def _target_shape(x, shape):
    shp = int_list(shape)
    return [x.shape[i] if s == 0 and i < x.dim() else s
            for i, s in enumerate(shp)]


def reshape(x, shape, name=None):
    """``x`` in ``shape``; a 0 copies ``x``'s dimension at that place and
    one -1 is inferred."""
    x = as_tensor(x)
    return x.reshape(_target_shape(x, shape))


def reshape_(x, shape, name=None):
    return _reshape_in_place(x, reshape(x, shape).shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _reshape_in_place(x, flatten(x, start_axis, stop_axis).shape)


def transpose(x, perm, name=None):
    return as_tensor(x).permute(*int_list(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(as_tensor(x), tuple(int_list(source)),
                         tuple(int_list(destination)))


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(as_tensor(x), int(axis0), int(axis1))


def _squeeze_dims(x, axis):
    if axis is None:
        return tuple(i for i, s in enumerate(x.shape) if s == 1)
    return tuple(a % x.dim() for a in int_list(axis)
                 if x.shape[a % x.dim()] == 1)


def squeeze(x, axis=None, name=None):
    x = as_tensor(x)
    d = _squeeze_dims(x, axis)
    return x.squeeze(d) if d else x


def squeeze_(x, axis=None, name=None):
    for a in sorted(_squeeze_dims(x, axis), reverse=True):
        x.squeeze_(a)
    return x


def _unsqueeze_dims(x, axis):
    ax = int_list(axis)
    n = x.dim() + len(ax)
    return sorted(a % n for a in ax)


def unsqueeze(x, axis, name=None):
    x = as_tensor(x)
    for a in _unsqueeze_dims(x, axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze_(x, axis, name=None):
    for a in _unsqueeze_dims(x, axis):
        x.unsqueeze_(a)
    return x


def concat(x, axis=0, name=None):
    like = next((v for v in x if isinstance(v, torch.Tensor)), None)
    return torch.cat([as_tensor(v, like) for v in x], _axis(axis))


def stack(x, axis=0, name=None):
    like = next((v for v in x if isinstance(v, torch.Tensor)), None)
    return torch.stack(promote(*[as_tensor(v, like) for v in x]),
                       int(axis))


def split(x, num_or_sections, axis=0, name=None):
    x = as_tensor(x)
    ax = _axis(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        enforce(dim % num_or_sections == 0,
                f"cannot split axis of {dim} into {num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = int_list(num_or_sections)
        if -1 in sizes:
            known = builtins.sum(s for s in sizes if s != -1)
            sizes = [s if s != -1 else dim - known for s in sizes]
    return list(torch.split(x, sizes, ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(as_tensor(x), int(axis)))


unstack = unbind


def tile(x, repeat_times, name=None):
    return torch.tile(as_tensor(x), tuple(int_list(repeat_times)))


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape``; -1 keeps the input's dimension."""
    return as_tensor(x).expand(*int_list(shape))


def expand_as(x, y, name=None):
    return as_tensor(x).expand_as(as_tensor(y))


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(as_tensor(x), tuple(int_list(shape)))


def gather(x, index, axis=0, name=None):
    x = as_tensor(x)
    return torch.index_select(x, _axis(axis), as_tensor(index, x).reshape(-1))


def _index_tuple(index):
    return tuple(index[..., i] for i in range(index.shape[-1]))


def gather_nd(x, index, name=None):
    x = as_tensor(x)
    return x[_index_tuple(as_tensor(index, x))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (``overwrite``), or
    zeroed and then summed with the updates whose index names them."""
    x = as_tensor(x)
    idx = as_tensor(index, x).reshape(-1)
    upd = as_tensor(updates, x).to(x.dtype)
    if overwrite:
        return x.index_put((idx,), upd)
    return x.index_fill(0, idx, 0).index_add(0, idx, upd)


def scatter_(x, index, updates, overwrite=True):
    return x.copy_(scatter(x, index, updates, overwrite))


def scatter_nd(index, updates, shape, name=None):
    upd = as_tensor(updates)
    base = torch.zeros(tuple(int_list(shape)), dtype=upd.dtype,
                       device=upd.device)
    return base.index_put(_index_tuple(as_tensor(index, upd)), upd,
                          accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = as_tensor(x)
    return x.index_put(_index_tuple(as_tensor(index, x)),
                       as_tensor(updates, x).to(x.dtype), accumulate=True)


def slice(x, axes, starts, ends, name=None):
    x = as_tensor(x)
    idx = [_slice(None)] * x.dim()
    for ax, s, e in zip(int_list(axes), int_list(starts), int_list(ends)):
        idx[ax] = _slice(s, e)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """numpy's ``x[s:e:st]`` on each axis, negative strides too."""
    x = as_tensor(x)
    out = x
    for ax, s, e, st in zip(int_list(axes), int_list(starts),
                            int_list(ends), int_list(strides)):
        n = out.shape[ax]
        if st > 0:
            idx = [_slice(None)] * out.dim()
            idx[ax] = _slice(s, e, st)
            out = out[tuple(idx)]
        else:
            r = range(*_slice(s, e, st).indices(n))
            out = out.index_select(ax, torch.arange(
                r.start, r.stop, r.step, device=x.device))
    return out


def crop(x, shape=None, offsets=None, name=None):
    x = as_tensor(x)
    shp = int_list(shape) if shape is not None else list(x.shape)
    offs = int_list(offsets) if offsets is not None else [0] * x.dim()
    shp = [x.shape[i] - offs[i] if s == -1 else s for i, s in enumerate(shp)]
    out = x
    for ax, (o, s) in enumerate(zip(offs, shp)):
        out = out.narrow(ax, o, s)
    return out


def index_select(x, index, axis=0, name=None):
    x = as_tensor(x)
    return torch.index_select(x, int(axis), as_tensor(index, x).reshape(-1))


def index_sample(x, index):
    x = as_tensor(x)
    return torch.gather(x, 1, as_tensor(index, x))


def masked_select(x, mask, name=None):
    x = as_tensor(x)
    return x[as_tensor(mask, x).broadcast_to(x.shape)]


def masked_fill(x, mask, value, name=None):
    x = as_tensor(x)
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else (
        scalar_as(value, x).to(x.dtype))
    return torch.where(as_tensor(mask, x), v, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    cond = as_tensor(condition)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        return torch.where(cond, as_tensor(x, cond), as_tensor(y, cond))
    if not isinstance(x, torch.Tensor):
        x = scalar_as(x, y).to(y.dtype)
    if not isinstance(y, torch.Tensor):
        y = scalar_as(y, x).to(x.dtype)
    return torch.where(cond, x, y)


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(as_tensor(x))
    if as_tuple:
        return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
    return nz


def roll(x, shifts, axis=None, name=None):
    x = as_tensor(x)
    sh = int_list(shifts)
    if axis is None:
        return torch.roll(x, sh[0] if len(sh) == 1 else sh)
    return torch.roll(x, sh, int_list(axis))


def flip(x, axis, name=None):
    return torch.flip(as_tensor(x), int_list(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(as_tensor(x), k, list(axes))


def _first_index(inverse, n_unique, n):
    """Each unique value's first position, from the inverse map."""
    pos = torch.arange(n, device=inverse.device)
    first = torch.full((n_unique,), n, dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's ``unique``: the sorted unique values (rows, with ``axis``),
    their first positions, the inverse map (in ``x``'s shape when
    ``axis`` is None) and the counts."""
    x = as_tensor(x)
    idt = dtype_mod.convert_dtype(dtype) or torch.int64
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    outs = [vals]
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        outs.append(_first_index(inv, counts.shape[0], n).to(idt))
    if return_inverse:
        outs.append(inv.to(idt))
    if return_counts:
        outs.append(counts.to(idt))
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = as_tensor(x)
    idt = dtype_mod.convert_dtype(dtype) or torch.int64
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inv.to(idt))
    if return_counts:
        outs.append(counts.to(idt))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of an axis of ``n`` padded by (lo, hi)."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return pos.clamp(0, n - 1)
    if mode == "circular":
        return pos.remainder(n)
    if mode == "reflect":
        period = 2 * (n - 1) if n > 1 else 1
        p = pos.remainder(period)
        return torch.where(p < n, p, period - p)
    raise InvalidArgumentError(f"unknown pad mode {mode!r}")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad pairs over every axis (2·ndim values, first axis first), or
    over the trailing spatial axes from the last inward (``[left, right,
    top, bottom]`` pads W then H of NCHW)."""
    x = as_tensor(x)
    p = int_list(pad)
    nd = x.dim()
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        first = nd - 1 if data_format.startswith("NC") else nd - 2
        for j in range(len(p) // 2):
            width[first - j] = (p[2 * j], p[2 * j + 1])
    if mode == "constant":
        flat = []
        for lo, hi in reversed(width):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    out = x
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            out = out.index_select(ax, _pad_index(out.shape[ax], lo, hi,
                                                  mode, x.device))
    return out


def repeat_interleave(x, repeats, axis=None, name=None):
    x = as_tensor(x)
    if isinstance(repeats, torch.Tensor):
        return torch.repeat_interleave(x, repeats.to(x.device), dim=axis)
    return torch.repeat_interleave(x, int(repeats), dim=axis)


def take_along_axis(arr, indices, axis, name=None):
    """``indices`` broadcast against ``arr`` on every other axis."""
    arr = as_tensor(arr)
    idx = as_tensor(indices, arr)
    tgt = list(arr.shape)
    tgt[axis] = idx.shape[axis]
    return torch.gather(arr, axis, idx.broadcast_to(tgt))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = as_tensor(arr)
    idx = as_tensor(indices, arr)
    v = values.to(arr.dtype) if isinstance(values, torch.Tensor) else (
        scalar_as(values, arr).to(arr.dtype))
    v = v.broadcast_to(idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, v)
    if reduce == "add":
        return arr.scatter_add(axis, idx, v)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, idx, v, "prod")
    raise InvalidArgumentError(f"unknown reduce mode {reduce!r}")


def tensordot(x, y, axes=2, name=None):
    a, b = promote(as_tensor(x), as_tensor(y, x))
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    return torch.tensordot(a, b, dims=axes)


def as_complex(x, name=None):
    x = as_tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = as_tensor(x)
    return torch.stack([x.real, x.imag], -1)


def tolist(x):
    return as_tensor(x).tolist()


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """An id's index inside shard ``shard_id`` of ``nshards`` equal
    shards of ``index_num`` ids, ``ignore_value`` for ids of other
    shards."""
    t = as_tensor(input)
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(t, size, rounding_mode="floor") == shard_id,
                       t.remainder(size), scalar_as(ignore_value, t))


def multiplex(inputs, index, name=None):
    """``out[i] = inputs[index[i]][i]``. An index out of range raises (it
    is read on the host, as the reference reads it)."""
    enforce(len(inputs) >= 2, "multiplex needs at least 2 input tensors")
    ts = [as_tensor(x) for x in inputs]
    ix = as_tensor(index, ts[0]).reshape(-1).to(torch.int64)
    lo, hi = torch.aminmax(ix) if ix.numel() else (0, 0)
    enforce(ix.numel() == 0 or (0 <= int(lo) and int(hi) < len(ts)),
            f"multiplex: index out of range [0, {len(ts)})")
    stacked = torch.stack(promote(*ts), 0)
    rows = torch.arange(stacked.shape[1], device=ix.device)
    return stacked[ix, rows]


# fluid-era alias of ``flip``
reverse = flip
__all__.append("reverse")
