"""Elementwise and reduction math — counterpart of
``paddle_tpu.tensor.math``.

Plain functions on torch tensors with the reference's argument names
(``axis``, ``keepdim``) and rules: a Python scalar takes the tensor's
dtype family, ``floor_divide`` and ``mod`` floor toward -inf (the sign of
``mod`` follows the divisor), the matmul family promotes mixed dtypes as
jnp does, and the division of two integer tensors gives the default float
dtype (the reference's jnp gives float64 under its x64 setting). The
in-place variants (``add_``, ``clip_``, ...) write the result into their
first argument and return it.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ._util import as_tensor, axes, dims, pair, promote, to_float

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "remainder",
    "floor_mod", "pow", "sqrt", "rsqrt", "exp", "expm1", "log", "log2", "log10", "log1p",
    "abs", "ceil", "floor", "round", "trunc", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "hypot", "logaddexp", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "sigmoid", "square", "reciprocal", "sign", "neg", "maximum", "minimum",
    "fmax", "fmin", "sum", "nansum", "mean", "nanmean", "max", "min", "amax",
    "amin", "prod", "cumsum", "cumprod", "cummax", "cummin", "clip", "erf",
    "erfinv", "lerp", "isnan", "isinf", "isfinite", "nan_to_num", "logsumexp",
    "all", "any", "matmul", "mm", "bmm", "inner", "outer", "dot", "addmm",
    "logit", "multiply_", "add_n", "kron", "diff", "rad2deg", "deg2rad",
    "gcd", "lcm", "frac", "angle", "heaviside", "trace", "digamma", "lgamma",
    "stanh", "softplus", "increment", "scale", "count_nonzero", "broadcast_shape",
    "log_softmax_",
]


# -- binary -----------------------------------------------------------------
def _binary(fn, same_dtype=False):
    def op(x, y, name=None):
        a, b = pair(x, y)
        if same_dtype:
            a, b = promote(a, b)
        return fn(a, b)

    return op


add = _binary(torch.add)
subtract = _binary(torch.sub)
multiply = _binary(torch.mul)
floor_divide = _binary(lambda a, b: torch.div(a, b, rounding_mode="floor"))
mod = _binary(torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary(torch.pow)
maximum = _binary(torch.maximum, True)
minimum = _binary(torch.minimum, True)
fmax = _binary(torch.fmax, True)
fmin = _binary(torch.fmin, True)
atan2 = _binary(lambda a, b: torch.atan2(*promote(to_float(a), b)))
hypot = _binary(lambda a, b: torch.hypot(*promote(to_float(a), b)))
logaddexp = _binary(lambda a, b: torch.logaddexp(*promote(to_float(a), b)))
gcd = _binary(torch.gcd, True)
lcm = _binary(torch.lcm, True)
heaviside = _binary(torch.heaviside, True)
kron = _binary(torch.kron, True)


def divide(x, y, name=None):
    a, b = pair(x, y)
    if not (a.is_floating_point() or a.is_complex() or b.is_floating_point()
            or b.is_complex()):
        a = a.to(dtype_mod.get_default_dtype())
    return torch.true_divide(a, b)


# -- unary ------------------------------------------------------------------
def _unary(fn, floats=True):
    def op(x, name=None):
        t = as_tensor(x)
        return fn(to_float(t) if floats else t)

    return op


sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
abs = _unary(torch.abs, False)
ceil = _unary(torch.ceil, False)
floor = _unary(torch.floor, False)
round = _unary(torch.round, False)
trunc = _unary(torch.trunc, False)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
sigmoid = _unary(torch.sigmoid)
square = _unary(torch.square, False)
reciprocal = _unary(torch.reciprocal)
sign = _unary(torch.sign, False)
neg = _unary(torch.neg, False)
erf = _unary(torch.erf)
erfinv = _unary(torch.erfinv)
digamma = _unary(torch.digamma)
lgamma = _unary(torch.lgamma)
isnan = _unary(torch.isnan, False)
isinf = _unary(torch.isinf, False)
isfinite = _unary(torch.isfinite, False)
frac = _unary(torch.frac, False)
angle = _unary(torch.angle)
rad2deg = _unary(torch.rad2deg)
deg2rad = _unary(torch.deg2rad)


def logit(x, eps=None, name=None):
    return torch.logit(to_float(as_tensor(x)), eps)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * as_tensor(x))


def softplus(x, beta=1, threshold=20, name=None):
    return torch.nn.functional.softplus(as_tensor(x), beta, threshold)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(as_tensor(x), nan, posinf, neginf)


def lerp(x, y, weight, name=None):
    a, b = promote(*pair(x, y))
    if isinstance(weight, torch.Tensor):
        return a + weight.to(a.dtype) * (b - a)
    return a + weight * (b - a)


def _bound(v, t):
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(t.dtype) if v.numel() == 1 else v.to(t.dtype)
    return v


def clip(x, min=None, max=None, name=None):
    t = as_tensor(x)
    lo, hi = _bound(min, t), _bound(max, t)
    if lo is None and hi is None:
        return t.clone()
    return torch.clamp(t, lo, hi)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    t = as_tensor(x)
    if isinstance(scale, torch.Tensor):
        scale = scale.to(t.dtype)
    out = t * scale + bias if bias_after_scale else (t + bias) * scale
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    return x.add_(value)


# -- reductions -------------------------------------------------------------
def _cast(t, dtype):
    d = dtype_mod.convert_dtype(dtype)
    return t if d is None else t.to(d)


def _reduction(fn, floats=False, counts=False):
    """A reduction over ``axis`` (an int, a list, a tensor, or None for
    every axis; ``keepdim`` keeps a 1 for each), in ``dtype`` when given;
    ``floats``: an integer input in the default float dtype; ``counts``:
    a bool input as int64."""
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        t = _cast(as_tensor(x), dtype)
        if floats:
            t = to_float(t)
        elif counts and t.dtype == torch.bool:
            t = t.to(torch.int64)
        d = axes(axis)
        return fn(t, dim=tuple(range(t.dim())) if d is None else d,
                  keepdim=keepdim)

    return op


sum = _reduction(torch.sum, counts=True)
nansum = _reduction(torch.nansum, counts=True)
mean = _reduction(torch.mean, floats=True)
nanmean = _reduction(torch.nanmean, floats=True)
amax = _reduction(torch.amax)
amin = _reduction(torch.amin)
logsumexp = _reduction(torch.logsumexp, floats=True)
all = _reduction(torch.all)
any = _reduction(torch.any)


class _Prod(torch.autograd.Function):
    """The product over one axis, whose gradient is each element's
    product of the others, from exclusive products on either side: exact
    with zeros, and no host read (torch's own backward asks the host
    whether the input holds a zero)."""

    @staticmethod
    def forward(ctx, x, dim, keepdim):
        ctx.save_for_backward(x)
        ctx.dim, ctx.keepdim = dim, keepdim
        return torch.prod(x, dim=dim, keepdim=keepdim)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = ctx.dim
        one = torch.ones_like(x.narrow(d, 0, 1))
        left = torch.cat([one, x.narrow(d, 0, x.shape[d] - 1)], d)
        right = torch.cat([x.narrow(d, 1, x.shape[d] - 1), one], d)
        others = (torch.cumprod(left, d)
                  * torch.cumprod(right.flip(d), d).flip(d))
        if not ctx.keepdim:
            g = g.unsqueeze(d)
        return g * others, None, None


def _prod(t, dim, keepdim):
    if t.requires_grad and (t.is_floating_point() or t.is_complex()):
        return _Prod.apply(t, dim, keepdim)
    return torch.prod(t, dim=dim, keepdim=keepdim)


def prod(x, axis=None, keepdim=False, name=None, dtype=None):
    t = _cast(as_tensor(x), dtype)
    if t.dtype == torch.bool:
        t = t.to(torch.int64)
    d = axes(axis)
    if d is None:
        out = _prod(t.reshape(-1), 0, False)
        return out.reshape((1,) * t.dim()) if keepdim else out
    out = t
    for a in sorted(dims(d, t.dim()), reverse=True):
        out = _prod(out, a, keepdim)
    return out


def max(x, axis=None, keepdim=False, name=None):
    return amax(x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return amin(x, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return sum(as_tensor(x) != 0, axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    t = _cast(as_tensor(x), dtype)
    if axis is None:
        return torch.cumsum(t.reshape(-1), 0)
    return torch.cumsum(t, int(axis))


def _shift(t, d, s, fill):
    """``t`` moved ``s`` (< its length) places toward the start of axis
    ``d``, the end filled with ``fill``."""
    pad = torch.full_like(t.narrow(d, 0, s), fill)
    return torch.cat([t.narrow(d, s, t.shape[d] - s), pad], d)


class _Cumprod(torch.autograd.Function):
    """The running product along one axis. Its gradient at k is
    ``E_k · S_k``: E the product before k, and S the reverse recurrence
    ``S_k = g_k + x_{k+1} · S_{k+1}``, solved in log2(n) doubling steps
    of (A, B) pairs. Exact with zeros, and no host read (torch's own
    backward asks the host whether the input holds a zero)."""

    @staticmethod
    def forward(ctx, x, d):
        ctx.save_for_backward(x)
        ctx.d = d
        return torch.cumprod(x, d)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d, n = ctx.d, x.shape[ctx.d]
        one = torch.ones_like(x.narrow(d, 0, 1))
        before = torch.cumprod(
            torch.cat([one, x.narrow(d, 0, n - 1)], d), d)
        a, b = _shift(x, d, 1, 0), g
        s = 1
        while s < n:
            a, b = a * _shift(a, d, s, 1), b + a * _shift(b, d, s, 0)
            s *= 2
        return before * b, None


def cumprod(x, dim=None, dtype=None, name=None):
    t = _cast(as_tensor(x), dtype)
    if dim is None:
        t, dim = t.reshape(-1), 0
    d = int(dim) % (t.dim() or 1)
    if t.requires_grad and t.shape[d] > 1 and (t.is_floating_point()
                                                or t.is_complex()):
        return _Cumprod.apply(t, d)
    return torch.cumprod(t, d)


def _cum_extreme(fn):
    def op(x, axis=None, dtype="int64", name=None):
        t = as_tensor(x)
        if axis is None:
            t, axis = t.reshape(-1), 0
        vals, idx = fn(t, int(axis))
        return vals, idx.to(dtype_mod.convert_dtype(dtype) or torch.int64)

    return op


# ties: the running extreme's index is its latest occurrence, as the
# reference's (and torch's) cummax / cummin give it
cummax = _cum_extreme(torch.cummax)
cummin = _cum_extreme(torch.cummin)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    t = as_tensor(x)
    pre = as_tensor(prepend, t) if prepend is not None else None
    app = as_tensor(append, t) if append is not None else None
    return torch.diff(t, n, int(axis), pre, app)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(as_tensor(x), offset, axis1, axis2).sum(-1)


# -- matmul family ----------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    from ..amp.auto_cast import maybe_cast_inputs

    a, b = promote(*pair(x, y))
    a, b = maybe_cast_inputs("matmul", a, b)
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return torch.matmul(*promote(*pair(x, y)))


def inner(x, y, name=None):
    return torch.inner(*promote(*pair(x, y)))


def outer(x, y, name=None):
    a, b = promote(*pair(x, y))
    return torch.outer(a.reshape(-1), b.reshape(-1))


def dot(x, y, name=None):
    a, b = promote(*pair(x, y))
    return (a * b).sum(-1)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = promote(as_tensor(input), *pair(x, y))
    return beta * i + alpha * torch.matmul(a, b)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    out = as_tensor(inputs[0])
    for v in inputs[1:]:
        out = out + as_tensor(v, out)
    return out


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


# -- in place ---------------------------------------------------------------
def _write(x, value):
    """``value`` written into ``x`` (recorded by autograd); returns
    ``x``. Torch's rule holds: a leaf that requires grad cannot be
    written in place."""
    return x.copy_(value)


def multiply_(x, y):
    return _write(x, multiply(x, y))


def log_softmax_(x, axis=-1):
    out = torch.log_softmax(as_tensor(x), axis)
    return _write(x, out) if isinstance(x, torch.Tensor) else out


def _inplace(fn, name):
    def g(x, *args, **kwargs):
        return _write(x, fn(x, *args, **kwargs))

    g.__name__ = g.__qualname__ = name + "_"
    g.__doc__ = f"``{name}`` written into its first argument."
    return g


exp_ = _inplace(exp, "exp")
sqrt_ = _inplace(sqrt, "sqrt")
rsqrt_ = _inplace(rsqrt, "rsqrt")
ceil_ = _inplace(ceil, "ceil")
floor_ = _inplace(floor, "floor")
round_ = _inplace(round, "round")
reciprocal_ = _inplace(reciprocal, "reciprocal")
tanh_ = _inplace(tanh, "tanh")
clip_ = _inplace(clip, "clip")
scale_ = _inplace(scale, "scale")
add_ = _inplace(add, "add")
subtract_ = _inplace(subtract, "subtract")

__all__ += ["exp_", "sqrt_", "rsqrt_", "ceil_", "floor_", "round_",
            "reciprocal_", "tanh_", "clip_", "scale_", "add_", "subtract_",
            "inverse"]


def inverse(x, name=None):
    """``linalg.inv``, exported at the top level."""
    from .linalg import inv

    return inv(x, name=name)

