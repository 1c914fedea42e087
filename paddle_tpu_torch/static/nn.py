"""``static.nn`` — functional layers that make their parameters as they
are called, counterpart of ``paddle_tpu.static.nn``.

Each function makes its parameters from a ``ParamAttr`` (an initializer,
a name, a learning-rate scale, a regularizer, trainable or not) on its
input's device, then calls the port's functional op, so inside
``program_guard`` the op is recorded and the parameters join the program
at their first use. Ported: ``fc``, ``conv2d``, ``conv2d_transpose``,
``conv3d``, ``conv3d_transpose``, ``batch_norm``, ``embedding``,
``layer_norm``, ``prelu``, ``create_parameter``, ``data_norm``,
``py_func``, ``bilinear_tensor_product``, ``conv_shift`` and the
control-flow re-exports. The others need functions the port lacks and
raise ``NotImplementedError`` naming what they wait for.

``batch_norm`` updates fresh running statistics once, at record time, and
not at replay, as the reference's does; ``data_norm``'s summaries persist
across runs through ``Program.buffer_updates`` (committed after each
optimized run).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from ..core import recording
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import linear
from ..nn.param_attr import ParamAttr
from ..ops.fused import fused_layer_norm
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .program import convert_dtype, current_program, set_param_name

__all__ = ["fc", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "batch_norm", "embedding", "layer_norm", "prelu",
           "create_parameter", "data_norm", "py_func",
           "bilinear_tensor_product", "conv_shift", "cond", "case",
           "switch_case", "while_loop"]

# static.nn functions that wait for a module the port lacks (ROADMAP
# Queue 1) -> what they wait for
_NOT_PORTED = {
    "group_norm": "nn/functional/norm.py's group_norm (Queue 1 item 5.3)",
    "instance_norm": "nn/functional/norm.py's instance_norm (Queue 1 item "
                     "5.3)",
    "spectral_norm": "the spectral norm of nn/ (Queue 1 item 5.3)",
    "deform_conv2d": "vision/ops.py (Queue 1 item 5.5)",
    "multi_box_head": "vision/ops.py's prior_box (Queue 1 item 5.5)",
    "nce": "the sampled losses of nn/ (Queue 1 item 5.3)",
    "row_conv": "nn/functional/common.py's pad (Queue 1 item 5.3)",
    "sequence_conv": "tensor/sequence.py (Queue 1 item 5.4)",
    "sequence_reshape": "tensor/sequence.py (Queue 1 item 5.4)",
    "sequence_scatter": "tensor/sequence.py (Queue 1 item 5.4)",
    "crf_decoding": "text/crf.py (Queue 1 item 5.5)",
    "sparse_embedding": "row-sparse gradients and core/selected_rows.py "
                        "(Queue 1 item 5.2)",
}
for _name in ("concat", "enumerate", "expand", "expand_as", "first_step",
              "last_step", "pad", "pool", "reverse", "slice", "softmax",
              "unpad"):
    _NOT_PORTED["sequence_" + _name] = "tensor/sequence.py (Queue 1 item 5.4)"


def __getattr__(name):
    if name in _NOT_PORTED:
        def not_ported(*args, **kwargs):
            raise NotImplementedError(
                f"static.nn.{name} is not ported yet: it needs "
                f"{_NOT_PORTED[name]}")
        return not_ported
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _make_param(shape, attr, is_bias, dtype="float32", device=None):
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or (I.Constant(0.0) if is_bias
                                else I.XavierUniform())
    p = nn.Parameter(init(shape, convert_dtype(dtype), device),
                     requires_grad=bool(attr.trainable))
    if attr.name:
        set_param_name(p, attr.name)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.trainable = bool(attr.trainable)
    return p


def _make_scale_param(shape, attr, default_value, device):
    """Scales default to a constant (1 for norm scales, 0.25 for prelu's
    alpha) when the attr names no initializer; the caller's attr is not
    changed."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    if attr.initializer is None:
        attr = copy.copy(attr)
        attr.initializer = I.Constant(default_value)
    return _make_param(shape, attr, False, device=device)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, device=None):
    """A parameter of ``shape`` (on ``device``, default the card)."""
    from ..core.place import resolve_device

    attr = ParamAttr._to_attr(attr)
    if default_initializer is not None and attr is not False:
        attr = copy.copy(attr)
        attr.initializer = default_initializer
    p = _make_param(list(shape), attr, is_bias, dtype,
                    resolve_device(device))
    if name and p is not None and not getattr(attr, "name", None):
        set_param_name(p, name)
    return p


def _act(out, act):
    return getattr(F, act)(out) if act else out


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, (int, np.integer)) else tuple(
        int(i) for i in v)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """``x`` (its dims after ``num_flatten_dims`` flattened) times a
    [in, size] weight, plus a bias, then ``activation``."""
    if x.dim() > num_flatten_dims + 1:
        x = torch.flatten(x, num_flatten_dims)
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = _make_param([in_dim, size], weight_attr, False, device=x.device)
    b = _make_param([size], bias_attr, True, device=x.device)
    return _act(linear(x, w, b), activation)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    ksize = list(_ntuple(filter_size, 2))
    in_c = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w = _make_param([num_filters, in_c // groups] + ksize, param_attr, False,
                    device=input.device)
    b = _make_param([num_filters], bias_attr, True, device=input.device)
    out = F.conv2d(input, w, b, stride, padding, dilation, groups,
                   data_format)
    return _act(out, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    """Weight [C_in, num_filters / groups, kh, kw]."""
    c_in = input.shape[1 if data_format.startswith("NC") else -1]
    if filter_size is None:
        raise ValueError("filter_size is required (output_size-only shape "
                         "inference: pass filter_size explicitly)")
    kh, kw = _ntuple(filter_size, 2)
    w = _make_param([c_in, num_filters // groups, kh, kw], param_attr, False,
                    device=input.device)
    b = _make_param([num_filters], bias_attr, True, device=input.device)
    out = F.conv2d_transpose(input, w, b, stride=stride, padding=padding,
                             groups=groups, dilation=dilation,
                             output_size=output_size,
                             data_format=data_format)
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCDHW"):
    c_in = input.shape[1 if data_format.startswith("NC") else -1]
    w = _make_param([num_filters, c_in // groups, *_ntuple(filter_size, 3)],
                    param_attr, False, device=input.device)
    b = _make_param([num_filters], bias_attr, True, device=input.device)
    out = F.conv3d(input, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    c_in = input.shape[1 if data_format.startswith("NC") else -1]
    if filter_size is None:
        raise ValueError("filter_size is required")
    w = _make_param([c_in, num_filters // groups, *_ntuple(filter_size, 3)],
                    param_attr, False, device=input.device)
    b = _make_param([num_filters], bias_attr, True, device=input.device)
    out = F.conv3d_transpose(input, w, b, stride=stride, padding=padding,
                             groups=groups, dilation=dilation,
                             output_size=output_size,
                             data_format=data_format)
    return _act(out, act)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-05, param_attr=None,
               bias_attr=None, data_layout="NCHW", is_test=False, name=None,
               moving_mean_name=None, moving_variance_name=None, **kw):
    """BatchNorm with a fresh scale (ones unless ``param_attr``), bias and
    running statistics (zeros, ones: updated at record time only)."""
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = _make_param([c], param_attr, False, device=input.device)
    if scale is not None and param_attr is None:
        with torch.no_grad():
            scale.fill_(1.0)
    bias = _make_param([c], bias_attr, True, device=input.device)
    mean = torch.zeros(c, dtype=torch.float32, device=input.device)
    var = torch.ones(c, dtype=torch.float32, device=input.device)
    out = F.batch_norm(input, mean, var, scale, bias, training=not is_test,
                       momentum=momentum, epsilon=epsilon,
                       data_format=data_layout)
    return _act(out, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """Rows of a [size[0], size[1]] weight; ids equal to ``padding_idx``
    give zeros."""
    if is_sparse:
        raise NotImplementedError("row-sparse gradients are not ported yet "
                                  "(is_sparse=True)")
    w = _make_param(list(size), param_attr, False, dtype, input.device)
    out = TF.embedding(input, w)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (input != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Normalize over the dims from ``begin_norm_axis`` on, through the
    LayerNorm kernel (``ops.fused.fused_layer_norm``) over those dims
    flattened; scale and shift have their shape."""
    norm_shape = [int(s) for s in input.shape[begin_norm_axis:]]
    hidden = int(np.prod(norm_shape))
    dev, dt = input.device, input.dtype
    w = _make_scale_param(norm_shape, param_attr, 1.0, dev) if scale \
        else None
    b = _make_param(norm_shape, bias_attr, True, device=dev) if shift \
        else None
    flat = lambda p: p if p.dim() == 1 else p.reshape(-1)
    wf = flat(w).to(dt) if w is not None else torch.ones(hidden, dtype=dt,
                                                         device=dev)
    bf = flat(b).to(dt) if b is not None else torch.zeros(hidden, dtype=dt,
                                                          device=dev)
    x = input if input.dim() == begin_norm_axis + 1 else torch.flatten(
        input, begin_norm_axis)
    out = fused_layer_norm(x, wf, bf, epsilon)
    if x is not input:
        out = out.view_as(input)
    return _act(out, act)


def prelu(x, mode, param_attr=None, data_format="NCHW", name=None):
    """``mode`` 'all', 'channel' or 'element' sizes the alpha (0.25)."""
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1 if data_format.startswith("NC") else -1]]
    elif mode == "element":
        shape = list(x.shape[1:])
    else:
        raise ValueError(f"unknown prelu mode {mode!r}")
    alpha = _make_scale_param(shape, param_attr, 0.25, x.device)
    if mode == "element":
        return torch.where(x > 0, x, alpha * x)
    return F.prelu(x, alpha, data_format=data_format)


# ---------------------------------------------------------------------------
# data_norm: summaries that persist through Program.buffer_updates
# ---------------------------------------------------------------------------
def _dn_norm(x, n, s, sq, eps):
    return (x - s / n) / torch.sqrt(torch.clamp(sq / n, min=eps))


def _dn_norm_affine(x, n, s, sq, w, b, eps):
    return _dn_norm(x, n, s, sq, eps) * w + b


def _dn_size(x, n, r):
    return r * n + float(x.shape[0])


def _dn_sum(x, s, r):
    return r * s + x.sum(dim=tuple(range(x.dim() - 1))).float()


def _dn_sqsum(x, sq, r):
    return r * sq + (x * x).sum(dim=tuple(range(x.dim() - 1))).float()


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """CTR data normalization: ``(x - sum/size) / sqrt(square_sum/size)``
    over the last axis, with the batch size, sum and square sum kept as
    untrained parameters (1e4, 0, 1e4 at first) and decayed by
    ``summary_decay_rate`` as each batch adds to them; optionally a
    learnable scale and shift. Each of the reference's ops is one op here
    (``record_opaque``), so the batch size is the run's."""
    d = int(input.shape[-1])
    dev = input.device
    stats = []
    for value in (1e4, 0.0, 1e4):
        p = _make_param([d], ParamAttr(initializer=I.Constant(value),
                                       trainable=False), True, device=dev)
        stats.append(p)
    size, ssum, sqsum = stats
    eps = float(epsilon)
    if enable_scale_and_shift:
        scale_w = _make_scale_param([d], param_attr, 1.0, dev)
        bias_p = _make_param([d], param_attr, True, device=dev)
        out = recording.record_opaque(_dn_norm_affine, input, size, ssum,
                                      sqsum, scale_w, bias_p, eps)
    else:
        out = recording.record_opaque(_dn_norm, input, size, ssum, sqsum,
                                      eps)
    r = float(summary_decay_rate)
    new = [recording.record_opaque(fn, input, p, r)
           for fn, p in ((_dn_size, size), (_dn_sum, ssum),
                         (_dn_sqsum, sqsum))]
    prog = current_program()
    if prog is not None and recording.active() is not None:
        for p, v in zip(stats, new):
            prog.buffer_updates[id(p)] = id(v)
    else:
        with torch.no_grad():
            for p, v in zip(stats, new):
                p.copy_(v)
    return _act(out, act)


# ---------------------------------------------------------------------------
# py_func: host Python as an op
# ---------------------------------------------------------------------------
def _to_host(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, backward_func, skip, dtypes, n_x, *tensors):
        xs = tensors[:n_x]
        res = func(*[_to_host(x) for x in xs])
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        dev = xs[0].device if xs else torch.device("cpu")
        outs = tuple(torch.as_tensor(np.asarray(r), device=dev).to(dt)
                     for r, dt in zip(res, dtypes))
        ctx.backward_func, ctx.skip = backward_func, skip
        ctx.save_for_backward(*xs, *outs)
        ctx.n_x = n_x
        if backward_func is None:
            ctx.mark_non_differentiable(*outs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_x], saved[ctx.n_x:]
        skip = ctx.skip
        binputs = [_to_host(x) for i, x in enumerate(xs)
                   if ("x", i) not in skip]
        binputs += [_to_host(o) for i, o in enumerate(outs)
                    if ("out", i) not in skip]
        binputs += [_to_host(g) for g in gs]
        res = ctx.backward_func(*binputs)
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        res += [None] * (len(xs) - len(res))
        dx = tuple(None if r is None else torch.as_tensor(
            np.asarray(r), device=x.device).to(x.dtype)
            for r, x in zip(res, xs))
        return (None, None, None, None, None, *dx)


def _alias(v):
    """An op binding a declared output variable to a computed value."""
    return (v,)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run the host function ``func`` on numpy copies of ``x`` as one op;
    ``out`` (a tensor or a list) declares the outputs' dtypes. With
    ``backward_func`` the op has a gradient: it is called with the inputs,
    the outputs and the output gradients (less
    ``skip_vars_in_backward_input``) and returns the inputs' gradients
    (None for none). Inside ``program_guard`` the declared ``out``
    variables are bound to the op's results, so later ops read them."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    skip_list = skip_vars_in_backward_input
    skip_list = ([] if skip_list is None else list(skip_list)
                 if isinstance(skip_list, (list, tuple)) else [skip_list])
    skip_ids = {id(v) for v in skip_list}
    skip = frozenset([("x", i) for i, v in enumerate(xs)
                      if id(v) in skip_ids]
                     + [("out", i) for i, v in enumerate(outs)
                        if id(v) in skip_ids])
    dtypes = tuple(o.dtype for o in outs)
    result = recording.record_opaque(_PyFunc.apply, func, backward_func,
                                     skip, dtypes, len(xs), *xs)
    results = list(result) if isinstance(result, tuple) else [result]
    rec = recording.active()
    if rec is not None and not rec.quiet:
        for o, r in zip(outs, results):
            rec.record_op(_alias, [r], [o], "py_func_alias")
        return out
    with torch.no_grad():
        for o, r in zip(outs, results):
            if tuple(o.shape) == tuple(r.shape):
                o.copy_(r)
    return results if isinstance(out, (list, tuple)) else results[0]


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    """``out[:, k] = x · W[k] · yᵀ + b[k]``: W [size, M, N], b [1, size]."""
    m, n = int(x.shape[-1]), int(y.shape[-1])
    w = _make_param([size, m, n], param_attr, False, device=x.device)
    b = _make_param([1, size], bias_attr, True, device=x.device)
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    if b is not None:
        out = out + b
    return _act(out, act)


def conv_shift(x, y, name=None):
    """Circular correlation of batched vectors:
    ``out[b, i] = Σ_j x[b, (i + j − (N−1)/2) mod M] · y[b, j]`` for x [B, M]
    and y [B, N], N odd and at most M."""
    M, N = int(x.shape[-1]), int(y.shape[-1])
    if N % 2 != 1:
        raise ValueError("conv_shift: y width must be odd")
    if N > M:
        raise ValueError("conv_shift: y wider than x")
    half = (N - 1) // 2
    idx = torch.as_tensor(
        (np.arange(M)[:, None] + np.arange(N)[None, :] - half) % M,
        device=x.device)
    return torch.einsum("bmn,bn->bm", x[:, idx], y)
