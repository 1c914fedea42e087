"""``static.nn`` — functional layers that make their parameters as they
are called, counterpart of ``paddle_tpu.static.nn``.

Each function makes its parameters from a ``ParamAttr`` (an initializer,
a name, a learning-rate scale, a regularizer, trainable or not) on its
input's device, then calls the port's functional op, so inside
``program_guard`` the op is recorded and the parameters join the program
at their first use. Ported: ``fc``, ``conv2d``, ``conv2d_transpose``,
``conv3d``, ``conv3d_transpose``, ``batch_norm``, ``embedding``,
``sparse_embedding``, ``row_conv``,
``layer_norm``, ``group_norm``, ``instance_norm``, ``spectral_norm``,
``nce``, ``prelu``, ``create_parameter``, ``data_norm``, ``py_func``,
``bilinear_tensor_product``, ``conv_shift``, the ``sequence_*``
functions (``sequence_conv``, ``sequence_reshape`` and
``sequence_scatter`` here, the rest from ``tensor.sequence``), the
detection and tagging heads (``multi_box_head``, ``deform_conv2d`` over
``vision.ops``, ``crf_decoding`` over ``text.crf``) and the control-flow
re-exports: every name of the reference's ``static.nn``.

``batch_norm`` updates fresh running statistics once, at record time, and
not at replay, as the reference's does; ``nce`` draws its negative
classes once, at build time, from ``np.random.RandomState(seed)``, as the
reference does, so one seed gives both packages the same negatives; ``data_norm``'s summaries persist
across runs through ``Program.buffer_updates`` (committed after each
optimized run).
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ..core import recording
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import linear
from ..nn.layer_base import create_parameter as _create_parameter
from ..nn.param_attr import ParamAttr
from ..ops.fused import fused_layer_norm
from ..tensor.sequence import (sequence_concat,  # noqa: F401
                               sequence_enumerate, sequence_expand,
                               sequence_expand_as, sequence_first_step,
                               sequence_last_step, sequence_pad,
                               sequence_pool, sequence_reverse,
                               sequence_slice, sequence_softmax,
                               sequence_unpad)
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .program import convert_dtype, current_program, set_param_name

__all__ = ["fc", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "batch_norm", "embedding", "sparse_embedding", "layer_norm",
           "group_norm", "instance_norm", "spectral_norm", "nce",
           "prelu", "row_conv",
           "create_parameter", "data_norm", "py_func",
           "bilinear_tensor_product", "conv_shift", "cond", "case",
           "switch_case", "while_loop", "sequence_conv", "sequence_reshape",
           "sequence_scatter", "sequence_concat", "sequence_enumerate",
           "sequence_expand", "sequence_expand_as", "sequence_first_step",
           "sequence_last_step", "sequence_pad", "sequence_pool",
           "sequence_reverse", "sequence_slice", "sequence_softmax",
           "sequence_unpad", "crf_decoding", "multi_box_head",
           "deform_conv2d"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _make_param(shape, attr, is_bias, dtype="float32", device=None):
    return _create_parameter(shape, attr, convert_dtype(dtype), is_bias,
                             device=device)


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
    """Rows of a [size[0], size[1]] weight (``nn.functional.embedding``);
    ids equal to ``padding_idx`` give zeros. ``is_sparse`` gives the
    weight row-sparse gradients, which the Executor densifies before its
    update, as the reference's traced step has dense ones."""
    w = _make_param(list(size), param_attr, False, dtype, input.device)
    return F.embedding(input, w, padding_idx=padding_idx, sparse=is_sparse)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution of [N, T, D]: ``out[t] = Σ_{i=0..k}
    w[i] · x[t+i]`` with weight [k+1, D], zeros past the sequence's end."""
    d, k = int(input.shape[-1]), int(future_context_size)
    w = _make_param([k + 1, d], param_attr, False, device=input.device)
    out = 0.0
    for i in range(k + 1):
        out = out + F.pad(input[:, i:, :], [0, 0, 0, i, 0, 0]) * w[i]
    return _act(out, act)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """Context-window convolution over time of [N, T, D]: the window of
    ``filter_size`` steps from ``padding_start`` (default
    ``-(filter_size - 1) // 2``), zeros outside the sequence, then one
    [filter_size·D, num_filters] matmul."""
    d, fs = int(input.shape[-1]), int(filter_size)
    start = -((fs - 1) // 2) if padding_start is None else int(padding_start)
    w = _make_param([fs * d, num_filters], param_attr, False,
                    device=input.device)
    b = _make_param([num_filters], bias_attr, True, device=input.device)
    t = input.shape[1]
    cols = []
    for i in range(fs):
        off = start + i
        if off < 0:
            k = min(-off, t)
            cols.append(F.pad(input[:, :t - k, :], [0, 0, k, 0, 0, 0]))
        else:
            k = min(off, t)
            cols.append(F.pad(input[:, k:, :], [0, 0, 0, k, 0, 0]))
    out = torch.cat(cols, -1) @ w
    if b is not None:
        out = out + b
    return _act(out, act)


def sequence_reshape(input, new_dim):
    """[N, T, D] -> [N, T·D / new_dim, new_dim] (N is not read: a Program
    replays it at any batch)."""
    steps = input.shape[1] * input.shape[2] // int(new_dim)
    return input.reshape(-1, steps, int(new_dim))


def sequence_scatter(input, index, updates):
    """``updates`` added into ``input`` at the per-row positions
    ``index`` (index and updates [N, L])."""
    # row numbers made from ``index`` itself, not from a recorded size: a
    # Program replays this at any batch
    rows = torch.ones_like(index[:, :1]).cumsum(0) - 1
    return input.index_put((rows, index.long()), updates.to(input.dtype),
                           accumulate=True)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, param_attr=None, dtype="float32"):
    """``embedding(is_sparse=True)`` (the reference's contrib
    ``sparse_embedding``); ``entry``, a parameter-server admission policy,
    is taken and not used."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


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


def group_norm(input, groups, epsilon=1e-05, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    """``F.group_norm`` with a fresh [C] scale (ones unless
    ``param_attr``) and bias."""
    c = input.shape[1 if data_layout.startswith("NC") else -1]
    w = _make_scale_param([c], param_attr, 1.0, input.device)
    b = _make_param([c], bias_attr, True, device=input.device)
    out = F.group_norm(input, groups, epsilon=epsilon, weight=w, bias=b,
                       data_format=data_layout)
    return _act(out, act)


def instance_norm(input, epsilon=1e-05, param_attr=None, bias_attr=None,
                  name=None):
    """``F.instance_norm`` of NC... input with a fresh [C] scale and
    bias."""
    c = input.shape[1]
    w = _make_scale_param([c], param_attr, 1.0, input.device)
    b = _make_param([c], bias_attr, True, device=input.device)
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight / max(σ, eps)``, σ estimated by ``power_iters`` (at least
    one) rounds of power iteration from a u of ones, fresh at every call
    (the op form; the layer with stored u and v is
    ``nn.SpectralNorm``)."""
    mat = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    u = torch.ones(mat.shape[0], dtype=weight.dtype, device=weight.device)
    for _ in range(max(1, int(power_iters))):
        v = mat.t() @ u
        v = v / torch.linalg.vector_norm(v).clamp(min=eps)
        u = mat @ v
        u = u / torch.linalg.vector_norm(u).clamp(min=eps)
    sigma = u @ (mat @ v)
    return weight / sigma.clamp(min=eps)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=10, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation [N, 1]: weight [num_total_classes, D]
    and bias [num_total_classes]; each sample's positive class and the
    ``num_neg_samples`` negatives (drawn at build time by ``sampler``
    from ``np.random.RandomState(seed)``, shared by the batch) feed a
    logistic loss. ``sample_weight`` and ``is_sparse`` are taken and not
    used, as in the reference."""
    d = int(input.shape[-1])
    w = _make_param([num_total_classes, d], param_attr, False,
                    device=input.device)
    b = _make_param([num_total_classes], bias_attr, True,
                    device=input.device)
    rng = np.random.RandomState(seed or 0)
    if sampler == "uniform":
        negs = rng.randint(0, num_total_classes, num_neg_samples)
    elif sampler == "log_uniform":
        p = 1.0 / (np.arange(num_total_classes) + 1.0)
        negs = rng.choice(num_total_classes, num_neg_samples, p=p / p.sum())
    elif sampler == "custom_dist":
        negs = rng.choice(num_total_classes, num_neg_samples,
                          p=np.asarray(custom_dist))
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    negs = torch.as_tensor(negs.astype(np.int64), device=input.device)
    lbl = label.reshape(-1).long()
    s_pos = (input * w[lbl]).sum(-1)
    s_neg = input @ w[negs].t()
    if b is not None:
        s_pos = s_pos + b[lbl]
        s_neg = s_neg + b[negs][None, :]
    zero = torch.zeros((), dtype=input.dtype, device=input.device)
    loss = (torch.logaddexp(zero, -s_pos)
            + torch.logaddexp(zero, s_neg).sum(-1))
    return loss[:, None]


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


# ---------------------------------------------------------------------------
# detection and tagging heads
# ---------------------------------------------------------------------------
def crf_decoding(input, param_attr=None, label=None, length=None):
    """Viterbi decoding (``text.crf.crf_decoding``) over the transition
    parameter, passed as ``param_attr`` (the ``[D+2, D]`` tensor that
    ``linear_chain_crf`` trains), recorded as one op."""
    from ..text.crf import crf_decoding as _decode

    if not isinstance(param_attr, torch.Tensor):
        raise ValueError("pass the transition parameter (the [D+2, D] "
                         "tensor linear_chain_crf trains) as param_attr")
    return recording.record_opaque(_decode, input, param_attr, label, length)


def _ssd_sizes(n_maps, base_size, min_ratio, max_ratio):
    """The reference's min/max size schedule: ratios evenly spaced from
    ``min_ratio`` by floor((max − min)/(n − 2)) for maps 2..n, map 1 at
    10% / 20% of ``base_size``."""
    step = int(np.floor((max_ratio - min_ratio) / (n_maps - 2))) \
        if n_maps > 2 else 0
    min_sizes, max_sizes = [base_size * 0.1], [base_size * 0.2]
    ratio = min_ratio
    for _ in range(n_maps - 1):
        min_sizes.append(base_size * ratio / 100.0)
        max_sizes.append(base_size * (ratio + step) / 100.0)
        ratio += step
    return min_sizes, max_sizes


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """The SSD head: per feature map, a conv predicting 4 box offsets a
    prior and one a prior and class, and the map's priors
    (``vision.ops.prior_box``); returns (mbox_locs [N, P, 4], mbox_confs
    [N, P, num_classes], boxes [P, 4], variances [P, 4]) concatenated over
    the maps. Each map's priors are one recorded op (they read the map's
    and the image's shapes alone), so a Program can fetch them."""
    from ..vision.ops import prior_box

    if min_sizes is None:
        min_sizes, max_sizes = _ssd_sizes(len(inputs), base_size,
                                          min_ratio, max_ratio)
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        mx = max_sizes[i] if max_sizes else None
        # the step of map i: steps, else step_w/step_h, else derived from
        # the map's and the image's sizes (0)
        if steps is not None:
            st = [float(steps[i]), float(steps[i])]
        elif step_w is not None or step_h is not None:
            st = [float(step_w[i] if step_w is not None else 0.0),
                  float(step_h[i] if step_h is not None else 0.0)]
        else:
            st = [0.0, 0.0]
        priors = functools.partial(
            prior_box, min_sizes=_as_list(min_sizes[i]),
            max_sizes=_as_list(mx) if mx else [],
            aspect_ratios=_as_list(aspect_ratios[i]), variance=variance,
            flip=flip, clip=clip, steps=st, offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        box, var = recording.record_opaque(priors, feat, image)
        num_priors = int(box.shape[2])
        loc = conv2d(feat, num_priors * 4, kernel_size, stride=stride,
                     padding=pad)
        conf = conv2d(feat, num_priors * num_classes, kernel_size,
                      stride=stride, padding=pad)
        locs.append(loc.permute(0, 2, 3, 1).reshape(loc.shape[0], -1, 4))
        confs.append(conf.permute(0, 2, 3, 1).reshape(conf.shape[0], -1,
                                                      num_classes))
        boxes_all.append(box.reshape(-1, 4))
        vars_all.append(var.reshape(-1, 4))
    return (torch.cat(locs, dim=1), torch.cat(confs, dim=1),
            torch.cat(boxes_all, dim=0), torch.cat(vars_all, dim=0))


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    """Deformable convolution (modulated DCNv2 when ``mask`` is given)
    with a [num_filters, C/groups, kh, kw] weight and a bias made here
    (``vision.ops.deform_conv2d``)."""
    from ..vision.ops import deform_conv2d as _dcn

    kh, kw = _ntuple(filter_size, 2)
    w = _make_param([num_filters, int(x.shape[1]) // groups, kh, kw],
                    param_attr, False, device=x.device)
    b = _make_param([num_filters], bias_attr, True, device=x.device)
    return _dcn(x, offset, w, bias=b, stride=stride, padding=padding,
                dilation=dilation, deformable_groups=deformable_groups,
                groups=groups, mask=mask)
