"""Fused LayerNorm (forward and backward) and multi-tensor Adam —
counterpart of ``paddle_tpu.ops.fused``.

Each function launches a hand-written CUDA kernel for tensors on the card
and runs its plain PyTorch version for tensors on the CPU. There is no
fallback between the two: a CUDA tensor the kernel cannot take raises.

- ``fused_layer_norm`` is a ``torch.autograd.Function``: its forward is
  ``csrc/layer_norm.cu`` (the port of the Pallas ``_ln_kernel``) or
  ``_ln_reference``; while ``torch.export`` traces it, the registered op
  ``paddle_tpu_torch::layer_norm_fwd`` stands in for it, so that the
  exported program keeps it as one node (an eager call does not go
  through the dispatcher); its backward ``csrc/layer_norm_bwd.cu`` (the
  port of ``_ln_bwd_kernel``, two launches per call) or
  ``_ln_bwd_reference``.
  Each source holds two kernels, a warp per row (the models' widths) and a
  block per row (any other call); ``_ln_plan`` picks one from the shape,
  each in f32, bf16 and fp16. Under ``create_graph=True`` the backward is
  ``_LayerNormBwdFn``: the same kernel for the first derivative, and the
  closed-form ``_ln_bwd_vjp`` in plain torch (f32) for the second-order
  terms, itself differentiable to any order.
- ``fused_adam_step`` updates many parameters in one pass
  (``csrc/adam.cu``, the port of ``_adam_kernel``, two launches per call)
  or through ``_adam_reference``, a per-tensor loop over the reference's
  ``Adam._update``, with an L2 and an AdamW decoupled-decay coefficient
  per tensor. Given ``clip_norm`` it first runs ``csrc/adam.cu``'s
  sum-of-squares pass over the same tensor table (two more launches, the
  kernel of ``grad_global_norm``; plain version ``_global_norm_reference``)
  and the update reads the clip scale from the device. The plain version
  of the whole call is ``_fused_adam_reference``. Given a ``FiniteCheck``
  (the engines' ``check_finite`` / ``guard_updates``), the check pass of
  ``adam_finite_check`` runs before the update (two more launches, plain
  version ``_adam_check_reference``): it evaluates every new value and
  writes none, gives the step's finite flags, and under the check's gate
  the update and the beta powers' advance write nothing when a flag is
  false.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.recording import record_opaque
from . import _build

__all__ = ["fused_layer_norm", "fused_adam_step", "grad_global_norm",
           "layer_norm_bwd", "adam_finite_check", "FiniteCheck"]


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
def _ln_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm over the last axis: two-pass mean/variance in f32,
    the result cast back to ``x``'s dtype (the kernel's exact recipe)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _ln_bwd_reference(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain LayerNorm backward, line for line the Pallas
    ``_ln_bwd_kernel``'s math in f32: recompute mean/rstd, then
    ``dx = rstd·(g·w − mean(g·w) − x̂·mean(g·w·x̂))``, ``dw = Σ g·x̂``,
    ``db = Σ g`` over every row. ``dx`` is cast to ``x``'s dtype, ``dw``
    and ``db`` to the weight's."""
    hidden = x.shape[-1]
    xf = x.reshape(-1, hidden).float()
    w = weight.float()
    gf = g.reshape(-1, hidden).float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gw = gf * w
    m1 = gw.mean(dim=-1, keepdim=True)
    m2 = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gw - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    dw = (gf * xhat).sum(dim=0).to(weight.dtype)
    db = gf.sum(dim=0).to(weight.dtype)
    return dx, dw, db


# rows (one warp each) to a block of the warp-per-row kernels
_LN_WARP_ROWS = 8
# the widest row of the warp-per-row kernels: 64 values a lane, whose
# dγ/dβ sums the backward keeps in registers (`layer_norm_bwd.cu`)
_LN_WARP_MAX_HIDDEN = 64 * 32
# blocks of the warp-per-row backward: 2 per SM of an H100 (132 SMs), as
# many as its 128 registers a thread at hidden 1024 bf16 (ptxas) let an SM
# hold; each block writes one row of f32 partials
_LN_BWD_WARP_GRID = 2 * 132
# blocks of the block-per-row backward: enough to fill the card, few
# enough that the f32 partials [grid, hidden] stay small next to x
_LN_BWD_BLOCKS = 512
_LN_VARIANT_CODES = {"warp": 0, "block": 1}  # the C entries' `variant`


class _LnPlan(NamedTuple):
    variant: str         # "warp" or "block"
    rows_per_block: int  # warp: warps (one row at a time each) to a block;
    #                      block: rows to a block (the forward's: 1)
    grid: int            # blocks
    partials: Optional[Tuple[int, int]]  # backward: f32 dγ/dβ partials


def _ln_plan(rows: int, hidden: int, dtype: torch.dtype,
             ptr_alignment: int, backward: bool = False) -> _LnPlan:
    """The kernel and launch shape of one LayerNorm call over ``rows`` rows
    of ``hidden`` values, decided from the shape before the launch.

    ``"warp"`` (a warp per row, 16-byte vectors) takes a ``hidden`` that is
    a multiple of the 16-byte vector (8 bf16, 4 f32) up to
    ``_LN_WARP_MAX_HIDDEN`` when every pointer of the call is 16-byte
    aligned (``ptr_alignment``: the largest power of two up to 16 that
    divides them all); ``"block"`` takes every other call. The forward
    gives each warp one row, ``_LN_WARP_ROWS`` to a block; the backward's
    warps stride over the rows of at most ``_LN_BWD_WARP_GRID`` blocks and
    each block writes one row of the ``partials``."""
    vec = 16 // dtype.itemsize
    if (hidden % vec == 0 and hidden <= _LN_WARP_MAX_HIDDEN
            and ptr_alignment % 16 == 0):
        variant, rows_per_block = "warp", min(_LN_WARP_ROWS, rows)
        grid = -(-rows // rows_per_block)
        if backward:
            grid = min(grid, _LN_BWD_WARP_GRID)
    elif backward:
        variant, rows_per_block = "block", -(-rows // _LN_BWD_BLOCKS)
        grid = -(-rows // rows_per_block)
    else:
        variant, rows_per_block, grid = "block", 1, rows
    return _LnPlan(variant, rows_per_block, grid,
                   (grid, hidden) if backward else None)


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    return math.gcd(16, *(t.data_ptr() for t in tensors))


def _ln_fwd(x, weight, bias, eps):
    if x.device.type == "cpu":
        _build.refuse_trace(x, "fused_layer_norm")
        return _ln_reference(x, weight, bias, eps)
    hidden = x.shape[-1]
    _check_ln_args("fused_layer_norm", x, weight, bias, hidden)
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    if rows == 0:
        return y
    plan = _ln_plan(rows, hidden, x.dtype, _alignment(x, weight, bias, y))
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ptt_layer_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, hidden, plan.rows_per_block, plan.grid, float(eps),
            _build.DTYPE_CODES[x.dtype], _LN_VARIANT_CODES[plan.variant],
            _build.stream_of(x))
    _build.check(err, "layer_norm_fwd")
    fused_layer_norm.launches += 1
    return y


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` of LayerNorm over the last axis of ``x`` for the
    output gradient ``g``. CUDA tensors go through
    ``csrc/layer_norm_bwd.cu`` (two launches: the row pass, then a
    fixed-order reduce of per-block dw/db partials, so the result is
    deterministic), CPU tensors through ``_ln_bwd_reference``."""
    if x.device.type == "cpu":
        return _ln_bwd_reference(x, weight, g, eps)
    hidden = x.shape[-1]
    _check_ln_args("layer_norm_bwd", x, weight, weight, hidden)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"layer_norm_bwd: g is {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}, x is {x.dtype} {tuple(x.shape)}")
    g = g.contiguous()  # autograd may hand in a strided gradient
    rows = x.numel() // hidden
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    # the partials' rows are 16-byte aligned when hidden is a multiple of 4
    plan = _ln_plan(rows, hidden, x.dtype, _alignment(x, weight, g, dx),
                    backward=True)
    parts = torch.empty((2, *plan.partials), dtype=torch.float32,
                        device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ptt_layer_norm_bwd(
            x.data_ptr(), weight.data_ptr(), g.data_ptr(), dx.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), dw.data_ptr(),
            db.data_ptr(), rows, hidden, plan.rows_per_block, plan.grid,
            float(eps), _build.DTYPE_CODES[x.dtype],
            _LN_VARIANT_CODES[plan.variant], _build.stream_of(x))
    _build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 2
    return dx, dw, db


layer_norm_bwd.launches = 0  # kernel launches (two per call)


@torch.library.custom_op("paddle_tpu_torch::layer_norm_fwd", mutates_args=())
def _ln_fwd_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The LayerNorm forward as a registered op: ``torch.export`` keeps it
    as one node of the exported graph, and the loaded program calls it
    back here (the kernel on the card, the plain version on the CPU)."""
    return _ln_fwd(x, weight, bias, eps)


@_ln_fwd_op.register_fake
def _(x, weight, bias, eps):
    return torch.empty_like(x)


def _ln_bwd_vjp(x, weight, g, a, bw, bb, eps):
    """The vector-Jacobian product of ``(dx, dw, db) = layer_norm_bwd(x,
    weight, g)`` with the cotangents ``(a, bw, bb)``: ``(x̄, w̄, ḡ)`` in the
    inputs' dtypes. Closed form in f32, per row of ``hidden`` values,
    from the recomputed mean and rstd r, x̂ and gw = g·w, with
    P(u) = u − mean(u) − x̂·mean(u·x̂)::

        ḡ = w·r·P(a) + bw·x̂ + bb
        w̄ = Σ_rows g·r·P(a)
        G = bw·g − r·(a·mean(gw·x̂) + gw·mean(a·x̂))
        x̄ = r·(G − mean(G) − x̂·mean(G·x̂))
            − r²·x̂·(mean(a·gw) − mean(gw)·mean(a) − mean(a·x̂)·mean(gw·x̂))

    Plain differentiable torch: under ``create_graph`` a third derivative
    goes through it."""
    hidden = x.shape[-1]
    xf = x.reshape(-1, hidden).float()
    w = weight.float()
    gf = g.reshape(-1, hidden).float()
    af = a.reshape(-1, hidden).float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gw = gf * w
    rowmean = lambda t: t.mean(dim=-1, keepdim=True)
    m2, ma, n2 = rowmean(gw * xhat), rowmean(af), rowmean(af * xhat)
    pa = rstd * (af - ma - xhat * n2)
    dg = pa * w + bw.float() * xhat + bb.float()
    dw = (gf * pa).sum(dim=0)
    big_g = bw.float() * gf - rstd * (af * m2 + gw * n2)
    dx = (rstd * (big_g - rowmean(big_g) - xhat * rowmean(big_g * xhat))
          - rstd * rstd * xhat * (rowmean(af * gw) - rowmean(gw) * ma
                                  - n2 * m2))
    return (dx.to(x.dtype).reshape(x.shape), dw.to(weight.dtype),
            dg.to(g.dtype).reshape(g.shape))


class _LayerNormBwdFn(torch.autograd.Function):
    """``layer_norm_bwd`` as a differentiable op: the forward is the
    backward kernel (#6) on the card or ``_ln_bwd_reference`` on the CPU,
    the backward the closed-form ``_ln_bwd_vjp`` in plain torch. It stands
    in the graph only under ``create_graph=True``."""

    @staticmethod
    def forward(ctx, x, weight, g, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, g)
        return layer_norm_bwd(x, weight, g, eps)

    @staticmethod
    def backward(ctx, ddx, ddw, ddb):
        x, weight, g = ctx.saved_tensors
        return (*_ln_bwd_vjp(x, weight, g, ddx, ddw, ddb, ctx.eps), None)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        # the registered op only while an export traces: eager calls skip
        # the dispatcher's round trip
        fwd = _ln_fwd_op if torch.compiler.is_compiling() else _ln_fwd
        return fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph=True: the kernel still gives the first
            # derivative; the second-order terms come from _ln_bwd_vjp
            dx, dw, db = _LayerNormBwdFn.apply(x, weight, g, ctx.eps)
        else:
            dx, dw, db = layer_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, db, None


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` ([..., hidden]); ``weight``
    and ``bias`` are [hidden] in ``x``'s dtype. Differentiable to any
    order: the forward is the CUDA kernel (CUDA tensors, float32, bfloat16
    or float16, contiguous) or ``_ln_reference`` (CPU tensors), the
    backward ``layer_norm_bwd`` (under ``create_graph``, with
    ``_ln_bwd_vjp`` beyond the first derivative)."""
    return record_opaque(_LayerNormFn.apply, x, weight, bias, eps)


fused_layer_norm.launches = 0  # forward kernel launches


def _check_ln_args(fn, x, weight, bias, hidden):
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype not in _build.ACT_DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype} not supported by the CUDA "
                        "kernel (float32, bfloat16, float16)")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype} on {t.device}, x is "
                            f"{x.dtype} on {x.device}")
        if tuple(t.shape) != (hidden,) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous "
                             f"[{hidden}] tensor, got {tuple(t.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")


# ---------------------------------------------------------------------------
# multi-tensor Adam and the global gradient norm
# ---------------------------------------------------------------------------
def _global_norm_reference(grads: Sequence[torch.Tensor], clip_norm: float,
                           need_clip: Optional[Sequence[bool]] = None
                           ) -> torch.Tensor:
    """Plain global gradient norm, the reference's
    ``clip_grads_global_norm_raw``: the squares of every gradient (whose
    ``need_clip`` is true) summed in f32 from the gradient cast to f32,
    ``norm = sqrt(sum)``, ``scale = clip_norm / max(norm, clip_norm)``.
    Returns the f32 tensor ``[norm, scale]`` on the gradients' device."""
    clip = need_clip if need_clip is not None else [True] * len(grads)
    dev = grads[0].device if len(grads) else torch.device("cpu")
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for g, c in zip(grads, clip):
        if c:
            sq = sq + g.float().square().sum()
    norm = sq.sqrt()
    return torch.stack([norm, clip_norm / norm.clamp(min=clip_norm)])


def _adam_math(p, g, m, v, b1p, b2p, master, lr, beta1, beta2, eps, wd,
               c, grad_scale, clipped, lr_scale=1.0):
    """One tensor of ``_adam_reference``: ``(target, new, m1, m2, b1p',
    b2p')``, where ``target`` is the f32 tensor updated (the master, or the
    param) and ``new`` its new value; nothing is written. The tensor's
    learning rate is ``lr · lr_scale`` in f32, for the decay and the
    update alike."""
    target = master if master is not None else p
    if lr_scale != 1.0:
        lr = lr * lr_scale
    if grad_scale is not None and clipped:
        g = (g.float() * grad_scale).to(g.dtype)
    g = g.to(target.dtype)
    value = target
    if wd:
        g = g + wd * value
    if c:
        value = value * (1 - lr * c)
    new_b1p = b1p * beta1
    new_b2p = b2p * beta2
    m1 = beta1 * m + (1 - beta1) * g
    m2 = beta2 * v + (1 - beta2) * g * g
    lr_t = lr * torch.sqrt(1 - new_b2p) / (1 - new_b1p)
    new = value - (lr_t * m1 / (torch.sqrt(m2) + eps)).to(target.dtype)
    return target, new, m1, m2, new_b1p, new_b2p


def _adam_reference(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    moment1: Sequence[torch.Tensor],
                    moment2: Sequence[torch.Tensor],
                    beta1_pow: Sequence[torch.Tensor],
                    beta2_pow: Sequence[torch.Tensor], lr: torch.Tensor,
                    masters: Optional[Sequence[Optional[torch.Tensor]]] = None,
                    beta1: float = 0.9, beta2: float = 0.999,
                    eps: float = 1e-8, weight_decay=0.0,
                    decoupled_decay=None,
                    grad_scale: Optional[torch.Tensor] = None,
                    need_clip: Optional[Sequence[bool]] = None,
                    lr_scale=None) -> None:
    """Plain multi-tensor Adam, in place: for each tensor, exactly
    ``Adam._update`` of the reference on the f32 master (when one is
    given; the param, bf16 or fp16, is then re-cast from it) or on the
    param itself, at the learning rate ``lr · lr_scale`` (the tensor's
    scale: one float for every tensor or a float each, default 1).
    Before it, in the order of the reference engine's
    ``apply_optimizer_update``: a gradient that takes part in the clip
    (``need_clip``, default all) becomes ``g · grad_scale`` rounded back to
    its dtype; the tensor's L2 coefficient (``weight_decay``) is folded
    into the gradient as ``coeff · value``; and a tensor whose
    ``decoupled_decay`` coefficient c is not 0 is scaled by ``1 − lr·c``
    (AdamW). ``weight_decay`` and ``decoupled_decay`` are one float for
    every tensor or a float each."""
    n = len(params)
    masters = masters if masters is not None else [None] * n
    l2 = _per_tensor(weight_decay, n)
    decay = _per_tensor(decoupled_decay, n)
    scales = _per_tensor(lr_scale, n, 1.0)
    clip = need_clip if need_clip is not None else [True] * n
    for p, g, m, v, b1p, b2p, master, wd, c, clipped, s in zip(
            params, grads, moment1, moment2, beta1_pow, beta2_pow, masters,
            l2, decay, clip, scales):
        target, new, m1, m2, new_b1p, new_b2p = _adam_math(
            p, g, m, v, b1p, b2p, master, lr, beta1, beta2, eps, wd, c,
            grad_scale, clipped, s)
        target.copy_(new)
        if master is not None:
            p.copy_(new)
        m.copy_(m1)
        v.copy_(m2)
        b1p.copy_(new_b1p)
        b2p.copy_(new_b2p)


def _adam_check_reference(params, grads, moment1, moment2, beta1_pow,
                          beta2_pow, lr, masters=None, beta1=0.9,
                          beta2=0.999, eps=1e-8, weight_decay=0.0,
                          decoupled_decay=None, grad_scale=None,
                          need_clip=None, loss=None, lr_scale=None
                          ) -> torch.Tensor:
    """The plain version of the check pass (``adam_finite_check``): the
    bool flags ``[loss, grad_0 .. grad_n-1, param_0 .. param_n-1, True]``
    of one ``_adam_reference`` step that is computed and not written. A
    gradient's flag is its own (before the clip's scale), a parameter's is
    its new value in the parameter's dtype (the bf16 or fp16 copy of a
    new master); no loss is a finite one."""
    n = len(params)
    masters = masters if masters is not None else [None] * n
    l2 = _per_tensor(weight_decay, n)
    decay = _per_tensor(decoupled_decay, n)
    scales = _per_tensor(lr_scale, n, 1.0)
    clip = need_clip if need_clip is not None else [True] * n
    dev = params[0].device
    true = torch.ones((), dtype=torch.bool, device=dev)
    g_ok, p_ok = [], []
    for p, g, m, v, b1p, b2p, master, wd, c, clipped, s in zip(
            params, grads, moment1, moment2, beta1_pow, beta2_pow, masters,
            l2, decay, clip, scales):
        _, new, *_ = _adam_math(p, g, m, v, b1p, b2p, master, lr, beta1,
                                beta2, eps, wd, c, grad_scale, clipped, s)
        g_ok.append(torch.isfinite(g).all())
        p_ok.append(torch.isfinite(new.to(p.dtype)).all())
    loss_ok = torch.isfinite(loss).all() if loss is not None else true
    return torch.stack([loss_ok, *g_ok, *p_ok, true])


def _fused_adam_reference(params, grads, moment1, moment2, beta1_pow,
                          beta2_pow, lr, masters=None, beta1=0.9,
                          beta2=0.999, eps=1e-8, weight_decay=0.0,
                          decoupled_decay=None, clip_norm=None,
                          need_clip=None, check=None, lr_scale=None
                          ) -> Optional[torch.Tensor]:
    """The plain version of ``fused_adam_step``, with its arguments and
    its result: ``_global_norm_reference`` for the clip, then (given a
    ``check``) ``_adam_check_reference``, then ``_adam_reference`` with
    that scale, skipped when the check gates the step and a flag is
    false."""
    norm = (_global_norm_reference(grads, clip_norm, need_clip)
            if clip_norm is not None else None)
    scale = None if norm is None else norm[1]
    if check is not None:
        flags = _adam_check_reference(
            params, grads, moment1, moment2, beta1_pow, beta2_pow, lr,
            masters, beta1, beta2, eps, weight_decay, decoupled_decay,
            scale, need_clip, check.loss, lr_scale)
        check.flags, check.ok = flags, flags.all().to(torch.int32)
        if check.gate and not bool(check.ok):
            return norm
    _adam_reference(params, grads, moment1, moment2, beta1_pow, beta2_pow,
                    lr, masters, beta1, beta2, eps, weight_decay,
                    decoupled_decay, scale, need_clip, lr_scale)
    return norm


class FiniteCheck:
    """Asks ``fused_adam_step`` for the step's finite sweep, the check
    pass of ``adam_finite_check``: after the call ``flags`` is the bool
    tensor ``[loss, grad_0 .. grad_n-1, param_0 .. param_n-1, True]`` (in
    the order of the params given; the last slot is a constant for
    callers that pad) and ``ok`` the int32 0-d AND of them, both on the
    params' device. With ``gate`` the update (and the beta powers'
    advance) is skipped on the device when ``ok`` is 0, without a host
    sync. ``loss`` is the step's f32 loss (None: not checked)."""

    def __init__(self, loss: Optional[torch.Tensor] = None,
                 gate: bool = True):
        self.loss = loss
        self.gate = bool(gate)
        self.flags: Optional[torch.Tensor] = None
        self.ok: Optional[torch.Tensor] = None


def _per_tensor(coeff, n: int, default: float = 0.0) -> List[float]:
    """``coeff`` (None: ``default``, one float, or a float per tensor) as
    n floats."""
    if coeff is None:
        return [default] * n
    if isinstance(coeff, (int, float)):
        return [float(coeff)] * n
    return [float(c) for c in coeff]


# elements of one (tensor, chunk) work item of the CUDA update and of the
# sum-of-squares pass (a multiple of the pass's 8-element vectors)
_ADAM_CHUNK = 16384
# p, m, v, 2-byte copy, beta1_pow, beta2_pow, numel, g dtype, decoupled-decay
# bits, L2 bits, clipped, learning-rate scale bits
_TABLE_COLS = 12


def grad_global_norm(grads: Sequence[torch.Tensor], clip_norm: float,
                     need_clip: Optional[Sequence[bool]] = None
                     ) -> torch.Tensor:
    """The global norm of ``grads`` (those whose ``need_clip`` is true,
    default all) and the clip scale ``clip_norm / max(norm, clip_norm)``,
    as the f32 tensor ``[norm, scale]`` on their device; nothing is read
    back to the host. CUDA tensors (f32, bf16 or fp16, contiguous) go through
    the sum-of-squares kernel of ``csrc/adam.cu`` (two launches: the
    per-chunk sums, then a fixed-order finish, so the bits repeat), CPU
    tensors through ``_global_norm_reference``. ``fused_adam_step`` runs
    the same kernel over its own table when given ``clip_norm``."""
    n = len(grads)
    clip = list(need_clip) if need_clip is not None else [True] * n
    if len(clip) != n:
        raise ValueError("grad_global_norm: need_clip differs in length")
    if n == 0:
        raise ValueError("grad_global_norm: no gradients")
    dev = grads[0].device
    if dev.type == "cpu":
        return _global_norm_reference(grads, clip_norm, clip)
    if dev.type != "cuda":
        raise ValueError(f"grad_global_norm: unsupported device {dev}")
    rows = []
    for i, (g, c) in enumerate(zip(grads, clip)):
        _check_grad("grad_global_norm", i, g, dev)
        if g.numel():
            rows.append((0,) * 6 + (g.numel(), _build.DTYPE_CODES[g.dtype],
                                    0, 0, int(bool(c)), 0))
    tab, chunks, _, nchunks, _ = _device_table(dev, rows)
    return _launch_global_norm(
        dev, tab, _pointers([g for g in grads if g.numel()], dev), chunks,
        nchunks, clip_norm)


grad_global_norm.launches = 0  # kernel launches (two per call)


def _launch_global_norm(dev, tab, gptrs, chunks, nchunks, clip_norm):
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if nchunks == 0:
        return out.copy_(torch.tensor([0.0, 1.0]))
    partials = torch.empty(nchunks, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ptt_grad_sumsq(
            tab.data_ptr(), gptrs.data_ptr(), chunks.data_ptr(), nchunks,
            partials.data_ptr(), out.data_ptr(), float(clip_norm),
            _ADAM_CHUNK, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "grad_sumsq")
    grad_global_norm.launches += 2
    return out


def fused_adam_step(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    moment1: Sequence[torch.Tensor],
                    moment2: Sequence[torch.Tensor],
                    beta1_pow: Sequence[torch.Tensor],
                    beta2_pow: Sequence[torch.Tensor], lr: torch.Tensor,
                    masters: Optional[Sequence[Optional[torch.Tensor]]] = None,
                    beta1: float = 0.9, beta2: float = 0.999,
                    eps: float = 1e-8, weight_decay=0.0,
                    decoupled_decay=None, clip_norm: Optional[float] = None,
                    need_clip: Optional[Sequence[bool]] = None,
                    check: Optional["FiniteCheck"] = None,
                    lr_scale=None) -> Optional[torch.Tensor]:
    """One Adam step over many parameters, in place — the multi-tensor
    counterpart of the reference's ``fused_adam_step`` with the engine's
    master-weight handling, its global-norm clip, L2 decay and AdamW's
    decoupled decay.

    ``params[i]`` is updated through ``masters[i]`` (its f32 master, when
    given: the param is then the bf16 or fp16 resident copy, re-cast from
    the new master in the same pass) or directly (an f32 param); its
    gradient has the param's dtype. ``moment1``,
    ``moment2`` are f32 like the master; ``beta1_pow``/``beta2_pow`` are
    per-tensor 0-d f32 tensors, advanced by one step; ``lr`` is a 0-d f32
    tensor on the params' device; ``lr_scale`` (one float, or a float per
    tensor: the reference's ``optimize_attr['learning_rate']`` times
    AdamW's ``lr_ratio``; default 1) scales it per tensor, for the
    decoupled decay and the update. ``weight_decay`` is the L2 coefficient
    folded into each gradient (one float, or a float per tensor: a
    parameter's own regularizer); ``decoupled_decay`` (AdamW) gives each
    tensor a coefficient c (0: not decayed): its f32 value is scaled by
    ``1 − lr·c`` before the Adam update. With ``clip_norm`` the gradients
    (those whose ``need_clip`` is true, default all) are first scaled by
    ``clip_norm / max(global norm, clip_norm)``, each rounded back to its
    own dtype, and the f32 tensor ``[norm, scale]`` is returned. Nothing is
    read back to the host.

    Given a ``FiniteCheck``, the step's finite sweep runs before the
    update (``adam_finite_check``: the check pass evaluates every new value
    with the update's arithmetic and writes none) and fills its ``flags``
    and ``ok``; under its ``gate`` the update and the beta powers' advance
    read ``ok`` on the device and write nothing when it is 0, so a
    non-finite step keeps every bit of the state it came with.

    CUDA tensors go through ``csrc/adam.cu`` (two launches per call, and
    with ``clip_norm`` the two of the sum-of-squares pass before them, and
    with ``check`` the two of the check pass), CPU tensors through
    ``_fused_adam_reference``.
    """
    n = len(params)
    masters = list(masters) if masters is not None else [None] * n
    l2 = _per_tensor(weight_decay, n)
    decay = _per_tensor(decoupled_decay, n)
    scales = _per_tensor(lr_scale, n, 1.0)
    clip = list(need_clip) if need_clip is not None else [True] * n
    lists = (grads, moment1, moment2, beta1_pow, beta2_pow, masters, l2,
             decay, clip, scales)
    if any(len(t) != n for t in lists):
        raise ValueError("fused_adam_step: the lists differ in length")
    if n == 0:
        return None
    dev = params[0].device
    if dev.type == "cpu":
        return _fused_adam_reference(
            params, grads, moment1, moment2, beta1_pow, beta2_pow, lr,
            masters, beta1, beta2, eps, l2, decay, clip_norm, clip, check,
            scales)
    if dev.type != "cuda":
        raise ValueError(f"fused_adam_step: unsupported device {dev}")
    if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
        raise TypeError("fused_adam_step: lr must be a one-element f32 "
                        f"tensor on {dev}, got {lr.dtype} on {lr.device}")
    table, index = _adam_table(
        params, grads, moment1, moment2, beta1_pow, beta2_pow, masters,
        decay, l2, clip if clip_norm is not None else [False] * n, scales)
    tab, chunks, ntensors, nchunks, _ = table
    gptrs = _pointers([g for g in grads if g.numel()], dev)
    norm = None
    if clip_norm is not None:
        norm = _launch_global_norm(dev, tab, gptrs, chunks, nchunks,
                                   clip_norm)
    ok = None
    if check is not None:
        check.flags, check.ok = _launch_check(
            dev, table, index, n, gptrs, lr, norm, check.loss, beta1, beta2,
            eps)
        ok = check.ok if check.gate else None
    if nchunks == 0:
        return norm
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ptt_adam_step(
            tab.data_ptr(), gptrs.data_ptr(), chunks.data_ptr(), nchunks,
            ntensors, lr.data_ptr(),
            norm[1:].data_ptr() if norm is not None else None,
            ok.data_ptr() if ok is not None else None, beta1, beta2,
            1 - beta1, 1 - beta2, eps, _ADAM_CHUNK,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adam_step")
    fused_adam_step.launches += 2
    return norm


fused_adam_step.launches = 0  # kernel launches (two per call)


def adam_finite_check(params, grads, moment1, moment2, beta1_pow, beta2_pow,
                      lr, masters=None, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.0, decoupled_decay=None,
                      clip_norm=None, need_clip=None, loss=None,
                      lr_scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The finite sweep of one ``fused_adam_step`` with these arguments,
    computed and not applied: ``(flags, ok)`` as ``FiniteCheck`` gives
    them (the flags of the loss, of each gradient and of each new
    parameter in its dtype; ``ok`` their AND, int32). CUDA tensors go
    through ``csrc/adam.cu``'s check pass (two launches, and with
    ``clip_norm`` the sum-of-squares pass first; nothing is written to the
    state), CPU tensors through ``_adam_check_reference``.
    ``fused_adam_step(..., check=FiniteCheck(loss))`` runs the same pass
    before its update."""
    n = len(params)
    masters = list(masters) if masters is not None else [None] * n
    l2 = _per_tensor(weight_decay, n)
    decay = _per_tensor(decoupled_decay, n)
    scales = _per_tensor(lr_scale, n, 1.0)
    clip = list(need_clip) if need_clip is not None else [True] * n
    dev = params[0].device
    if dev.type == "cpu":
        norm = (_global_norm_reference(grads, clip_norm, clip)
                if clip_norm is not None else None)
        flags = _adam_check_reference(
            params, grads, moment1, moment2, beta1_pow, beta2_pow, lr,
            masters, beta1, beta2, eps, l2, decay,
            None if norm is None else norm[1], clip, loss, scales)
        return flags, flags.all().to(torch.int32)
    table, index = _adam_table(
        params, grads, moment1, moment2, beta1_pow, beta2_pow, masters,
        decay, l2, clip if clip_norm is not None else [False] * n, scales)
    gptrs = _pointers([g for g in grads if g.numel()], dev)
    norm = (_launch_global_norm(dev, table.tab, gptrs, table.chunks,
                                table.nchunks, clip_norm)
            if clip_norm is not None else None)
    return _launch_check(dev, table, index, n, gptrs, lr, norm, loss, beta1,
                         beta2, eps)


adam_finite_check.launches = 0  # check-pass launches (two per call)


def _launch_check(dev, table: "_Table", index: List[int], n: int, gptrs,
                  lr, norm, loss, beta1, beta2, eps):
    """The check pass over ``table``: flags in param order (``index``:
    the param of each table row; an empty param's flags are true)."""
    if loss is not None and (loss.device != dev or loss.dtype !=
                             torch.float32 or loss.numel() != 1):
        raise TypeError("fused_adam_step: the checked loss must be a "
                        f"one-element f32 tensor on {dev}")
    rows = table.ntensors
    flags = torch.empty(2 * rows + 2, dtype=torch.bool, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    partials = torch.empty(max(2 * table.nchunks, 1), dtype=torch.int32,
                           device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ptt_adam_check(
            table.tab.data_ptr(), gptrs.data_ptr(), table.chunks.data_ptr(),
            table.nchunks, rows, table.starts.data_ptr(), lr.data_ptr(),
            norm[1:].data_ptr() if norm is not None else None,
            loss.data_ptr() if loss is not None else None, beta1, beta2,
            1 - beta1, 1 - beta2, eps, _ADAM_CHUNK, partials.data_ptr(),
            flags.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adam_check")
    adam_finite_check.launches += 2
    if rows != n:  # empty params: true flags (the table's last slot)
        pick = [0] + [1 + index.index(i) if i in index else 2 * rows + 1
                      for i in range(n)] \
            + [1 + rows + index.index(i) if i in index else 2 * rows + 1
               for i in range(n)] + [2 * rows + 1]
        flags = flags[torch.tensor(pick, device=dev)]
    return flags, ok


def _pointers(tensors: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """The tensors' data pointers as a device int64 array (a pinned
    host-to-device copy that the launch after it waits for on the
    stream)."""
    ptrs = torch.tensor([t.data_ptr() for t in tensors],
                        dtype=torch.int64).pin_memory()
    return ptrs.to(dev, non_blocking=True)


def _check_grad(fn, i, g, dev):
    if g.device != dev:
        raise ValueError(f"{fn}: grad {i} is on {g.device}, the first on "
                         f"{dev}")
    if g.is_sparse:
        raise NotImplementedError(
            f"{fn}: grad {i} is row-sparse; the optimizers step sparse "
            "gradients on their row path (Optimizer._step_sparse), never "
            "through this kernel")
    if not g.is_contiguous():
        raise ValueError(f"{fn}: grad {i} is not contiguous")
    if g.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: grad {i} is {g.dtype} (float32, bfloat16, "
                        "float16)")


# device tables of the tensors' pointers, keyed by those pointers: the
# params, masters and moments are updated in place, so a training loop
# builds its table once
_TABLES: Dict[tuple, "_Table"] = {}
_TABLES_MAX = 8


class _Table(NamedTuple):
    tab: torch.Tensor     # device int64 [ntensors, _TABLE_COLS]
    chunks: torch.Tensor  # device int32 [nchunks, 2] (tensor, chunk)
    ntensors: int
    nchunks: int
    starts: torch.Tensor  # device int32 [ntensors + 1]: first chunk of each


def _device_table(dev, rows: List[tuple]) -> _Table:
    """The device table of ``rows`` (``_TABLE_COLS`` ints each) and its
    chunks, made once per distinct table."""
    key = (dev, tuple(rows))
    hit = _TABLES.get(key)
    if hit is None:
        counts = [-(-row[6] // _ADAM_CHUNK) for row in rows]
        chunks = [(t, c) for t, n in enumerate(counts) for c in range(n)]
        tab = torch.tensor(rows, dtype=torch.int64).reshape(-1, _TABLE_COLS)
        ch = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2)
        starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                              dtype=torch.int32)
        hit = _Table(tab.to(dev), ch.to(dev), len(rows), len(chunks),
                     starts.to(dev))
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.pop(next(iter(_TABLES)))
        _TABLES[key] = hit
    return hit


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _adam_table(params, grads, moment1, moment2, beta1_pow, beta2_pow,
                masters, decay, l2, clip, scales):
    dev = params[0].device
    rows: List[tuple] = []
    index: List[int] = []  # the param of each row (empty ones have none)
    for i, (p, g, m, v, b1p, b2p, master, c, wd, clipped, s) in enumerate(
            zip(params, grads, moment1, moment2, beta1_pow, beta2_pow,
                masters, decay, l2, clip, scales)):
        target = master if master is not None else p
        _check_grad("fused_adam_step", i, g, dev)
        for name, t in (("param", p), ("moment1", m), ("moment2", v),
                        ("beta1_pow", b1p), ("beta2_pow", b2p),
                        ("master", target)):
            if t.device != dev:
                raise ValueError(f"fused_adam_step: {name} {i} is on "
                                 f"{t.device}, params[0] on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"fused_adam_step: {name} {i} is not "
                                 "contiguous")
        if target.dtype != torch.float32:
            raise NotImplementedError(
                f"fused_adam_step: param {i} is {p.dtype} without an f32 "
                "master; the kernel updates f32 values only")
        for name, t in (("moment1", m), ("moment2", v), ("beta1_pow", b1p),
                        ("beta2_pow", b2p)):
            if t.dtype != torch.float32:
                raise TypeError(f"fused_adam_step: {name} {i} is {t.dtype}, "
                                "not float32")
        if b1p.numel() != 1 or b2p.numel() != 1:
            raise ValueError(f"fused_adam_step: beta powers of {i} must "
                             "have one element")
        if master is not None and p.dtype not in (torch.bfloat16,
                                                  torch.float16):
            raise TypeError(f"fused_adam_step: param {i} has a master, so "
                            f"it must be the bf16 or fp16 copy, not "
                            f"{p.dtype}")
        if g.dtype != p.dtype:
            raise TypeError(f"fused_adam_step: grad {i} is {g.dtype}, "
                            f"param {p.dtype}")
        for t in (g, m, v, target):
            if t.numel() != p.numel():
                raise ValueError(f"fused_adam_step: tensor {i} sizes differ")
        if p.numel() == 0:
            continue
        index.append(i)
        rows.append((target.data_ptr(), m.data_ptr(), v.data_ptr(),
                     p.data_ptr() if master is not None else 0,
                     b1p.data_ptr(), b2p.data_ptr(), p.numel(),
                     _build.DTYPE_CODES[g.dtype], _f32_bits(c), _f32_bits(wd),
                     int(bool(clipped)), _f32_bits(s)))
    return _device_table(dev, rows), index
