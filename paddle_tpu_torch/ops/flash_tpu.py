"""Flash attention, forward and backward, causal or over all keys —
counterpart of ``paddle_tpu.ops.flash_tpu`` (causal) and of the Pallas
tier of ``paddle_tpu.ops.attention.flash_attention`` (causal or full).

``flash_attention_blhd`` (causal) and ``flash_attention_full`` (every key
attends) are ``torch.autograd.Function``s over one set of kernels with a
mask flag. For tensors on the card the forward launches
``csrc/flash_attn_fwd.cu`` (the port of the Pallas ``_fwd_kernel``, and of
``attention._flash_fwd_kernel`` in full mode) and the backward the dQ and
dK/dV kernels of ``csrc/flash_attn_bwd.cu`` (the ports of ``_dq_kernel``
and ``_dkv_kernel``; in full mode the same math with the mask dropped);
for tensors on the CPU they run the plain PyTorch versions,
``_flash_reference`` and ``_flash_bwd_reference``. Each mode's kernels
have their own launch counts. While ``torch.export`` traces the causal
forward, the registered op ``paddle_tpu_torch::flash_attn_fwd`` stands
in for it, so that the exported program (the Predictor's ``.pdexport``)
keeps it as one node; an eager call does not go through the dispatcher.
Both return ``(out, lse)``: ``out`` is
[b, L, H, d] in q's dtype, ``lse`` the f32 log-sum-exp of each query
row's scaled scores, [b, H, L] (not differentiable).

Which kernels run: bf16 operands go to the tensor-core kernels
(``mma.sync`` with f32 accumulation): ``flash_fwd_mma_kernel``, where P is
rounded to bf16 as the P·V operand, as the reference's ``_fwd_kernel``
feeds the MXU; ``flash_dq_mma_kernel`` and ``flash_dkv_mma_kernel``, where
P is rounded to bf16 as the Pᵀ·dO operand and dS as the dS·K and dSᵀ·Q
operand, as in the reference's ``_dq_kernel``/``_dkv_kernel``
(``_flash_bwd_reference(..., bf16_operands=True)`` is their plain
version). f32 operands go to the scalar ``flash_fwd_kernel``,
``flash_dq_kernel`` and ``flash_dkv_kernel``, exact f32 arithmetic with
no TF32 rounding — the checking path.

``flash_attention_full`` takes an optional key-padding bias, an f32
[b, L] tensor added to every query row's scaled scores before the
``k_pos < L`` mask (BERT's ``attention_mask`` as the reference's −1e9
bias; ``attention.dot_product_attention`` builds it from a bias that
broadcasts as [b, 1, 1, Lk]). The forward and both backward kernels
read it; it gets no gradient, and one that requires a gradient raises.

The kernels read q, k, v and the output gradient in the projection's
native layout: the last two axes must be dense ([H, d] with d
contiguous), while the row and batch strides are free, so q/k/v sliced
out of a fused QKV projection go in without a copy. The bf16 forward
and backward copy rows with 16-byte ``cp.async``: a bf16 q, k, v, out or
dout whose pointer or row or batch stride is not a multiple of 16 bytes
raises (nothing falls back).

The backward's ``delta = rowsum(dO ⊙ O)`` (an XLA einsum in the
reference) is computed for bf16 inside the dQ kernel, which writes it for
the dK/dV kernel: ``flash_bwd_dq(q, k, v, dout, lse, out)`` returns
``(dq, delta)`` and ``flash_bwd_dkv(q, k, v, dout, lse, delta)`` takes it.
For f32 the wrapper computes it with ``_delta`` and passes it to both
scalar kernels.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.recording import record_opaque
from . import _build

__all__ = ["flash_attention_blhd", "flash_attention_full", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_bwd_dq_full", "flash_bwd_dkv_full"]

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def _causal_mask(L: int, device) -> torch.Tensor:
    pos = torch.arange(L, device=device)
    return pos[None, :] > pos[:, None]  # True above the diagonal


def _add_key_bias(s: torch.Tensor, key_bias) -> torch.Tensor:
    """Scores [b, H, Lq, Lk] plus an f32 [b, Lk] key bias (or as they are)."""
    if key_bias is None:
        return s
    return s + key_bias.float()[:, None, None, :]


def _flash_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, key_bias=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over [b, L, H, d] operands (causal, or over every
    key), scores materialized in f32, ``key_bias`` ([b, L]) added to the
    scaled scores: returns (out [b, L, H, d] in q's dtype, lse [b, H, L]
    f32)."""
    L, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    s = _add_key_bias(s, key_bias)
    if causal:
        s = s.masked_fill(_causal_mask(L, q.device), _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO ⊙ O) per head in f32, [b, H, L] (the reference's
    ``einsum("blhd,blhd->bhl")``)."""
    return torch.einsum("blhd,blhd->bhl", dout.float(),
                        out.float()).contiguous()


def _flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, causal: bool = True,
                         key_bias=None, bf16_operands: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain attention backward in f32, mirroring the Pallas
    ``_dq_kernel``/``_dkv_kernel``: ``delta = rowsum(dO ⊙ O)``, recompute
    ``P = exp(S − lse)`` from the pre-scaled q (plus ``key_bias``, [b, L],
    which gets no gradient), then ``dS = P ⊙ (dO·Vᵀ − delta)``,
    ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``, ``dV = Pᵀ·dO``; causal, or
    over every key. With ``bf16_operands`` P is rounded to bf16 as the
    Pᵀ·dO operand and dS as the dS·K and dSᵀ·Q operand, where the
    reference's kernels (``flash_tpu.py:107, 141, 146``) and the bf16
    tensor-core kernels round them; q·scale is not rounded. Returns
    (dq, dk, dv) in q's dtype."""
    return _bwd_plain(q, k, v, dout, lse, _delta(out, dout), causal,
                      key_bias, bf16_operands)


def _bwd_plain(q, k, v, dout, lse, delta, causal=True, key_bias=None,
               bf16_operands=False):
    """``_flash_bwd_reference`` from a given delta ([b, H, L] f32)."""
    L, d = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), dout.float()
    s = _add_key_bias(torch.einsum("bqhd,bkhd->bhqk", qs, kf), key_bias)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(_causal_mask(L, q.device), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if bf16_operands:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _fwd(q, k, v, causal=True, key_bias=None):
    if q.device.type == "cpu":
        if causal and key_bias is None:
            _build.refuse_trace(q, "flash_attention_blhd")
        return _flash_reference(q, k, v, causal, key_bias)
    fn = "flash_attention_blhd" if causal else "flash_attention_full"
    _check_cuda_args(fn, q, k, v)
    _check_key_bias(fn, q, key_bias)
    b, L, H, d = q.shape
    out = torch.empty((b, L, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, H, L), dtype=torch.float32, device=q.device)
    if b == 0 or L == 0:
        return out, lse
    lib = _build.library()
    entry = lib.ptt_flash_attn_fwd if causal else lib.ptt_flash_attn_fwd_full
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(key_bias), b, L, H, d, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            1.0 / math.sqrt(d), _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(err, fn)
    (flash_attention_blhd if causal else flash_attention_full).launches += 1
    return out, lse


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_bwd(fn, entry, q, k, v, out, dout, lse, delta, key_bias, out0,
                out1):
    """One launch of a backward entry of ``csrc/flash_attn_bwd.cu`` (the
    caller has checked the operands)."""
    if out0.numel() == 0:
        return
    b, L, H, d = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(key_bias), out0.data_ptr(), _ptr(out1), b, L, H, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), dout.stride(0), dout.stride(1),
            *((out.stride(0), out.stride(1)) if out is not None else (0, 0)),
            1.0 / math.sqrt(d), _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(err, fn)


def _dq(causal, q, k, v, dout, lse, out, key_bias=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        delta = _delta(out, dout)
        return _bwd_plain(q, k, v, dout, lse, delta, causal,
                          key_bias)[0], delta
    fn = "flash_bwd_dq" if causal else "flash_bwd_dq_full"
    _check_bwd_args(fn, q, k, v, dout, lse, None, out, key_bias)
    b, L, H, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:  # the kernel computes and writes delta
        delta = torch.empty((b, H, L), dtype=torch.float32, device=q.device)
    else:  # the scalar kernels read it
        delta = _delta(out, dout)
    _launch_bwd(fn, "ptt_flash_attn_bwd_dq" + ("" if causal else "_full"),
                q, k, v, out, dout, lse, delta, key_bias, dq, None)
    if dq.numel():
        (flash_bwd_dq if causal else flash_bwd_dq_full).launches += 1
    return dq, delta


def _dkv(causal, q, k, v, dout, lse, delta, key_bias=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, causal, key_bias)[1:]
    fn = "flash_bwd_dkv" if causal else "flash_bwd_dkv_full"
    _check_bwd_args(fn, q, k, v, dout, lse, delta, None, key_bias)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(fn, "ptt_flash_attn_bwd_dkv" + ("" if causal else "_full"),
                q, k, v, None, dout, lse, delta, key_bias, dk, dv)
    if dk.numel():
        (flash_bwd_dkv if causal else flash_bwd_dkv_full).launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, out
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ of causal attention and ``delta = rowsum(dO ⊙ O)`` (one launch
    of ``csrc/flash_attn_bwd.cu``; bf16: the kernel computes delta, f32:
    ``_delta``): q/k/v/dout/out [b, L, H, d] at any row stride, lse f32
    [b, H, L]. Returns a dense [b, L, H, d] dQ and delta, f32 [b, H, L],
    which ``flash_bwd_dkv`` takes. On the CPU: the plain versions."""
    return _dq(True, q, k, v, dout, lse, out)


def flash_bwd_dkv(q, k, v, dout, lse, delta
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of causal attention (one launch of
    ``csrc/flash_attn_bwd.cu``) from ``flash_bwd_dq``'s delta; the other
    arguments as ``flash_bwd_dq``. On the CPU: the plain version."""
    return _dkv(True, q, k, v, dout, lse, delta)


def flash_bwd_dq_full(q, k, v, dout, lse, out, key_bias=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ and delta of attention over every key (one launch); arguments
    as ``flash_bwd_dq``, plus the forward's f32 [b, L] ``key_bias`` (or
    None)."""
    return _dq(False, q, k, v, dout, lse, out, key_bias)


def flash_bwd_dkv_full(q, k, v, dout, lse, delta, key_bias=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of attention over every key (one launch); arguments as
    ``flash_bwd_dkv``, plus the forward's ``key_bias`` (or None)."""
    return _dkv(False, q, k, v, dout, lse, delta, key_bias)


# kernel launches, counted where they happen
for _fn in (flash_bwd_dq, flash_bwd_dkv, flash_bwd_dq_full,
            flash_bwd_dkv_full):
    _fn.launches = 0


def _bwd(q, k, v, out, lse, key_bias, dout, causal):
    if q.device.type == "cpu":
        return _flash_bwd_reference(q, k, v, out, lse, dout, causal,
                                    key_bias)
    if not _dense_tail(dout) or (dout.dtype == torch.bfloat16
                                 and not _aligned_rows(dout)):
        dout = dout.contiguous()  # only 16-byte row/batch strides may vary
    dq, delta = _dq(causal, q, k, v, dout, lse, out, key_bias)
    dk, dv = _dkv(causal, q, k, v, dout, lse, delta, key_bias)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_attn_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal forward as a registered op: ``torch.export`` keeps it
    as one node of the exported graph, and the loaded program calls it
    back here (the kernel on the card, the plain version on the CPU)."""
    return _fwd(q, k, v, True, None)


@_flash_fwd_op.register_fake
def _(q, k, v):
    b, L, H, d = q.shape
    return (q.new_empty((b, L, H, d)),
            q.new_empty((b, H, L), dtype=torch.float32))


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, key_bias):
        if key_bias is not None and key_bias.requires_grad:
            raise NotImplementedError(
                "flash attention gives the key bias no gradient; pass one "
                "that does not require it (e.g. bias.detach())")
        # the registered op only while an export traces: eager calls skip
        # the dispatcher's round trip
        if causal and key_bias is None and torch.compiler.is_compiling():
            out, lse = _flash_fwd_op(q, k, v)
        else:
            out, lse = _fwd(q, k, v, causal, key_bias)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, key_bias)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        return (*_bwd(*ctx.saved_tensors, dout, ctx.causal), None, None)


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention over [b, L, H, d] operands; returns
    ``(out, lse)``, differentiable in q, k and v. ``causal=False`` is not
    this function's tier — ``flash_attention_full`` is, and callers
    dispatch through ``attention.dot_product_attention``."""
    if not causal:
        raise NotImplementedError(
            "flash_attention_blhd is the causal kernel; dispatch "
            "non-causal attention through dot_product_attention")
    return record_opaque(_FlashFn.apply, q, k, v, True, None)


def flash_attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_bias=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention of every query over every key, [b, L, H, d]
    operands, with an optional f32 [b, L] ``key_bias`` added to the scaled
    scores; returns ``(out, lse)``, differentiable in q, k and v (not in
    the bias)."""
    return record_opaque(_FlashFn.apply, q, k, v, False, key_bias)


flash_attention_blhd.launches = 0  # forward kernel launches, causal
flash_attention_full.launches = 0  # forward kernel launches, full


def _dense_tail(t):
    d = t.shape[-1]
    return t.stride(3) == 1 and (t.shape[2] <= 1 or t.stride(2) == d)


def _check_cuda_args(fn, q, k, v, **more):
    """q, k, v (and the ``more`` operands that are not None: the
    backward's dout and out) as the kernels take them."""
    # the shapes first: a call the kernel cannot take raises as such on
    # any device
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {q.dtype} not supported by the CUDA "
                        "kernel (float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"{fn}: q must be [b, L, H, d], got "
                         f"{tuple(q.shape)}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} not in {HEAD_DIMS}")
    operands = {"q": q, "k": k, "v": v,
                **{n: t for n, t in more.items() if t is not None}}
    for name, t in operands.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} != q "
                             f"shape {tuple(q.shape)}"
                             + (" (self-attention only)"
                                if name in ("k", "v") else ""))
    for name, t in operands.items():
        if not _dense_tail(t):
            raise ValueError(f"{fn}: {name} needs dense [H, d] trailing "
                             f"axes, strides {t.stride()}")
        if q.dtype == torch.bfloat16 and not _aligned_rows(t):
            raise ValueError(
                f"{fn}: bf16 {name} needs its row and batch strides in "
                f"multiples of 16 bytes for cp.async, strides {t.stride()}")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, t in operands.items():
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{fn}: bf16 {name} must start on a 16-byte "
                             f"boundary for cp.async (address "
                             f"{t.data_ptr():#x})")


def _aligned_rows(t):
    """Whether the row and batch strides of a [b, L, H, d] operand are
    multiples of 16 bytes (an axis of extent 1 is never stepped)."""
    return all(t.shape[i] <= 1 or t.stride(i) * t.element_size() % 16 == 0
               for i in (0, 1))


def _check_key_bias(fn, q, key_bias):
    if key_bias is None:
        return
    b, L = q.shape[0], q.shape[1]
    if (tuple(key_bias.shape) != (b, L) or key_bias.dtype != torch.float32
            or key_bias.device != q.device
            or not key_bias.is_contiguous()):
        raise ValueError(f"{fn}: key_bias must be a contiguous f32 [{b}, "
                         f"{L}] tensor on {q.device}, got {key_bias.dtype} "
                         f"{tuple(key_bias.shape)} on {key_bias.device}")


def _check_bwd_args(fn, q, k, v, dout, lse, delta, out, key_bias):
    """The backward's operands; ``delta`` or ``out`` may be None (not
    read by this launch)."""
    _check_cuda_args(fn, q, k, v, dout=dout, out=out)
    _check_key_bias(fn, q, key_bias)
    b, L, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if (t.shape != (b, H, L) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous f32 "
                             f"[{b}, {H}, {L}] tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
