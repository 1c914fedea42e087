"""Causal flash-attention forward — counterpart of
``paddle_tpu.ops.flash_tpu``.

``flash_attention_blhd`` launches the hand-written CUDA kernel
(``csrc/flash_attn_fwd.cu``, the port of the Pallas ``_fwd_kernel``) for
tensors on the card and runs the plain PyTorch version,
``_flash_reference``, for tensors on the CPU. Both return ``(out, lse)``:
``out`` is [b, L, H, d] in q's dtype, ``lse`` the f32 log-sum-exp of each
query row's scaled scores, [b, H, L].

The kernel reads q, k and v in the projection's native layout: the last
two axes must be dense ([H, d] with d contiguous), while the row and
batch strides are free, so q/k/v sliced out of a fused QKV projection
go in without a copy. The backward kernels (``_dq_kernel``,
``_dkv_kernel``) come with the training slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

__all__ = ["flash_attention_blhd"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)


def _flash_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain causal attention over [b, L, H, d] operands, scores
    materialized in f32: returns (out [b, L, H, d] in q's dtype,
    lse [b, H, L] f32)."""
    L, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(L, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention over [b, L, H, d] operands; returns
    ``(out, lse)``. ``causal=False`` is not a tier of this kernel —
    callers dispatch elsewhere first, as in the reference."""
    if not causal:
        raise NotImplementedError(
            "flash_attention_blhd is the causal kernel; dispatch "
            "non-causal attention through dot_product_attention")
    if q.device.type == "cpu":
        return _flash_reference(q, k, v)
    _check_cuda_args(q, k, v)
    b, L, H, d = q.shape
    out = torch.empty((b, L, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, H, L), dtype=torch.float32, device=q.device)
    if b == 0 or L == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, L, H, d, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            1.0 / math.sqrt(d), _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(err, "flash_attn_fwd")
    flash_attention_blhd.launches += 1
    return out, lse


flash_attention_blhd.launches = 0  # kernel launches, counted where they happen


def _check_cuda_args(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_blhd: unsupported device "
                         f"{q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention_blhd: dtype {q.dtype} not "
                        "supported by the CUDA kernel (float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"flash_attention_blhd: q must be [b, L, H, d], "
                         f"got {tuple(q.shape)}")
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_blhd: head dim {d} not in "
                         f"{_HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_blhd: {name} is {t.dtype} on "
                            f"{t.device}, q is {q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_blhd: {name} shape "
                             f"{tuple(t.shape)} != q shape {tuple(q.shape)} "
                             "(self-attention only)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != d):
            raise ValueError(f"flash_attention_blhd: {name} needs dense "
                             f"[H, d] trailing axes, strides {t.stride()}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention_blhd: the CUDA kernel is forward-only; run "
            "under torch.no_grad() (the backward kernels come with "
            "training)")
