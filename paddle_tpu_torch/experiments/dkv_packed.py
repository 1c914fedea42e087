"""Packed causal dK/dV backward — the port's twin of the reference's
``tools/experiments/dkv_packed_kernel.py``.

``dkv_call(q4, k4, v4, do4, lse, delta)`` computes dK and dV of causal
attention from the forward's lse and ``delta = rowsum(dO ⊙ O)``, with the
reference kernel's bf16 roundings (``q·scale``, P and dS rounded to bf16
before their products, f32 accumulation), in one launch of
``csrc/dkv_packed.cu``'s tensor-core kernel (the dK/dV loop of the causal
attention backward, ``csrc/dkv_mma_common.cuh``) that writes one packed
[b·h, L, 2d] bf16 buffer (dV in columns 0..d, dK in d..2d). CPU tensors
run the plain version, ``_dkv_packed_reference``, which mirrors the same
roundings.

The experiment is not wired into the training backward (the reference
does not wire it either); whether the packed layout should replace the
causal dK/dV kernel is a performance question ``main()`` measures:

    python -m paddle_tpu_torch.experiments.dkv_packed

prints the error against autograd of plain causal attention and the ms
per layer at b=8, H=16, L=1024, d=64, as the reference's ``main()`` does.
It needs a CUDA card and raises without one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.place import resolve_device
from ..ops import _build
from ..ops.flash_tpu import HEAD_DIMS

__all__ = ["dkv_call", "main"]


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _dkv_packed_reference(q4, k4, v4, do4, lse, delta
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed kernel, [b, H, L, d] operands and
    [b, H, L] f32 stats, rounding where the reference's ``dkv_kernel``
    rounds. Returns (dk, dv) in bf16."""
    L, d = q4.shape[2], q4.shape[3]
    scale = 1.0 / math.sqrt(d)
    qs = _round_bf16(q4.float() * scale)
    kh, vh, doh = (_round_bf16(t.float()) for t in (k4, v4, do4))
    pos = torch.arange(L, device=q4.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kh)
    s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    ds = p * (dp - delta.float()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", _round_bf16(p), doh)
    dk = torch.einsum("bhqk,bhqd->bhkd", _round_bf16(ds), qs)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def dkv_call(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
             do4: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of causal attention, [b, H, L, d] bf16 each, from
    contiguous bf16 [b, H, L, d] q/k/v/dO and f32 [b, H, L] lse/delta.
    On the card: one launch into a packed [b·H, L, 2d] buffer, of which
    dk and dv are views. On the CPU: ``_dkv_packed_reference``."""
    if q4.device.type == "cpu":
        return _dkv_packed_reference(q4, k4, v4, do4, lse, delta)
    _check_args(q4, k4, v4, do4, lse, delta)
    b, H, L, d = q4.shape
    out = torch.empty((b * H, L, 2 * d), dtype=torch.bfloat16,
                      device=q4.device)
    if out.numel() == 0:
        return out[..., d:].view(b, H, L, d), out[..., :d].view(b, H, L, d)
    lib = _build.library()
    with torch.cuda.device(q4.device):
        err = lib.ptt_dkv_packed(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out.data_ptr(), b * H, L, d,
            1.0 / math.sqrt(d), _build.stream_of(q4))
    _build.check(err, "dkv_packed")
    dkv_call.launches += 1
    out = out.view(b, H, L, 2 * d)
    return out[..., d:], out[..., :d]


dkv_call.launches = 0  # kernel launches, counted where they happen


def _check_args(q4, k4, v4, do4, lse, delta):
    # the shapes first: a call the kernel cannot take raises as such on any
    # device
    if q4.dim() != 4 or q4.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"dkv_call: q must be [b, H, L, d] with d in "
                         f"{HEAD_DIMS}, got {tuple(q4.shape)}")
    if q4.shape[0] * q4.shape[1] > 65535:  # the grid's y extent
        raise ValueError(f"dkv_call: b * H = {q4.shape[0] * q4.shape[1]} "
                         "is more than the kernel's 65535 batch-heads")
    for name, t in (("q", q4), ("k", k4), ("v", v4), ("dout", do4)):
        if (t.shape != q4.shape or t.dtype != torch.bfloat16
                or t.device != q4.device or not t.is_contiguous()):
            raise ValueError(f"dkv_call: {name} must be a contiguous bf16 "
                             f"{tuple(q4.shape)} tensor on {q4.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q4.shape[:3] or t.dtype != torch.float32
                or t.device != q4.device or not t.is_contiguous()):
            raise ValueError(f"dkv_call: {name} must be a contiguous f32 "
                             f"{tuple(q4.shape[:3])} tensor on {q4.device}")
    if q4.device.type != "cuda":
        raise ValueError(f"dkv_call: unsupported device {q4.device}")
    for name, t in (("q", q4), ("k", k4), ("v", v4), ("dout", do4)):
        if t.data_ptr() % 16:
            raise ValueError(f"dkv_call: {name} must start on a 16-byte "
                             f"boundary for cp.async (address "
                             f"{t.data_ptr():#x})")


def _plain_causal(q, k, v):
    """softmax(QKᵀ/√d, causal)V in f32 over [b, H, L, d]."""
    L, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(L, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float())


def main(device: Optional[str] = None, b: int = 8, H: int = 16,
         L: int = 1024, d: int = 64, reps: int = 5, seed: int = 0) -> dict:
    """The experiment at the reference's shape: inputs 0.2·N(0, 1) in
    bf16 from ``seed``, the error of dk and dv against autograd of plain
    causal attention in f32, and the ms per layer (CUDA events over
    ``reps`` calls; on the CPU the time is not measured)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda: (torch.randn(b, H, L, d, device=dev, generator=gen)
                  * 0.2).to(torch.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    # the reference's stats from a plain softmax attention
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(L, device=dev)
    s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                       v.float())
    delta = torch.einsum("bhqd,bhqd->bhq", do.float(), out)
    del s, out
    dk, dv = dkv_call(q, k, v, do, lse, delta)

    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    _, dk_ref, dv_ref = torch.autograd.grad(_plain_causal(*leaves), leaves,
                                            do.float())
    err_k = float((dk.float() - dk_ref).abs().max())
    err_v = float((dv.float() - dv_ref).abs().max())
    scale_k = float(dk_ref.abs().max())
    scale_v = float(dv_ref.abs().max())
    print("max err dk", err_k, "dv", err_v, "(ref scale dk", scale_k, "dv",
          scale_v, ")")
    ms = None
    if dev.type == "cuda":
        dkv_call(q, k, v, do, lse, delta)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dkv_call(q, k, v, do, lse, delta)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        print(f"b={b} H={H} L={L} d={d}: {ms:.3f} ms/layer "
              f"({torch.cuda.get_device_name(dev)})")
    else:
        print(f"b={b} H={H} L={L} d={d}: ms/layer not measured on {dev}")
    return {"err_dk": err_k, "err_dv": err_v, "scale_dk": scale_k,
            "scale_dv": scale_v, "ms": ms}


if __name__ == "__main__":
    main()
