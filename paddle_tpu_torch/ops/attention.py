"""Attention — counterpart of ``paddle_tpu.ops.attention``, kept to what
the serving and training slices run:

- ``xla_attention``: softmax(QKᵀ/√d + bias)V with the scores
  materialized, in plain PyTorch (the reference's XLA-level tier);
- ``flash_attention``: the flash kernels as one differentiable call in
  either layout — causal (``flash_tpu.flash_attention_blhd``) or over
  every key (``flash_tpu.flash_attention_full``, the port of the Pallas
  ``_flash_fwd_kernel`` with a kernel backward, and an optional
  key-padding bias);
- ``dot_product_attention``: the dispatch, differentiable on both
  devices. It follows the reference's off-TPU rule (``_resolve_impl``),
  without its plain-path fallbacks on the card:

  - on the CPU: the plain path, with any bias;
  - on the card, unbiased: the flash kernel, whose wrapper raises on a
    shape it cannot take (head dim not in ``flash_tpu.HEAD_DIMS``,
    Lq != Lk, a bf16 operand whose rows are not 16-byte aligned);
  - on the card, with a bias that broadcasts as [b, 1, 1, Lk] (a key
    padding mask, as BERT's ``attention_mask`` builds it) and
    ``causal=False``: the full-attention kernels, which add it to the
    scaled scores as an f32 [b, Lk] key bias (no gradient for it: one
    that requires a gradient raises);
  - on the card, any other bias (per head or per query), or a bias with
    ``causal=True``: raises ``NotImplementedError``; no kernel takes it.
- ``paged_attention``: attention of a query chunk against the serving
  KV-cache pool, with the reference's two tiers (``_paged_gather_impl``,
  ``_paged_scan_impl``). They are XLA-level code in the reference, not
  Pallas kernels, so here they are plain PyTorch; the tier choice copies
  the reference's off-TPU heuristic. The micro-bench mode, the verdict
  cache and int8 pages wait for the ``tier_policy`` and ``quant`` ports.
"""
from __future__ import annotations

import math

import torch

from ..profiler.telemetry import get_telemetry
from . import flash_tpu

__all__ = ["xla_attention", "flash_attention", "dot_product_attention",
           "paged_attention"]

_NEG_INF = -1e30


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, bias=None,
                  layout: str = "bhld") -> torch.Tensor:
    """Materialized attention. ``layout='blhd'``: [b, l, h, d] operands,
    else [b, h, l, d]. ``bias`` is added to the scaled scores and must
    broadcast to [b, h, Lq, Lk] (in either layout), as in the reference's
    ``_attention_core``. The causal mask is top-left aligned
    (k_pos <= q_pos), as in every tier of the reference. Scores and
    softmax are f32; the output is cast to q's dtype."""
    blhd = layout == "blhd"
    eq = (("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd") if blhd
          else ("bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"))
    d = q.shape[-1]
    s = torch.einsum(eq[0], q.float(), k.float()) / math.sqrt(d)
    if bias is not None:
        s = s + bias.float()
    if causal:
        Lq, Lk = s.shape[-2], s.shape[-1]
        qp = torch.arange(Lq, device=q.device)
        kp = torch.arange(Lk, device=q.device)
        s = s.masked_fill(kp[None, :] > qp[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq[1], p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, layout: str = "bhld",
                    key_bias=None) -> torch.Tensor:
    """The flash kernels (``ops.flash_tpu``) as one differentiable call,
    returning only the output, as the reference's ``flash_attention``.
    ``layout='blhd'`` passes [b, l, h, d] operands (any row stride)
    straight to the kernels; [b, h, l, d] operands are transposed in and
    out. ``key_bias`` (f32 [b, Lk], full attention only) is added to the
    scaled scores. CPU tensors run the kernels' plain versions."""
    if causal:
        if key_bias is not None:
            raise NotImplementedError("flash_attention: the causal kernels "
                                      "take no key bias; only attention "
                                      "over every key does")
        fn = flash_tpu.flash_attention_blhd
    else:
        fn = lambda q_, k_, v_: flash_tpu.flash_attention_full(q_, k_, v_,
                                                               key_bias)
    if layout == "blhd":
        return fn(q, k, v)[0]
    tr = lambda t: t.transpose(1, 2)
    out, _ = fn(tr(q).contiguous(), tr(k).contiguous(), tr(v).contiguous())
    return tr(out)


def _key_bias(bias: torch.Tensor, batch: int, Lk: int) -> torch.Tensor:
    """A bias that broadcasts as [b, 1, 1, Lk] as the kernels take it, a
    contiguous f32 [b, Lk] tensor; any other bias raises."""
    shape = (1,) * (4 - bias.dim()) + tuple(bias.shape)
    if (len(shape) != 4 or shape[1] != 1 or shape[2] != 1
            or shape[0] not in (1, batch) or shape[3] not in (1, Lk)):
        raise NotImplementedError(
            f"dot_product_attention: an additive bias of shape "
            f"{tuple(bias.shape)} has no kernel on the card; the kernels "
            f"take a key-padding bias that broadcasts as [{batch}, 1, 1, "
            f"{Lk}]")
    return bias.reshape(shape[0], shape[3]).expand(batch, Lk).float() \
        .contiguous()


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, bias=None,
                          layout: str = "bhld") -> torch.Tensor:
    """Attention dispatch by the rules in the module docstring.
    ``layout='blhd'`` passes [b, l, h, d] operands straight to the kernel;
    [b, h, l, d] operands are transposed in and out."""
    get_telemetry().counter("attn/calls")
    if q.device.type == "cpu":
        return xla_attention(q, k, v, causal=causal, bias=bias,
                             layout=layout)
    if bias is None:
        return flash_attention(q, k, v, causal=causal, layout=layout)
    Lk = k.shape[1] if layout == "blhd" else k.shape[2]
    return flash_attention(q, k, v, causal=causal, layout=layout,
                           key_bias=_key_bias(bias, q.shape[0], Lk))


# ---------------------------------------------------------------------------
# Paged attention (decode over the serving KV-cache pool)
# ---------------------------------------------------------------------------
# Positions are logical: token p of a sequence lives in table slot
# p // block_size at offset p % block_size, so slot index IS position.

def _paged_mask(k_pos, q_positions, kv_lens):
    """[B, T, K] bool: causal (k_pos <= q_pos) AND within the written
    prefix (k_pos < kv_len) — the second clause keeps padded table slots
    and stale post-eviction entries unreadable."""
    return ((k_pos[None, None, :] <= q_positions[:, :, None])
            & (k_pos[None, None, :] < kv_lens[:, None, None]))


def _paged_gather_impl(q, k_pages, v_pages, block_tables, q_positions,
                       kv_lens):
    """q: [B, T, H, D]; k_pages/v_pages: [N, bs, H, D]; block_tables:
    [B, M] int; q_positions: [B, T] int global positions; kv_lens: [B]
    int valid prefix. One gather of the whole context, then one masked
    softmax."""
    B, T, H, D = q.shape
    bs = k_pages.shape[1]
    M = block_tables.shape[1]
    tables = block_tables.long()
    k = k_pages[tables].float().reshape(B, M * bs, H, D)
    v = v_pages[tables].float().reshape(B, M * bs, H, D)
    s = torch.einsum("bthd,bkhd->bhtk", q.float() / math.sqrt(D), k)
    k_pos = torch.arange(M * bs, device=q.device)
    mask = _paged_mask(k_pos, q_positions, kv_lens)
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhtk,bkhd->bthd", p, v).to(q.dtype)


def _paged_scan_impl(q, k_pages, v_pages, block_tables, q_positions,
                     kv_lens):
    """Online-softmax loop over table slots — the flash recurrence over
    pages; only one [B, bs, H, D] page pair is live per step."""
    B, T, H, D = q.shape
    bs = k_pages.shape[1]
    M = block_tables.shape[1]
    tables = block_tables.long()
    qf = q.float() / math.sqrt(D)
    acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    offsets = torch.arange(bs, device=q.device)
    for i in range(M):
        pids = tables[:, i]
        kc = k_pages[pids].float()  # [B, bs, H, D]
        vc = v_pages[pids].float()
        s = torch.einsum("bthd,bshd->bhts", qf, kc)
        mask = _paged_mask(i * bs + offsets, q_positions, kv_lens)
        s = s.masked_fill(~mask[:, None], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p, vc)
        l = l * corr + p.sum(dim=-1)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _paged_heuristic(m: int, bs: int) -> str:
    # the reference's off-TPU rule (ops/tier_policy.py): the materialized
    # gather while the gathered context is score-tensor-small, the
    # page-streaming scan past it
    return "paged_gather" if m * bs <= 4096 else "paged_scan"


def paged_attention(q, k_pages, v_pages, block_tables, q_positions,
                    kv_lens, k_scale=None, v_scale=None):
    """Attention of a query chunk against a paged KV cache.

    Args:
        q: [B, T, H, D] query chunk (T=1 decode, T=chunk prefill).
        k_pages/v_pages: one layer's pool pages [N, bs, H, D].
        block_tables: [B, M] int page ids (scratch-padded).
        q_positions: [B, T] int global position of each query token.
        kv_lens: [B] int — valid cache positions, this chunk's writes
            included.
        k_scale/v_scale: int8 page scales; not supported until the
            ``quant`` port.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV pages wait for the quant port")
    get_telemetry().counter("attn/calls")
    tier = _paged_heuristic(block_tables.shape[1], k_pages.shape[1])
    impl = (_paged_gather_impl if tier == "paged_gather"
            else _paged_scan_impl)
    return impl(q, k_pages, v_pages, block_tables, q_positions, kv_lens)
