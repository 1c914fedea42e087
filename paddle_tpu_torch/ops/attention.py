"""Attention — counterpart of ``paddle_tpu.ops.attention``, kept to what
the serving and training slices run:

- ``xla_attention``: the reference's XLA-level tier in plain PyTorch.
  Causal, unbiased self-attention whose length chunks exactly
  (``_causal_chunk_size``) runs q-chunked (``_CausalChunked``: chunk i
  attends to keys [0, (i+1)·c), the fully masked blocks are never
  computed, the normalization waits until after P·V, and the backward is
  the reference's hand-written rule); anything else materializes the
  [Lq, Lk] scores (``_materialized``);
- ``blockwise_attention``: the streaming online-softmax recurrence over
  key blocks of ``block_k`` (``_Blockwise``), O(L) in memory in both
  directions: its backward recomputes each block's probabilities from
  the saved log-sum-exp;
- ``flash_attention``: the flash kernels as one differentiable call in
  either layout — causal (``flash_tpu.flash_attention_blhd``) or over
  every key (``flash_tpu.flash_attention_full``, the port of the Pallas
  ``_flash_fwd_kernel`` with a kernel backward, and an optional
  key-padding bias);
- ``dot_product_attention``: the dispatch, differentiable on both devices
  (``_select_impl``). ``PADDLE_TPU_ATTENTION`` / ``set_attention_impl``
  force an impl; for an unbiased call with ``use_flash``,
  ``PADDLE_TPU_ATTN_POLICY`` (``ops.tier_policy``) forces a tier (``xla``,
  ``flash_tpu``, ``pallas`` — the same flash kernels — or ``blockwise``)
  or measures one (``bench``: the candidates are ``xla`` up to twice its
  length threshold, ``flash_tpu`` on the card for causal shapes the
  kernels take, and ``blockwise``). A forced or chosen ``flash_tpu`` or
  ``pallas`` (either knob) is the flash kernels: #1-#3 for a causal
  unbiased call, the full-attention kernels for a non-causal one (with
  at most a key-padding bias); a call they cannot take raises.
  Otherwise, and with the policy unset, the heuristic is the port's rule:

  - ``use_flash=False``: ``blockwise``, as in the reference;
  - on the CPU: the plain materialized path, with any bias;
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

  Where the reference reroutes, silently or counted in
  ``counter/attn/tier_fallbacks`` (a ``flash_tpu`` verdict or force that
  the call's shape does not fit, a forced ``pallas`` or ``flash_tpu``
  impl with a bias or ``causal=False``, a forced ``ring``), the port runs
  the flash kernels where they take the call and otherwise raises with
  the reason. Every dispatch counts ``counter/attn/calls`` and publishes
  ``gauge/attn/tier.<L>.<d>.<c|f>``.
- ``ring_attention``: attention over a sequence split across the ranks of
  a group (``ParallelTrainStep(sp_axis=...)``: each rank holds ``L / n``
  consecutive positions). K and V rotate one rank along the ring per hop
  (both directions posted in one ``batch_isend_irecv``); each hop runs
  the flash kernels on the resident shard: #1 causal when it is the
  rank's own shard, #1 in full mode (#4's instance) for an earlier shard,
  nothing for a later one when causal. The hops' ``(out, lse)`` merge in
  f32 (each hop's output rounded once). The backward recomputes with the
  merged lse and delta: #2 per hop for dQ (summed in f32) and #3 per hop
  for the resident shard's dK and dV, partials that travel with their
  shard and arrive home after a full turn. ``ring_forward`` and
  ``ring_backward`` are that schedule over a ``rotate`` callable (the
  process group's ``ring_group_rotate``, or ``ring_list_rotate`` when one
  process holds every rank); ``ring_hop_forward`` and
  ``ring_hop_backward`` are one hop; ``ring_merge`` folds a hop in.
  Inside an engine's ``ring_scope`` every causal unbiased self-attention
  dispatch takes the ring (a group of one rank is one causal hop on #1);
  ``PADDLE_TPU_ATTN_POLICY=ring`` forces it over the group
  ``set_ring_context`` registered, and raises without one.
- ``paged_attention``: attention of a query chunk against the serving
  KV-cache pool, with the reference's two tiers (``_paged_gather_impl``,
  ``_paged_scan_impl``), chosen by ``tier_policy.select_paged``. They are
  XLA-level code in the reference, not Pallas kernels, so here they are
  plain PyTorch, as are ``xla_attention`` and ``blockwise_attention``.
  int8 pages wait for the ``quant`` port.

Environment knobs, read as the reference reads them:
``PADDLE_TPU_ATTENTION_MAX_SEQ`` (4096) and ``..._MAX_SEQ_CAUSAL`` (8192)
cap the ``xla`` candidate at twice their value;
``PADDLE_TPU_ATTN_MIN_CHUNK`` (128) and ``PADDLE_TPU_ATTN_CHUNKS`` (32)
size the causal chunks; ``PADDLE_TPU_ATTN_SCORE_BF16`` (1) stores the
chunked tier's scores and exp weights in a bf16 or f16 input's dtype;
``PADDLE_TPU_ATTN_REMAT_E`` (1, read at every call) recomputes the exp
weights in the backward from saved per-chunk maxima instead of saving
them.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from ..core.recording import record_opaque
from ..profiler.telemetry import get_telemetry
from . import _build, flash_tpu, tier_policy

__all__ = ["xla_attention", "blockwise_attention", "flash_attention",
           "dot_product_attention", "set_attention_impl", "paged_attention"]

_NEG_INF = -1e30

_IMPLS = ("auto", "pallas", "flash_tpu", "xla", "blockwise")
_IMPL = os.environ.get("PADDLE_TPU_ATTENTION", "auto")
_XLA_MAX_SEQ = int(os.environ.get("PADDLE_TPU_ATTENTION_MAX_SEQ", "4096"))
_XLA_MAX_SEQ_CAUSAL = int(os.environ.get(
    "PADDLE_TPU_ATTENTION_MAX_SEQ_CAUSAL", "8192"))
_CAUSAL_CHUNK = int(os.environ.get("PADDLE_TPU_ATTN_MIN_CHUNK", "128"))
_CAUSAL_MAX_CHUNKS = int(os.environ.get("PADDLE_TPU_ATTN_CHUNKS", "32"))
_SCORE_BF16 = os.environ.get("PADDLE_TPU_ATTN_SCORE_BF16", "1") == "1"


def set_attention_impl(impl: str) -> None:
    """impl ∈ {'auto', 'pallas', 'flash_tpu', 'xla', 'blockwise'}, read
    at every dispatch."""
    global _IMPL
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    _IMPL = impl


# ---------------------------------------------------------------------------
# Materialized attention
# ---------------------------------------------------------------------------
def _einsum_eqs(blhd: bool):
    return (("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd") if blhd
            else ("bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"))


def _materialized(q, k, v, causal=False, bias=None, layout="bhld"):
    """softmax(QKᵀ/√d + bias)V with the f32 scores materialized; ``bias``
    broadcasts to [b, h, Lq, Lk] in either layout. The causal mask is
    top-left aligned (k_pos <= q_pos), as in every tier of the reference.
    The output is cast to q's dtype."""
    eq = _einsum_eqs(layout == "blhd")
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


# ---------------------------------------------------------------------------
# The causal q-chunked tier (the reference's _causal_chunked)
# ---------------------------------------------------------------------------
def _causal_chunk_size(Lq: int) -> Optional[int]:
    """The causal chunk size, or None when no exact chunking exists (c must
    divide Lq into at least 2 chunks)."""
    c = max(_CAUSAL_CHUNK, Lq // max(_CAUSAL_MAX_CHUNKS, 1))
    if Lq % c != 0 or Lq // c < 2:
        return None
    return c


def _remat_e() -> bool:
    """Whether the backward recomputes the exp weights (default on)."""
    return os.environ.get("PADDLE_TPU_ATTN_REMAT_E", "1") == "1"


# backward einsums per layout: dP, dq, dk, dv, delta
_BWD_EQS = {
    True: ("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd", "bhqk,bqhd->bkhd",
           "bhqk,bqhd->bkhd", "bqhd,bqhd->bhq"),
    False: ("bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd", "bhqk,bhqd->bhkd",
            "bhqk,bhqd->bhkd", "bhqd,bhqd->bhq"),
}


def _inv_rows(inv, blhd):
    """A [b, h, q] row statistic broadcast against the q-shaped layout."""
    return inv.transpose(1, 2)[..., None] if blhd else inv[..., None]


def _low_precision(dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def _chunk_e(q, k, i, c, blhd, m=None):
    """exp weights of causal chunk i, e = exp(s − max(s)) with s the scaled
    QKᵀ under the chunk's top-left tril mask, and the maxima. Given the
    saved maxima ``m`` the recomputed e is bitwise the forward's. For a
    bf16 or f16 input (with ``_SCORE_BF16``) the scores and e are stored
    in its dtype (products accumulated in f32, the centered logits
    rounded before exp), as the reference does."""
    axis_l = 1 if blhd else 2
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    sdt = q.dtype if (_SCORE_BF16 and _low_precision(q.dtype)) \
        else torch.float32
    ub = (i + 1) * c
    qi = q.narrow(axis_l, i * c, c) * scale
    ki = k.narrow(axis_l, 0, ub)
    eq = _einsum_eqs(blhd)[0]
    s = (torch.einsum(eq, qi, ki) if sdt == q.dtype
         else torch.einsum(eq, qi.float(), ki.float()))
    mask = torch.ones(c, ub, dtype=torch.bool, device=q.device).tril(ub - c)
    s = s.masked_fill(~mask, _NEG_INF if sdt == torch.float32 else -3e38)
    if m is None:
        m = s.amax(dim=-1, keepdim=True)
    if sdt != torch.float32:
        e = torch.exp((s - m).float()).to(q.dtype)
    else:
        e = torch.exp(s - m)
    return e, m


def _causal_chunked_fwd(q, k, v, blhd):
    """(out, per-chunk maxima or exp weights, per-chunk 1/rowsum)."""
    axis_l = 1 if blhd else 2
    Lq = q.shape[axis_l]
    c = _causal_chunk_size(Lq)
    eq = _einsum_eqs(blhd)[1]
    remat = _remat_e()
    outs, aux, invs = [], [], []
    for i in range(Lq // c):
        e, m = _chunk_e(q, k, i, c, blhd)
        vi = v.narrow(axis_l, 0, (i + 1) * c)
        l_sum = e.sum(dim=-1, dtype=torch.float32).clamp_min(1e-30)
        o = torch.einsum(eq, e.to(q.dtype), vi)
        inv = (1.0 / l_sum).to(q.dtype)
        outs.append(o * _inv_rows(inv, blhd))
        aux.append(m if remat else e)
        invs.append(inv)
    return torch.cat(outs, dim=axis_l), aux, invs


class _CausalChunked(torch.autograd.Function):
    """Causal self-attention, q-chunked, with the reference's hand-written
    backward (``_causal_chunked_bwd``): the softmax backward with the
    normalization folded into the [.., c, d] dO chunk,
    dS = e ⊙ (dP·inv − rowsum(dO ⊙ O)·inv), so no O(L²) divide runs in
    either direction. Under ``PADDLE_TPU_ATTN_REMAT_E`` (default) only the
    per-chunk maxima are saved. dK and dV sum their chunk contributions in
    f32 and round once (the reference sums them in the input's dtype)."""

    @staticmethod
    def forward(ctx, q, k, v, blhd):
        out, aux, invs = _causal_chunked_fwd(q, k, v, blhd)
        ctx.blhd = blhd
        ctx.remat = _remat_e()
        ctx.save_for_backward(q, k, v, out, *aux, *invs)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, *rest = ctx.saved_tensors
        blhd = ctx.blhd
        n = len(rest) // 2
        aux, invs = rest[:n], rest[n:]
        axis_l = 1 if blhd else 2
        Lq = q.shape[axis_l]
        c = Lq // n
        scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
        dP_eq, dq_eq, dk_eq, dv_eq, delta_eq = _BWD_EQS[blhd]
        dqs = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(n):
            ub = (i + 1) * c
            qi = q.narrow(axis_l, i * c, c)
            ki, vi = k.narrow(axis_l, 0, ub), v.narrow(axis_l, 0, ub)
            gi = g.narrow(axis_l, i * c, c)
            oi = out.narrow(axis_l, i * c, c)
            e = (_chunk_e(q, k, i, c, blhd, m=aux[i])[0] if ctx.remat
                 else aux[i])
            inv = invs[i]
            g_inv = (gi * _inv_rows(inv, blhd)).to(q.dtype)
            delta = torch.einsum(delta_eq, gi.float(), oi.float())
            dP = torch.einsum(dP_eq, g_inv.float(), vi.float())
            dS = (e.float() * (dP - (delta * inv.float())[..., None])
                  ).to(q.dtype)
            # masked positions need no re-masking: e is exactly 0 there
            dqs.append(torch.einsum(dq_eq, dS, ki) * scale)
            dk.narrow(axis_l, 0, ub).add_(torch.einsum(dk_eq, dS, qi)
                                          * scale)
            dv.narrow(axis_l, 0, ub).add_(torch.einsum(dv_eq, e.to(q.dtype),
                                                       g_inv))
        return (torch.cat(dqs, dim=axis_l), dk.to(k.dtype), dv.to(v.dtype),
                None)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, bias=None,
                  layout: str = "bhld") -> torch.Tensor:
    """The reference's XLA-level tier. ``layout='blhd'``: [b, l, h, d]
    operands, else [b, h, l, d]. Causal, unbiased self-attention whose
    length chunks exactly runs q-chunked (``_CausalChunked``); anything
    else materializes the f32 scores (``_materialized``; ``bias`` must
    broadcast to [b, h, Lq, Lk] in either layout)."""
    axis_l = 1 if layout == "blhd" else 2
    Lq, Lk = q.shape[axis_l], k.shape[axis_l]
    if (causal and bias is None and Lq == Lk
            and _causal_chunk_size(Lq) is not None):
        return record_opaque(_CausalChunked.apply, q, k, v,
                             layout == "blhd")
    return _materialized(q, k, v, causal, bias, layout)


# ---------------------------------------------------------------------------
# Blockwise online-softmax attention (the flash recurrence in torch)
# ---------------------------------------------------------------------------
def _blocks(q, k, causal, block_k, q_offset, kv_offset):
    """(first key, end key, first query row) of each key block that has a
    query attending to it. For causal attention with kv_offset <= q_offset
    every row already has a valid key in block 0, so rows that see none of
    a block's keys (and blocks no row sees) are skipped: their
    probabilities are exactly 0 and their correction exactly 1."""
    Lq, Lk = q.shape[2], k.shape[2]
    skip = causal and kv_offset <= q_offset
    for s0 in range(0, Lk, block_k):
        r0 = min(max(kv_offset + s0 - q_offset, 0), Lq) if skip else 0
        if r0 < Lq:
            yield s0, min(s0 + block_k, Lk), r0


def _block_scores(qf, k, bias, s0, e0, r0, causal, q_offset, kv_offset,
                  scale):
    """The f32 scores of query rows r0: against keys s0:e0, biased and
    masked as the reference's ``_block_scan_attention`` body does."""
    s = (qf[:, :, r0:] @ k[:, :, s0:e0].float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, :, r0:, s0:e0].float()
    if causal:
        q_pos = q_offset + torch.arange(r0, qf.shape[2], device=qf.device)
        k_pos = kv_offset + torch.arange(s0, e0, device=qf.device)
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], _NEG_INF)
    return s


class _Blockwise(torch.autograd.Function):
    """``blockwise_attention`` on [b, h, L, d] operands. The forward keeps
    q, k, v, the f32 output and the per-row lse (m + log l); the backward
    recomputes each block's probabilities from the lse (the flash
    backward), so neither direction holds more than one block's
    [Lq, block_k] scores."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, block_k, q_offset, kv_offset):
        b, h, Lq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qf = q.float()
        acc = torch.zeros(b, h, Lq, d, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, Lq), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(b, h, Lq, dtype=torch.float32, device=q.device)
        for s0, e0, r0 in _blocks(q, k, causal, block_k, q_offset,
                                  kv_offset):
            s = _block_scores(qf, k, bias, s0, e0, r0, causal, q_offset,
                              kv_offset, scale)
            m_old = m[:, :, r0:]
            m_new = torch.maximum(m_old, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_old - m_new)
            l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(dim=-1)
            acc[:, :, r0:] = (acc[:, :, r0:] * corr[..., None]
                              + p @ v[:, :, s0:e0].float())
            m[:, :, r0:] = m_new
        l = l.clamp_min(1e-30)
        out = acc / l[..., None]
        lse = m + torch.log(l)
        ctx.args = (causal, block_k, q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, block_k, q_offset, kv_offset = ctx.args
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(dim=-1)
        dq = torch.zeros_like(qf)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        want_db = bias is not None and ctx.needs_input_grad[3]
        # the bias came in broadcast to [b, h, Lq, Lk]; autograd sums its
        # gradient back to the caller's shape
        db = (torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
              if want_db else None)
        for s0, e0, r0 in _blocks(q, k, causal, block_k, q_offset,
                                  kv_offset):
            s = _block_scores(qf, k, bias, s0, e0, r0, causal, q_offset,
                              kv_offset, scale)
            p = torch.exp(s - lse[:, :, r0:, None])
            do_r = do[:, :, r0:]
            dv[:, :, s0:e0] += p.transpose(-1, -2) @ do_r
            dp = do_r @ v[:, :, s0:e0].float().transpose(-1, -2)
            ds = p * (dp - delta[:, :, r0:, None])
            dq[:, :, r0:] += (ds @ k[:, :, s0:e0].float()) * scale
            dk[:, :, s0:e0] += (ds.transpose(-1, -2) @ qf[:, :, r0:]) * scale
            if want_db:
                db[:, :, r0:, s0:e0] = ds
        dbias = db.to(bias.dtype) if want_db else None
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
                None, None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, block_k: int = 512, bias=None,
                        q_offset: int = 0, kv_offset: int = 0
                        ) -> torch.Tensor:
    """q, k, v: [b, h, L, d]; returns [b, h, Lq, d] in q's dtype, computed
    in f32 by an online softmax over key blocks of ``block_k``.
    ``q_offset``/``kv_offset`` are global position offsets of the causal
    mask; ``bias`` (added to the scaled scores) broadcasts to
    [b, h, Lq, Lk] and gets a gradient when it requires one."""
    if bias is not None:
        bias = torch.broadcast_to(
            bias, (*q.shape[:3], k.shape[2]))
    return record_opaque(_Blockwise.apply, q, k, v, bias, causal, block_k,
                         q_offset, kv_offset)


# ---------------------------------------------------------------------------
# The flash kernels
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------
def _dims(q, k, blhd):
    """(heads, Lq, Lk) of the call."""
    if blhd:
        return q.shape[2], q.shape[1], k.shape[1]
    return q.shape[1], q.shape[2], k.shape[2]


def _flash_misfit(q, k, v, blhd) -> Optional[str]:
    """Why the flash kernels cannot take this self-attention call as
    ``flash_attention`` passes it, or None."""
    _, L, Lk = _dims(q, k, blhd)
    if q.shape[-1] not in flash_tpu.HEAD_DIMS:
        return f"head dim {q.shape[-1]} not in {flash_tpu.HEAD_DIMS}"
    if Lk != L:
        return f"Lq {L} != Lk {Lk} (self-attention only)"
    if q.dtype not in _build.ACT_DTYPES:
        return f"dtype {q.dtype} (float32, bfloat16 or float16)"
    if blhd and q.dtype in flash_tpu._MMA_DTYPES:
        # bhld operands are transposed into fresh contiguous tensors
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not flash_tpu._aligned_rows(t) or (
                    t.device.type == "cuda" and t.data_ptr() % 16):
                return (f"{flash_tpu._short(q.dtype)} {name} rows not "
                        f"16-byte aligned (strides {t.stride()})")
    return None


def _tier_candidates(q, k, v, causal, blhd):
    """The feasible tiers of a measurement: shape and device gates only.
    ``xla`` is capped at twice its length threshold so that the bench
    cannot run out of memory on the scores; ``pallas`` is the flash
    kernels again and is never timed."""
    _, L, Lk = _dims(q, k, blhd)
    cands = []
    if Lk == L and L <= 2 * (_XLA_MAX_SEQ_CAUSAL if causal
                             else _XLA_MAX_SEQ):
        cands.append("xla")
    if (q.device.type == "cuda" and causal
            and _flash_misfit(q, k, v, blhd) is None):
        cands.append("flash_tpu")
    cands.append("blockwise")
    return cands


def _flash_impl(what, q, k, v, bias, causal, blhd) -> str:
    """'flash' for a call the flash kernels take (causal: #1-#3,
    unbiased; otherwise the full-attention kernels, with no bias or a
    key-padding bias, which ``_key_bias`` checks), else raises: the
    reference reroutes such a call, to blockwise or the XLA tier, and on
    a forced tier's verdict counts a fallback."""
    why = _flash_misfit(q, k, v, blhd)
    if why is None and causal and bias is not None:
        why = "a bias with causal=True (the causal kernels take none)"
    if why is not None:
        raise NotImplementedError(
            f"dot_product_attention: {what} cannot take this call: {why}; "
            f"choose another tier with PADDLE_TPU_ATTN_POLICY or "
            f"PADDLE_TPU_ATTENTION")
    return "flash"


def _impl_of_tier(tier, q, k, v, causal, blhd) -> str:
    """A policy's tier (unbiased calls only) as an impl."""
    if tier in ("flash_tpu", "pallas"):
        return _flash_impl(f"the {tier} tier", q, k, v, None, causal, blhd)
    return tier  # xla | blockwise


def _resolve_impl(q, k, v, bias, use_flash, causal, blhd) -> str:
    """The forced impl, or the heuristic (the port's rule; see the
    module docstring)."""
    if _IMPL in ("flash_tpu", "pallas"):
        return _flash_impl(f"PADDLE_TPU_ATTENTION={_IMPL}", q, k, v, bias,
                           causal, blhd)
    if _IMPL in ("xla", "blockwise"):
        return _IMPL
    if not use_flash:
        return "blockwise"
    return "plain" if q.device.type == "cpu" else "flash"


def _select_impl(q, k, v, bias, use_flash, causal, blhd
                 ) -> Tuple[str, str]:
    """``(impl, tier)`` of this dispatch: the tier policy where it has
    jurisdiction (impl 'auto', unbiased, ``use_flash``), else the
    heuristic."""
    if _IMPL == "auto" and bias is None and use_flash:
        mode = tier_policy.policy_mode()
        choice = None
        if mode in ("xla", "blockwise", "flash_tpu", "pallas"):
            choice = mode
        elif mode == "ring":
            why = _ring_unavailable_reason(causal, bias, q, k, blhd)
            if why is not None:
                raise NotImplementedError(
                    f"PADDLE_TPU_ATTN_POLICY=ring but {why}")
            return "ring", "ring"
        elif mode == "bench":
            h, L, _ = _dims(q, k, blhd)
            choice = tier_policy.select(
                h, L, q.shape[-1], q.dtype, causal,
                _tier_candidates(q, k, v, causal, blhd), device=q.device)
        if choice is not None:
            return _impl_of_tier(choice, q, k, v, causal, blhd), choice
    impl = _resolve_impl(q, k, v, bias, use_flash, causal, blhd)
    tier = {"plain": "xla", "flash": "flash_tpu" if causal else "pallas"
            }.get(impl, impl)
    return impl, tier


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, bias=None,
                          use_flash: bool = True,
                          layout: str = "bhld") -> torch.Tensor:
    """Attention dispatch by the rules in the module docstring.
    ``layout='blhd'`` passes [b, l, h, d] operands straight to the flash
    kernel and the chunked tier; tiers that need [b, h, l, d] get
    transposed views."""
    get_telemetry().counter("attn/calls")
    blhd = layout == "blhd"
    if _ring_scope:
        why = _ring_unavailable_reason(causal, bias, q, k, blhd)
        if why is not None:
            raise NotImplementedError(
                f"dot_product_attention inside a sequence-parallel step: "
                f"{why}")
        impl, tier = "ring", "ring"
    else:
        impl, tier = _select_impl(q, k, v, bias, use_flash, causal, blhd)
    tier_policy.publish_tier(_dims(q, k, blhd)[1], q.shape[-1], causal, tier)
    if impl == "ring":
        group = _ring_scope[-1] if _ring_scope else _ring_ctx["group"]
        if blhd:
            return _RingFn.apply(q, k, v, group, causal)
        tr = lambda t: t.transpose(1, 2)
        return tr(_RingFn.apply(tr(q), tr(k), tr(v), group, causal))
    if impl == "plain":
        return _materialized(q, k, v, causal, bias, layout)
    if impl == "xla":
        return xla_attention(q, k, v, causal, bias, layout)
    if impl == "blockwise":
        if not blhd:
            return blockwise_attention(q, k, v, causal, bias=bias)
        tr = lambda t: t.transpose(1, 2)
        return tr(blockwise_attention(tr(q), tr(k), tr(v), causal,
                                      bias=bias))
    if bias is None:
        return flash_attention(q, k, v, causal=causal, layout=layout)
    return flash_attention(q, k, v, causal=causal, layout=layout,
                           key_bias=_key_bias(bias, q.shape[0],
                                              _dims(q, k, blhd)[2]))


# ---------------------------------------------------------------------------
# Ring attention (the sequence split over a group of ranks)
# ---------------------------------------------------------------------------
_ring_ctx = {"mesh": None, "axis": None, "group": None}
_ring_scope: list = []  # the groups of the engines' steps, innermost last


def set_ring_context(mesh, axis: Optional[str], batch_axis=None,
                     group=None) -> None:
    """Register the mesh axis that carries sequence shards for
    ``PADDLE_TPU_ATTN_POLICY=ring`` outside an engine (an engine with
    ``sp_axis`` routes its own steps through ``ring_scope``; ``mesh=None``
    clears the registration). ``group`` is that axis's
    ``communication.Group`` holding this rank (default
    ``mesh.group(axis)``). ``batch_axis`` is the reference's argument and
    is not needed here: each rank already holds only its rows."""
    if mesh is None or axis is None:
        _ring_ctx.update(mesh=None, axis=None, group=None)
        return
    _ring_ctx.update(mesh=mesh, axis=axis,
                     group=group if group is not None else mesh.group(axis))


class ring_scope:
    """Within (an engine's forward and backward): causal self-attention
    runs as ``ring_attention`` over ``group``, and
    ``ring_position_offset`` gives this rank's first position."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        _ring_scope.append(self.group)
        return self

    def __exit__(self, *exc):
        _ring_scope.pop()
        return False


def _ring_group():
    if _ring_scope:
        return _ring_scope[-1]
    if tier_policy.policy_mode() == "ring":
        return _ring_ctx["group"]
    return None


def ring_position_offset(l_local: int) -> int:
    """The global position of this rank's first token when the sequence
    is split over a ring (``rank_in_group · l_local``), else 0."""
    group = _ring_group()
    return group.rank * int(l_local) if group is not None else 0


def _ring_unavailable_reason(causal, bias, q, k, blhd) -> Optional[str]:
    """Why the ring cannot take this call, or None."""
    group = _ring_scope[-1] if _ring_scope else _ring_ctx["group"]
    if group is None:
        return ("no ring is registered (ParallelTrainStep(sp_axis=...) / "
                "ops.attention.set_ring_context)")
    if bias is not None:
        return "the ring takes no attention bias"
    _, L, Lk = _dims(q, k, blhd)
    if Lk != L:
        return f"Lq {L} != Lk {Lk} (self-attention only)"
    return None


def ring_hop_forward(q, k, v, rank: int, src: int, causal: bool):
    """One hop: queries of shard ``rank`` against the resident keys and
    values of shard ``src`` ([b, L, H, d] each), through #1 (causal on
    the diagonal, full mode below it). Returns ``(out, lse)``, or None for
    a causal hop above the diagonal."""
    if causal and src > rank:
        return None
    return flash_tpu._fwd(q, k, v, causal and src == rank, None)


def ring_merge(acc, lse_acc, out, lse):
    """Fold a hop's ``(out, lse)`` into the f32 accumulators (None at the
    first hop): ``lse' = logaddexp``, each output weighted by
    ``exp(lse − lse')``."""
    if acc is None:
        return out.float(), lse
    new = torch.logaddexp(lse_acc, lse)
    w_old = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse - new).transpose(1, 2)[..., None]
    return acc * w_old + out.float() * w_new, new


def ring_hop_backward(q, k, v, dout, lse, out, rank: int, src: int,
                      causal: bool):
    """One hop of the backward with the merged ``lse`` and output:
    ``(dq, dk, dv)`` of this rank's queries against shard ``src``'s keys
    and values (#2 then #3; delta is the dQ kernel's, from the merged
    output), or None above the diagonal."""
    if causal and src > rank:
        return None
    hop_causal = causal and src == rank
    dq, delta = flash_tpu._dq(hop_causal, q, k, v, dout, lse, out)
    dk, dv = flash_tpu._dkv(hop_causal, q, k, v, dout, lse, delta)
    return dq, dk, dv


def ring_group_rotate(group):
    """The ``rotate`` of ``ring_forward``/``ring_backward`` for this
    process's one rank of ``group``: each tensor goes to the next rank
    and the previous rank's arrives in a new buffer, both directions
    posted in one ``batch_isend_irecv``."""
    dist = torch.distributed
    ranks, me = group.ranks, group.rank
    n = len(ranks)
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    pg = group.process_group

    def rotate(held):
        (tensors,) = held
        bufs = [torch.empty_like(t) for t in tensors]
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, nxt, group=pg) for t in tensors]
            + [dist.P2POp(dist.irecv, b, prv, group=pg) for b in bufs])

        def wait():
            for w in works:
                w.wait()

        return [tuple(bufs)], wait

    return rotate


def ring_list_rotate(held):
    """The ``rotate`` of ``ring_forward``/``ring_backward`` when one
    process holds every rank of the ring: rank r takes rank r − 1's
    tensors."""
    n = len(held)
    return [held[(r - 1) % n] for r in range(n)], lambda: None


def ring_forward(qs, ks, vs, ranks, n: int, causal: bool, rotate):
    """The ring's forward for the ranks ``ranks`` of an ``n``-rank ring
    that the caller holds (its own in a process group, all n in one
    process): ``qs``/``ks``/``vs`` are their shards ([b, L_local, H, d]).
    ``rotate(held)`` starts moving each held rank's tensors to the next
    rank and returns ``(received, wait)``; the received tensors are
    read after ``wait()``, so the next hop's transfer overlaps this
    hop's kernels. Returns each rank's output (q's dtype) and merged lse
    ([b, H, L_local] f32, contiguous)."""
    kv = [(k.contiguous(), v.contiguous()) for k, v in zip(ks, vs)]
    acc, lse = [None] * len(qs), [None] * len(qs)
    for i in range(n):
        nxt = wait = None
        if i < n - 1:
            nxt, wait = rotate(kv)
        for j, r in enumerate(ranks):
            src = (r - i) % n
            hop = ring_hop_forward(qs[j], *kv[j], r, src, causal)
            if hop is not None:
                acc[j], lse[j] = ring_merge(acc[j], lse[j], *hop)
        if wait is not None:
            wait()
            kv = nxt
    return ([a.to(q.dtype) for a, q in zip(acc, qs)],
            [x.contiguous() for x in lse])


def ring_backward(qs, ks, vs, douts, lses, outs, ranks, n: int,
                  causal: bool, rotate):
    """The ring's backward for the held ranks (see ``ring_forward``),
    from their merged outputs and lse: each hop adds its dQ to the rank's
    own and its partial dK and dV to the resident shard's, which travel
    with the shard and arrive home after a full turn. Returns each rank's
    f32 ``(dqs, dks, dvs)``."""
    kv = [(k.contiguous(), v.contiguous()) for k, v in zip(ks, vs)]
    f32 = lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device)
    dq, dk, dv = [f32(q) for q in qs], [f32(k) for k in ks], \
        [f32(v) for v in vs]
    for i in range(n):
        for j, r in enumerate(ranks):
            src = (r - i) % n
            hop = ring_hop_backward(qs[j], *kv[j], douts[j], lses[j],
                                    outs[j], r, src, causal)
            if hop is not None:
                dq[j] += hop[0].float()
                dk[j] += hop[1].float()
                dv[j] += hop[2].float()
        if n > 1:
            last = i == n - 1
            moving = [(dk[j], dv[j]) if last else (*kv[j], dk[j], dv[j])
                      for j in range(len(qs))]
            got, wait = rotate(moving)
            wait()
            if not last:
                kv = [g[:2] for g in got]
            dk, dv = [g[-2] for g in got], [g[-1] for g in got]
    return dq, dk, dv


class _RingFn(torch.autograd.Function):
    """The ring over ``group`` ([b, L_local, H, d] operands): this rank's
    part of ``ring_forward`` and ``ring_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        r, n = group.rank, group.nranks
        outs, lses = ring_forward([q], [k], [v], [r], n, causal,
                                  ring_group_rotate(group))
        out, lse = outs[0], lses[0]
        ctx.group, ctx.causal = group, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        (dq,), (dk,), (dv,) = ring_backward(
            [q], [k], [v], [dout.contiguous()], [lse], [out], [group.rank],
            group.nranks, ctx.causal, ring_group_rotate(group))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None)


def ring_attention(q, k, v, axis_name, causal=False, block_k=512):
    """Attention of [b, h, L_local, d] operands whose sequence is split
    over ``axis_name`` (a mesh axis of the global mesh, or a
    ``communication.Group``), as the reference's; see the module
    docstring. ``block_k`` is the reference's argument: a shard is one
    block."""
    group = axis_name
    if isinstance(axis_name, str):
        from ..distributed.fleet.mesh_utils import get_mesh

        mesh = get_mesh()
        if mesh is None:
            raise ValueError(f"ring_attention over {axis_name!r}: no global "
                             "mesh (fleet.mesh_utils.init_mesh)")
        group = mesh.group(axis_name)
    tr = lambda t: t.transpose(1, 2)
    return tr(_RingFn.apply(tr(q), tr(k), tr(v), group, causal))


# ---------------------------------------------------------------------------
# Paged attention (decode over the serving KV-cache pool)
# ---------------------------------------------------------------------------
# Positions are logical: token p of a sequence lives in table slot
# p // block_size at offset p % block_size, so slot index IS position.
# int8 pages carry one f32 scale per token-head and are widened
# (``quant.dequantize_kv``) where they are read.

def _paged_widen(x, scale):
    """Gathered pages (int8 with their scales, or float) in f32."""
    if scale is None:
        return x.float()
    from ..quant import dequantize_kv

    return dequantize_kv(x, scale)


def _paged_mask(k_pos, q_positions, kv_lens):
    """[B, T, K] bool: causal (k_pos <= q_pos) AND within the written
    prefix (k_pos < kv_len) — the second clause keeps padded table slots
    and stale post-eviction entries unreadable."""
    return ((k_pos[None, None, :] <= q_positions[:, :, None])
            & (k_pos[None, None, :] < kv_lens[:, None, None]))


def _paged_gather_impl(q, k_pages, v_pages, block_tables, q_positions,
                       kv_lens, k_scale=None, v_scale=None):
    """q: [B, T, H, D]; k_pages/v_pages: [N, bs, H, D] (+ [N, bs, H]
    scales for int8 pools); block_tables: [B, M] int; q_positions:
    [B, T] int global positions; kv_lens: [B] int valid prefix. One
    gather of the whole context, then one masked softmax."""
    B, T, H, D = q.shape
    bs = k_pages.shape[1]
    M = block_tables.shape[1]
    tables = block_tables.long()
    k = _paged_widen(k_pages[tables], None if k_scale is None
                     else k_scale[tables]).reshape(B, M * bs, H, D)
    v = _paged_widen(v_pages[tables], None if v_scale is None
                     else v_scale[tables]).reshape(B, M * bs, H, D)
    s = torch.einsum("bthd,bkhd->bhtk", q.float() / math.sqrt(D), k)
    k_pos = torch.arange(M * bs, device=q.device)
    mask = _paged_mask(k_pos, q_positions, kv_lens)
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhtk,bkhd->bthd", p, v).to(q.dtype)


def _paged_scan_impl(q, k_pages, v_pages, block_tables, q_positions,
                     kv_lens, k_scale=None, v_scale=None):
    """Online-softmax loop over table slots — the flash recurrence over
    pages; only one [B, bs, H, D] page pair is live (and, for int8
    pools, dequantized) per step."""
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
        kc = _paged_widen(k_pages[pids], None if k_scale is None
                          else k_scale[pids])  # [B, bs, H, D]
        vc = _paged_widen(v_pages[pids], None if v_scale is None
                          else v_scale[pids])
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
        k_scale/v_scale: [N, bs, H] f32 per-token-head scales when the
            pool stores int8 (``quant.quantize_kv``), else None.

    The tier is ``tier_policy.select_paged``'s (the heuristic unless
    ``PADDLE_TPU_ATTN_PAGED_POLICY`` forces a tier or ``bench``), published
    as ``gauge/attn/tier.paged.t<T>.d<D>``.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: int8 pages need both k_scale "
                         "and v_scale")
    get_telemetry().counter("attn/calls")
    B, T, H, D = q.shape
    tier = tier_policy.select_paged(T, H, D, block_tables.shape[1],
                                    k_pages.shape[1], k_pages.dtype,
                                    k_scale is not None, device=q.device)
    get_telemetry().gauge(f"attn/tier.paged.t{T}.d{D}",
                          tier_policy.TIER_IDS[tier])
    impl = (_paged_gather_impl if tier == "paged_gather"
            else _paged_scan_impl)
    return impl(q, k_pages, v_pages, block_tables, q_positions, kv_lens,
                k_scale, v_scale)
