"""GPT family — counterpart of ``paddle_tpu.text.models.gpt``: the
forward of ``GPTForCausalLM`` (with the training loss when labels are
given) and the KV-cached ``gpt_decode_fns`` for serving.

Layout follows the reference so weights cross over unchanged: a
``Linear`` (``nn.layer.common``) keeps its weight as [in, out] and
computes ``x @ W + b``, and parameters carry the reference's names
(``gpt.h.{i}.attn.qkv.weight``, ...; see ``jit.functionalize``). The LM
head is tied to ``wte``, the MLP uses tanh-approximated GELU, every
LayerNorm goes through ``ops.fused.fused_layer_norm`` (``nn.layer.norm``)
and attention through
``ops.attention.dot_product_attention`` (the flash kernel on the card;
``GPTConfig.use_flash_attention=False`` takes the blockwise tier, as in
the reference), both differentiable. Dropout draws its masks from a
``torch.Generator`` the model owns, seeded from the constructor's
``seed``.

``GPTConfig.fused_head_ce`` (off by default, as in the reference) makes
the training forward compute the head and the loss through
``nn.functional.loss.fused_linear_hard_ce`` (one joint backward, the
[N, V] dlogits made once) and return the mean over the labels that are
not ignored, in the head's dtype. The reference's ``manual_layer_norm``
selects an XLA lowering and has no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...core.place import resolve_device
from ...amp.auto_cast import maybe_cast_inputs
from ...nn.functional.loss import cross_entropy, fused_linear_hard_ce
from ...nn.layer.common import Dropout, Embedding, Linear
from ...nn.layer.common import linear as _linear
from ...nn.layer.norm import LayerNorm
from ...ops.attention import dot_product_attention, paged_attention
from ...ops.fused import fused_layer_norm
from ...quant import quantize_kv

__all__ = ["GPTConfig", "GPT", "GPTForCausalLM", "gpt2_small", "gpt2_medium",
           "gpt2_tiny", "gpt_decode_fns"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    intermediate_size: int = 0  # 0 -> 4*hidden
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True
    fused_head_ce: bool = False

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, gen: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = Linear(h, 3 * h, device=device, dtype=dtype)
        self.proj = Linear(h, h, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout, generator=gen)
        self.use_flash = config.use_flash_attention

    def forward(self, x):
        b, l, h = x.shape
        # q/k/v stay views of the fused projection: the kernel reads them
        # at its row stride of 3h, with no split copy or transpose
        q, k, v = (t.view(b, l, self.num_heads, self.head_dim)
                   for t in self.qkv(x).split(h, dim=-1))
        o = dot_product_attention(q, k, v, causal=True,
                                  use_flash=self.use_flash, layout="blhd")
        return self.dropout(self.proj(o.reshape(b, l, h)))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, gen: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        self.fc = Linear(config.hidden_size, config.intermediate_size,
                         device=device, dtype=dtype)
        self.proj = Linear(config.intermediate_size, config.hidden_size,
                           device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout, generator=gen)

    def forward(self, x):
        return self.dropout(self.proj(F.gelu(self.fc(x), approximate="tanh")))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, gen: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, device=device,
                              dtype=dtype)
        self.attn = GPTAttention(config, gen, device, dtype)
        self.ln_2 = LayerNorm(config.hidden_size, eps, device=device,
                              dtype=dtype)
        self.mlp = GPTMLP(config, gen, device, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT(nn.Module):
    """The decoder stack. Its dropout masks come from ``dropout_gen``, a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dropout_gen = torch.Generator(device=device).manual_seed(seed)
        gen = self.dropout_gen
        kw = dict(device=device, dtype=dtype)
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.drop = Dropout(config.hidden_dropout, generator=gen)
        self.h = nn.ModuleList([GPTBlock(config, gen, device, dtype)
                                for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids):
        l = input_ids.shape[1]
        pos = torch.arange(l, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head tied to wte (standard GPT-2 weight tying).

    Weights are drawn from ``seed`` with an explicit ``torch.Generator``
    on ``device`` (default ``"cuda"``), and dropout masks from a second
    generator with the same seed: Normal(0, initializer_range) for
    embeddings and projections, scaled by 1/sqrt(2·num_layers) for the two
    residual-branch output projections, zero biases, unit LayerNorm
    gains — the reference's initializers. ``jit.functionalize.
    load_jax_params`` overwrites them with the reference's own weights.
    """

    def __init__(self, config: GPTConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.gpt = GPT(config, device, dtype, seed)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        std = self.config.initializer_range
        out_std = std / math.sqrt(2 * self.config.num_layers)
        for name, p in self.named_parameters():
            if name.endswith(("wte.weight", "wpe.weight", "qkv.weight",
                              "fc.weight")):
                p.normal_(0.0, std, generator=gen)
            elif name.endswith("proj.weight"):
                p.normal_(0.0, out_std, generator=gen)

    def forward(self, input_ids, labels=None):
        """Logits [b, l, vocab] or, given ``labels`` [b, l], the scalar
        mean cross entropy (the reference's training forward)."""
        h = self.gpt(input_ids)
        if labels is not None and self.config.fused_head_ce:
            h2, w = maybe_cast_inputs("linear", h.reshape(-1, h.shape[-1]),
                                      self.gpt.wte.weight)
            loss, mask = fused_linear_hard_ce(h2, w.t(), labels.reshape(-1))
            return (loss.sum() / mask.sum().clamp(min=1.0)).to(loss.dtype)
        logits = F.linear(h, self.gpt.wte.weight)
        if labels is not None:
            return self.loss_fn(logits, labels)
        return logits

    def loss_fn(self, logits, labels):
        return cross_entropy(logits.reshape(-1, self.config.vocab_size),
                             labels.reshape(-1))


def gpt_decode_fns(config: GPTConfig, kv_dtype: str = "float32"):
    """KV-cached forward for token serving
    (``inference.serving.decode``): one function covers chunked prefill
    and single-token decode — "advance the cache by a T-token chunk and
    return the chunk's logits".

    Returns ``forward_chunk(params, tokens, q_positions, pages,
    block_tables, kv_lens) -> (logits [B, T, V], pages)`` where ``params``
    is the flat ``jit.functionalize.get_params`` dict of a
    ``GPTForCausalLM`` and ``pages`` a ``KVCachePool.pages`` dict. Each
    layer writes the chunk's K/V into its pages, then attends through
    ``ops.attention.paged_attention``. Unlike the reference (where pages
    are immutable and donated), the pages are updated IN PLACE and the
    same dict is returned: the pool is the largest serving buffer and is
    never copied. Masked-out tokens (padded rows, padded chunk tails —
    q_position >= kv_len) write into the scratch page 0. An int8 pool
    (``kv_dtype='int8'``) quantizes the chunk's K/V on write
    (``quant.quantize_kv``, one scale per token-head into
    ``pages['k_scale'] / pages['v_scale']``) and the attention reads them
    back through the scales.
    """
    if kv_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r} not in ('float32', "
                         "'bfloat16', 'int8')")
    quantized = kv_dtype == "int8"
    nh = config.num_heads
    hd = config.hidden_size // nh
    hsz = config.hidden_size
    eps = config.layer_norm_epsilon
    max_pos = config.max_position_embeddings
    store = getattr(torch, kv_dtype)
    names = ("ln_1.weight", "ln_1.bias", "attn.qkv.weight", "attn.qkv.bias",
             "attn.proj.weight", "attn.proj.bias", "ln_2.weight",
             "ln_2.bias", "mlp.fc.weight", "mlp.fc.bias", "mlp.proj.weight",
             "mlp.proj.bias")
    layer_keys = [[f"gpt.h.{i}.{n}" for n in names]
                  for i in range(config.num_layers)]

    def forward_chunk(params: Dict[str, torch.Tensor], tokens, q_positions,
                      pages, block_tables, kv_lens):
        B, T = tokens.shape
        bs = pages["k"].shape[2]
        q_positions = q_positions.long()
        valid = q_positions < kv_lens[:, None]
        width = block_tables.shape[1]
        page_idx = torch.gather(block_tables.long(), 1,
                                (q_positions // bs).clamp(0, width - 1))
        page_idx = torch.where(valid, page_idx, torch.zeros_like(page_idx))
        slot = q_positions % bs
        pos = q_positions.clamp(0, max_pos - 1)
        x = params["gpt.wte.weight"][tokens.long()] \
            + params["gpt.wpe.weight"][pos]
        for i, keys in enumerate(layer_keys):
            (ln1w, ln1b, qkvw, qkvb, projw, projb, ln2w, ln2b, fcw, fcb,
             mprojw, mprojb) = (params[k] for k in keys)
            h = fused_layer_norm(x, ln1w, ln1b, eps)
            q3, k3, v3 = (t.reshape(B, T, nh, hd)
                          for t in _linear(h, qkvw, qkvb).split(hsz, dim=-1))
            if quantized:
                for name, t in (("k", k3), ("v", v3)):
                    tq, ts = quantize_kv(t)
                    pages[name][i, page_idx, slot] = tq
                    pages[name + "_scale"][i, page_idx, slot] = ts
                scales = (pages["k_scale"][i], pages["v_scale"][i])
            else:
                pages["k"][i, page_idx, slot] = k3.to(store)
                pages["v"][i, page_idx, slot] = v3.to(store)
                scales = (None, None)
            o = paged_attention(q3, pages["k"][i], pages["v"][i],
                                block_tables, q_positions, kv_lens, *scales)
            x = x + _linear(o.reshape(B, T, hsz), projw, projb)
            h2 = fused_layer_norm(x, ln2w, ln2b, eps)
            h2 = F.gelu(_linear(h2, fcw, fcb), approximate="tanh")
            x = x + _linear(h2, mprojw, mprojb)
        x = fused_layer_norm(x, params["gpt.ln_f.weight"],
                             params["gpt.ln_f.bias"], eps)
        return F.linear(x, params["gpt.wte.weight"]), pages

    return forward_chunk


# Each preset's fields can be overridden by keyword (``num_layers=2`` cuts
# the depth and keeps the widths).
def gpt2_tiny(**kw):
    return GPTConfig(**{**dict(vocab_size=1024, hidden_size=128,
                               num_layers=4, num_heads=4,
                               max_position_embeddings=256,
                               hidden_dropout=0.0, attention_dropout=0.0),
                        **kw})


def gpt2_small(**kw):
    return GPTConfig(**{**dict(hidden_size=768, num_layers=12,
                               num_heads=12), **kw})


def gpt2_medium(**kw):
    """GPT-2 345M."""
    return GPTConfig(**{**dict(hidden_size=1024, num_layers=24,
                               num_heads=16), **kw})
