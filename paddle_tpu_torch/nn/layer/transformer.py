"""Transformer layers — counterpart of ``paddle_tpu.nn.layer.transformer``:
``MultiHeadAttention`` (with its ``Cache`` and ``StaticCache``), the
encoder and decoder layers and stacks, and ``Transformer``.

The attention is the reference's own product and softmax, not the
attention dispatch: ``softmax(q kᵀ · d^-½ + mask) v`` over [B, H, L, d]
with ``torch.einsum``; with dropout the weights are dropped and the
second product taken again, as the reference does. A bool mask becomes
``0`` where True and ``-1e9`` where False, in q's dtype; a float mask
(``generate_square_subsequent_mask``'s ``-inf`` included) is added as
given; mixed dtypes promote as ``jnp`` does. The LayerNorms of the
residual stream are ``nn.LayerNorm``: the LayerNorm kernels #5 and #6 on
the card.

Incremental decoding: ``gen_cache`` gives a ``Cache`` (keys and values so
far, starting from [B, H, 0, d] zeros on the input's device and dtype) for
self-attention and a ``StaticCache`` (the memory's projected keys and
values) for cross-attention; a forward given a cache returns the new one
beside its output.

As in the reference, ``TransformerEncoder`` / ``TransformerDecoder`` hold
``num_layers`` deep copies of the layer they are given, so every layer
starts from the same weights. Parameters are drawn from the
initializers' generator (``nn.initializer.seed``), on the card unless
``device=`` says otherwise; ``generator=`` is the ``torch.Generator`` (on
the activations' device) every dropout of the layer draws its masks
from, else each dropout draws from its own. A copy shares the caller's
generator; a dropout with a generator of its own gets a fresh seed in
each copy.
"""
from __future__ import annotations

import collections
import copy
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.place import resolve_device
from .. import functional as F
from .. import initializer as I
from .common import Dropout, Linear, _RandomLayer
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, 0.0, -1e9).to(dtype)


def _promoted(a, b):
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _split_heads(t, nh, hd):
    return t.reshape(t.shape[0], t.shape[1], nh, hd).transpose(1, 2)


class MultiHeadAttention(_RandomLayer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _prepare_qkv(self, query, key, value, cache=None):
        nh, hd = self.num_heads, self.head_dim
        q = _split_heads(self.q_proj(query), nh, hd)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = _split_heads(self.k_proj(key), nh, hd)
            v = _split_heads(self.v_proj(value), nh, hd)
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], 2)
            v = torch.cat([cache.v, v], 2)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key`` / ``value``'s projections when
        ``type`` is ``StaticCache``, else an empty ``Cache``."""
        nh, hd = self.num_heads, self.head_dim
        if type == MultiHeadAttention.StaticCache:
            k = self.k_proj(key)
            v = self.v_proj(value if value is not None else key)
            return self.StaticCache(_split_heads(k, nh, hd),
                                    _split_heads(v, nh, hd))
        empty = key.new_zeros(key.shape[0], nh, 0, hd)
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (
            1.0 / math.sqrt(self.head_dim))
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1)
        if self.dropout:
            drawn = self.training and self.dropout != 1.0
            weights = F.dropout(weights, self.dropout,
                                training=self.training,
                                generator=self._gen(weights) if drawn
                                else None)
        out = torch.einsum("bhqk,bhkd->bhqd", *_promoted(weights, v))
        out = out.transpose(1, 2).reshape(out.shape[0], out.shape[2],
                                          self.embed_dim)
        out = self.out_proj(out)
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _copies(layer: nn.Module, n: int) -> LayerList:
    """``[layer, deepcopy(layer), ...]``: a copy shares every generator the
    caller gave (``memo``); a dropout with a generator of its own gets a
    fresh seed from the initializers' generator."""
    memo = {id(m.generator): m.generator for m in layer.modules()
            if isinstance(m, _RandomLayer) and m.generator is not None}
    out = [layer]
    for _ in range(n - 1):
        dup = copy.deepcopy(layer, dict(memo))
        for m in dup.modules():
            if isinstance(m, _RandomLayer) and m._seed is not None:
                m._seed = int(torch.randint(2 ** 62, (1,),
                                            generator=I._generator))
                m._own = {}
        out.append(dup)
    return LayerList(out)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _copies(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _copies(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's ``(Cache, StaticCache)``; ``do_zip`` regroups them
        as ``[(caches...), (static caches...)]``."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(nn.Module):
    """The encoder-decoder of Vaswani et al. (2017); the defaults are its
    "base" model: 6 + 6 layers, d_model 512, 8 heads, d_ff 2048, dropout
    0.1, post-norm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = (LayerNorm(d_model, device=dev, dtype=dtype)
                    if normalize_before else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = (LayerNorm(d_model, device=dev, dtype=dtype)
                    if normalize_before else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length, device=None):
        """[length, length] f32: 0 on and below the diagonal, ``-inf``
        above it (on the model's device unless ``device`` is given)."""
        mask = np.triu(np.full((length, length), -np.inf, np.float32), 1)
        if device is None:
            device = next(self.parameters()).device
        return torch.from_numpy(mask).to(device)
