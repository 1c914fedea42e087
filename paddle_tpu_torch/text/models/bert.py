"""BERT / ERNIE family — counterpart of ``paddle_tpu.text.models.bert``:
the post-LN encoder, its pretraining heads (masked LM tied to the word
embedding, next-sentence prediction) and the sequence classifier.

Parameters carry the reference's names (``bert.embeddings.word.weight``,
``bert.encoder.{i}.attn.qkv.weight``, ``mlm_transform.weight``, ...) and
``Linear`` keeps its [in, out] layout, so
``jit.functionalize.load_jax_params`` carries the reference's weights
across unchanged. Attention is non-causal and goes through
``ops.attention.dot_product_attention`` with q/k/v as strided
[b, l, h, d] views of the fused QKV projection (no transpose copy): the
flash kernel on the card, the plain path on the CPU. A padding mask
(``attention_mask``) becomes the reference's additive bias on the padded
keys, which the full-attention kernels take on the card as a key bias
(forward, dQ and dK/dV). The reference's TPU tuning knob
``use_flash_attention`` has no
counterpart. Every LayerNorm goes through ``ops.fused``. Dropout masks
come from a ``torch.Generator`` the model owns, seeded from ``seed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...core.place import resolve_device
from ...nn.functional.loss import cross_entropy
from ...nn.layer.common import Dropout, Embedding, Linear
from ...nn.layer.norm import LayerNorm
from ...ops.attention import dot_product_attention

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_base", "bert_large",
           "bert_tiny", "ErnieModel", "ernie_3_0_medium", "ernie_1_5b"]


@dataclass
class BertConfig:
    vocab_size: int = 30528
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-12


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, gen: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = Linear(h, 3 * h, device=device, dtype=dtype)
        self.proj = Linear(h, h, device=device, dtype=dtype)
        self.dropout = Dropout(config.attention_dropout, generator=gen)

    def forward(self, x, attn_bias=None):
        b, l, h = x.shape
        # q/k/v stay views of the fused projection: the kernel reads them
        # at their row stride of 3h, with no split copy or transpose
        q, k, v = (t.view(b, l, self.num_heads, self.head_dim)
                   for t in self.qkv(x).split(h, dim=-1))
        o = dot_product_attention(q, k, v, causal=False, bias=attn_bias,
                                  layout="blhd")
        return self.dropout(self.proj(o.reshape(b, l, h)))


class BertLayer(nn.Module):
    """Post-LN encoder block (the original BERT residual structure)."""

    def __init__(self, config: BertConfig, gen: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.attn = BertSelfAttention(config, gen, device, dtype)
        self.ln1 = LayerNorm(h, eps, device=device, dtype=dtype)
        self.fc1 = Linear(h, config.intermediate_size, device=device,
                          dtype=dtype)
        self.fc2 = Linear(config.intermediate_size, h, device=device,
                          dtype=dtype)
        self.ln2 = LayerNorm(h, eps, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout, generator=gen)

    def forward(self, x, attn_bias=None):
        x = self.ln1(x + self.attn(x, attn_bias))
        y = self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.ln2(x + self.dropout(y))


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, gen: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        h = config.hidden_size
        self.word = Embedding(config.vocab_size, h, device=device,
                              dtype=dtype)
        self.position = Embedding(config.max_position_embeddings, h,
                                  device=device, dtype=dtype)
        self.token_type = Embedding(config.type_vocab_size, h,
                                    device=device, dtype=dtype)
        self.ln = LayerNorm(h, config.layer_norm_epsilon, device=device,
                           dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout, generator=gen)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.word(input_ids) + self.position(pos) \
            + self.token_type(token_type_ids)
        return self.dropout(self.ln(x))


# weights the reference draws from Normal(0, initializer_range); the other
# Linear weights take its default Xavier init, biases 0, LayerNorm gains 1
_NORMAL_INIT = ("word.weight", "position.weight", "token_type.weight",
                "qkv.weight", "proj.weight", "fc1.weight", "fc2.weight")


@torch.no_grad()
def _init_weights(model: nn.Module, config: BertConfig, device,
                  seed: int) -> None:
    """Fill every parameter of ``model`` from one generator seeded with
    ``seed``, by the reference's initializers. The encoder's parameters
    come first in every model, so a head model's encoder gets the same
    values as a ``BertModel`` of the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(_NORMAL_INIT):
            p.normal_(0.0, config.initializer_range, generator=gen)
        elif p.dim() == 2:
            bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
            p.uniform_(-bound, bound, generator=gen)
        elif name.endswith("weight"):  # the 1-D weights: LayerNorm gains
            p.fill_(1.0)
        else:
            p.zero_()


class BertModel(nn.Module):
    """The encoder; ``forward`` returns ``(sequence_output, pooled)``.

    Weights are drawn from ``seed`` on ``device`` (default ``"cuda"``),
    dropout masks from ``dropout_gen``, a second generator with the same
    seed. ``attention_mask`` ([b, l], 1 = attend, 0 = padding) becomes
    the reference's additive −1e9 bias on the padded keys; on the card
    the attention kernels read it as a key bias."""

    def __init__(self, config: BertConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dropout_gen = torch.Generator(device=device).manual_seed(seed)
        gen = self.dropout_gen
        self.embeddings = BertEmbeddings(config, gen, device, dtype)
        self.encoder = nn.ModuleList([BertLayer(config, gen, device, dtype)
                                      for _ in range(config.num_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             device=device, dtype=dtype)
        _init_weights(self, config, device, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        attn_bias = None
        if attention_mask is not None:
            # [b, l] 1/0 mask -> additive bias broadcastable to
            # [b, h, lq, lk]
            attn_bias = (1.0 - attention_mask.float())[:, None, None, :] \
                * -1e9
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_bias)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is >= 0 (the
    reference's ``masked_ce``). The log-softmax runs in the logits' dtype,
    as ``jax.nn.log_softmax`` does in the reference; the picked
    log-probabilities are summed in f32."""
    v = logits.shape[-1]
    lg = logits.reshape(-1, v)
    lab = labels.reshape(-1)
    valid = lab >= 0
    logp = torch.log_softmax(lg, dim=-1)
    picked = logp.gather(-1, torch.where(valid, lab, 0).long()[:, None])
    from ...distributed.parallel import mean_denominator

    # the count over the global batch inside a data-parallel engine
    return -(picked[:, 0].float() * valid).sum() / mean_denominator(
        valid.sum())


class BertForPretraining(nn.Module):
    """Masked-LM and next-sentence heads over ``BertModel`` (the
    reference's BertPretrainingCriterion); the MLM decoder is tied to the
    word embedding, with no bias."""

    def __init__(self, config: BertConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device, dtype, seed)
        h = config.hidden_size
        self.mlm_transform = Linear(h, h, device=device, dtype=dtype)
        self.mlm_ln = LayerNorm(h, config.layer_norm_epsilon, device=device,
                           dtype=dtype)
        self.nsp = Linear(h, 2, device=device, dtype=dtype)
        _init_weights(self, config, device, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(MLM logits [b, l, vocab], NSP logits [b, 2])."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        x = self.mlm_ln(F.gelu(self.mlm_transform(seq), approximate="tanh"))
        logits = F.linear(x, self.bert.embeddings.word.weight)
        return logits, self.nsp(pooled)

    def loss_fn(self, outputs, mlm_labels, nsp_labels=None):
        """Masked-LM loss over the labels >= 0 (-100 = not masked), plus
        the NSP cross entropy when ``nsp_labels`` are given."""
        logits, nsp_logits = outputs
        loss = _masked_ce(logits, mlm_labels)
        if nsp_labels is not None:
            loss = loss + cross_entropy(nsp_logits, nsp_labels)
        return loss


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(config, device, dtype, seed)
        self.dropout = Dropout(config.hidden_dropout,
                               generator=self.bert.dropout_gen)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=device, dtype=dtype)
        _init_weights(self, config, device, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieModel(BertModel):
    """ERNIE (the reference's is a BERT-architecture encoder with
    knowledge-masking pretraining; the model graph is identical)."""


# Each preset's fields can be overridden by keyword (``num_layers=2`` cuts
# the depth and keeps the widths).
def bert_tiny(**kw):
    return BertConfig(**{**dict(vocab_size=1024, hidden_size=128,
                                num_layers=2, num_heads=2,
                                intermediate_size=512,
                                max_position_embeddings=128,
                                hidden_dropout=0.0, attention_dropout=0.0),
                         **kw})


def bert_base(**kw):
    """BERT-base: 12 layers, hidden 768, 12 heads, vocab 30528."""
    return BertConfig(**kw)


def bert_large(**kw):
    return BertConfig(**{**dict(hidden_size=1024, num_layers=24,
                                num_heads=16, intermediate_size=4096), **kw})


def ernie_3_0_medium(**kw):
    return BertConfig(**{**dict(vocab_size=40064, hidden_size=768,
                                num_layers=6, num_heads=12,
                                intermediate_size=3072), **kw})


def ernie_1_5b(**kw):
    return BertConfig(**{**dict(vocab_size=40064, hidden_size=2048,
                                num_layers=24, num_heads=16,
                                intermediate_size=8192,
                                max_position_embeddings=2048), **kw})
