"""Common layers — counterpart of ``paddle_tpu.nn.layer.common``, kept to
what the ported models use.

``Linear`` keeps the reference's [in, out] weight layout (``x @ W + b``),
so weights cross over from the reference without a transpose.
``Dropout`` draws its masks from an explicit ``torch.Generator`` (the
model's), never from torch's global RNG. Parameters are made
uninitialized unless a ``generator`` is given: GPT and BERT fill theirs
from their own seeded generators; the vision models pass theirs, and
``Linear`` draws the reference's default (Xavier-uniform weight, zero
bias) from it.

``linear`` is on the AMP white list: under ``amp.auto_cast`` it casts
``x`` and the weight to the AMP dtype (and the bias to the product's);
with AMP off it is ``F.linear`` on its arguments as given.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...amp.auto_cast import maybe_cast_inputs

__all__ = ["Linear", "Dropout", "Embedding", "linear"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ weight + bias`` with the reference's [in, out] weight."""
    x, weight = maybe_cast_inputs("linear", x, weight)
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return F.linear(x, weight.t(), bias)


class Linear(nn.Module):
    """Dense layer in the reference's layout: weight [in, out]."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = nn.Parameter(torch.zeros(out_features, **kw))
        if generator is not None:
            # the reference's XavierUniform: fans of an [in, out] matrix
            limit = math.sqrt(6.0 / (in_features + out_features))
            with torch.no_grad():
                self.weight.copy_(torch.empty(
                    in_features, out_features).uniform_(
                        -limit, limit, generator=generator))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator (the
    model's), never from torch's global RNG. The identity in eval mode
    or at ``p == 0``."""

    def __init__(self, p: float, generator: torch.Generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - self.p, generator=self.generator)
        return x * keep.to(x.dtype) / (1.0 - self.p)


class Embedding(nn.Module):
    """Lookup table, weight [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return F.embedding(ids, self.weight)
