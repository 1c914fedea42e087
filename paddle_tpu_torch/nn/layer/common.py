"""Common layers — counterpart of ``paddle_tpu.nn.layer.common``, kept to
what the ported models use.

``Linear`` keeps the reference's [in, out] weight layout (``x @ W + b``),
so weights cross over from the reference without a transpose.
``Dropout`` draws its masks from an explicit ``torch.Generator`` (the
model's), never from torch's global RNG. Parameters are made
uninitialized: each model fills them from its own seeded generator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Linear", "Dropout", "Embedding", "linear"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ weight + bias`` with the reference's [in, out] weight."""
    return F.linear(x, weight.t(), bias)


class Linear(nn.Module):
    """Dense layer in the reference's layout: weight [in, out]."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = nn.Parameter(torch.zeros(out_features, **kw))

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
