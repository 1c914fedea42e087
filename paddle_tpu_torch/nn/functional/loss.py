"""Losses — counterpart of ``paddle_tpu.nn.functional.loss``, kept to the
hard-label cross entropy the GPT training loss takes.

The reference computes it at the XLA level (``_hard_ce``: logsumexp minus
the picked logit, with a hand-written backward), not in Pallas, so plain
PyTorch is its counterpart here; autograd differentiates it.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross entropy of ``input`` logits [N, C] against
    integer ``label``s [N]: ``logsumexp(logits) − logits[label]`` in f32,
    whatever the logits' dtype. Labels equal to ``ignore_index`` count 0,
    and the mean is over the other labels (at least 1), as in the
    reference's hard-label path. Returns an f32 scalar."""
    if soft_label or label_smoothing or weight is not None \
            or reduction != "mean":
        raise NotImplementedError(
            "cross_entropy: only the mean over hard labels is ported (soft "
            "labels, label smoothing, class weights and other reductions "
            "are not)")
    logits = input.float()
    valid = label != ignore_index
    picked = logits.gather(-1, label.long().clamp(min=0)[:, None])[:, 0]
    loss = (torch.logsumexp(logits, dim=-1) - picked) * valid
    return loss.sum() / valid.sum().clamp(min=1)
