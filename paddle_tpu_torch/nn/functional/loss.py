"""Losses — counterpart of ``paddle_tpu.nn.functional.loss``, kept to the
softmax cross entropy the ported models and their users take.

The reference computes it at the XLA level (``_hard_ce`` for hard labels:
logsumexp minus the picked logit, with a hand-written backward;
``log_softmax`` for the other modes), not in Pallas, so plain PyTorch is
its counterpart here; autograd differentiates it. Every mode computes in
f32 and returns f32, whatever the logits' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross entropy of ``input`` logits against ``label`` along
    ``axis``, in the reference's modes:

    - hard labels (integers, shaped as ``input`` without ``axis`` or with
      it of size 1): ``logsumexp(logits) − logits[label]``; labels equal
      to ``ignore_index`` count 0; ``label_smoothing`` ε mixes the one-hot
      label with ε/C; a class ``weight`` [C] scales each row by its
      label's weight. ``"mean"`` divides the sum by the number of labels
      that are not ignored (at least 1), not by the weights' sum, as the
      reference does;
    - ``soft_label``: ``−Σ label·log_softmax(logits)`` (``label_smoothing``
      mixes the label with ε/C first); a ``weight`` scales each row by
      ``Σ label·weight``; ``"mean"`` is over every row.

    ``use_softmax=False`` takes ``input`` as probabilities (``log(max(x,
    1e-30))``). ``reduction`` is ``"mean"``, ``"sum"`` or ``"none"``
    (the per-row losses, ``axis`` removed)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    logits = input.float().movedim(axis, -1)
    classes = logits.shape[-1]
    if (not soft_label and not label_smoothing and use_softmax
            and weight is None):
        # the hard-label fast path: no [N, C] log-probabilities
        lbl = _hard(label, input.dim(), axis)
        valid = lbl != ignore_index
        picked = logits.gather(-1, lbl.clamp(min=0)[..., None])[..., 0]
        loss = (torch.logsumexp(logits, dim=-1) - picked) * valid
        return _reduce(loss, reduction, valid)
    logp = (torch.log_softmax(logits, dim=-1) if use_softmax
            else torch.log(logits.clamp(min=1e-30)))
    w = weight.float() if weight is not None else None
    if soft_label:
        soft = label.float().movedim(axis, -1)
        if label_smoothing:
            soft = soft * (1.0 - label_smoothing) + label_smoothing / classes
        loss = -(soft * logp).sum(-1)
        if w is not None:
            loss = loss * (soft * w).sum(-1)
        return _reduce(loss, reduction, None)
    lbl = _hard(label, input.dim(), axis)
    if label_smoothing:
        onehot = torch.nn.functional.one_hot(lbl.clamp(min=0), classes)
        soft = onehot * (1.0 - label_smoothing) + label_smoothing / classes
        loss = -(soft * logp).sum(-1)
    else:
        loss = -logp.gather(-1, lbl.clamp(min=0)[..., None])[..., 0]
    valid = lbl != ignore_index
    loss = loss * valid
    if w is not None:
        loss = loss * w[lbl.clamp(min=0)]
    return _reduce(loss, reduction, valid)


def _hard(label: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """Integer labels without the class axis."""
    lbl = label.long()
    if lbl.dim() == ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    return lbl


def _reduce(loss: torch.Tensor, reduction: str,
            valid: Optional[torch.Tensor]) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if valid is None:
        return loss.mean()
    return loss.sum() / valid.sum().clamp(min=1)
