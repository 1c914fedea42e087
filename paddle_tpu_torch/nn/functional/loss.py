"""Losses — counterpart of ``paddle_tpu.nn.functional.loss``.

The reference computes every loss at the XLA level, none in Pallas, so
plain PyTorch with the reference's arithmetic is the port; autograd
differentiates it. ``cross_entropy`` (``_hard_ce`` for hard labels:
logsumexp minus the picked logit; ``log_softmax`` for the other modes)
computes in f32 and returns f32, whatever the logits' dtype; the other
losses compute in their inputs' dtype, as the reference's ``jnp`` code
does.

- ``ctc_loss`` is optax's ``ctc_loss`` (the reference calls it): its
  forward recursion over time in log space with ``log(0)`` taken as
  ``-1e5``, so an infeasible alignment (a label longer than its input)
  gives a large finite loss, not torch's ``inf``.
- ``edit_distance`` is the reference's DP: one vector step per input
  token, the in-row insertion chain as ``j + cummin(cand − j)``.
- ``hsigmoid_loss`` walks the reference's default complete binary tree
  (``SimpleCode``: code ``c = label + num_classes``, node
  ``(c >> (j+1)) − 1``, bit ``(c >> j) & 1``) or a given
  ``path_table`` / ``path_code``, at a static path length with a mask.
- ``fused_linear_hard_ce`` is the LM head's matmul and hard-label CE
  with the reference's joint backward (``_flce_bwd``): the softmax is
  recomputed in f32 from the saved logits and per-row lse, one f32
  ``(p − onehot)·g`` is made in place and cast once, and both products
  (``dh``, ``dW``) read it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as TF

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "square_error_cost",
    "log_loss", "sigmoid_focal_loss", "triplet_margin_loss", "ctc_loss",
    "edit_distance", "hsigmoid_loss", "dice_loss", "npair_loss",
    "fused_linear_hard_ce",
]


class _FusedLinearHardCE(torch.autograd.Function):
    """``logits = h2 @ wT``, then ``lse − logits[label]`` a row: the
    exponentials in the logits' dtype summed in f32, the loss in the
    logits' dtype. Saves h2, wT, the labels, the logits and the f32 lse."""

    @staticmethod
    def forward(ctx, h2, wT, lbl, ignore_index):
        logits = torch.matmul(h2, wT)
        m2 = logits.max(dim=-1, keepdim=True).values
        lse = torch.log(torch.exp(logits - m2).sum(
            -1, dtype=torch.float32)) + m2[:, 0].float()
        picked = torch.gather(logits, 1, lbl.clamp(min=0)[:, None])[:, 0]
        loss = (lse - picked.float()).to(logits.dtype)
        mask = (lbl != ignore_index).to(logits.dtype)
        ctx.save_for_backward(h2, wT, lbl, logits, lse)
        ctx.ignore_index = ignore_index
        ctx.mark_non_differentiable(mask)
        return loss * mask, mask

    @staticmethod
    def backward(ctx, dloss, _dmask):
        h2, wT, lbl, logits, lse = ctx.saved_tensors
        g = dloss.float() * (lbl != ctx.ignore_index).float()
        # one f32 buffer: exp(logits − lse)·g, minus g at the label
        d = logits.float()
        d.sub_(lse[:, None]).exp_().mul_(g[:, None])
        d.scatter_add_(1, lbl.clamp(min=0)[:, None], -g[:, None])
        d = d.to(logits.dtype)
        dh = torch.matmul(d, wT.t()) if ctx.needs_input_grad[0] else None
        dw = (torch.matmul(h2.t(), d).to(wT.dtype)
              if ctx.needs_input_grad[1] else None)
        return dh, dw, None, None


def fused_linear_hard_ce(h2: torch.Tensor, wT: torch.Tensor,
                         lbl: torch.Tensor, ignore_index: int = -100):
    """The LM head's matmul and hard-label cross entropy with one joint
    backward: ``h2`` [N, H], ``wT`` [H, V], ``lbl`` [N] int → (per-row
    loss·mask [N], mask [N]), both in the logits' dtype. The backward
    gives ``dh = dlogits @ Wᵀ`` and ``dW = h2ᵀ @ dlogits`` from one
    dlogits, made in f32 from the saved logits and lse and cast once."""
    return _FusedLinearHardCE.apply(h2, wT, lbl.long(), int(ignore_index))


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
        return _reduce(loss, reduction)
    lbl = _hard(label, input.dim(), axis)
    if label_smoothing:
        onehot = _one_hot(lbl.clamp(min=0), classes, logp)
        soft = onehot * (1.0 - label_smoothing) + label_smoothing / classes
        loss = -(soft * logp).sum(-1)
    else:
        loss = -logp.gather(-1, lbl.clamp(min=0)[..., None])[..., 0]
    valid = lbl != ignore_index
    loss = loss * valid
    if w is not None:
        loss = loss * w[lbl.clamp(min=0)]
    return _reduce(loss, reduction, valid)


def _one_hot(lbl: torch.Tensor, classes: int,
             like: torch.Tensor) -> torch.Tensor:
    """``lbl``'s one-hot rows in ``like``'s dtype, by comparison
    (``F.one_hot`` reads the labels' range on the host, a sync on the
    card)."""
    arange = torch.arange(classes, device=lbl.device)
    return (lbl[..., None] == arange).to(like.dtype)


def _hard(label: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """Integer labels without the class axis."""
    lbl = label.long()
    if lbl.dim() == ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    return lbl


def _reduce(loss: torch.Tensor, reduction: str,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``_reduce``: ``"mean"`` (over ``valid``'s true
    entries when given), ``"sum"`` or ``"none"``."""
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    if valid is None:
        return loss.mean()
    from ...distributed.parallel import mean_denominator

    # the count over the global batch inside a data-parallel engine
    return loss.sum() / mean_denominator(valid.sum())


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """``cross_entropy(reduction="none")`` with the class axis kept (size
    1) for hard labels, and the softmax when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def square_error_cost(input, label):
    return (input - label) ** 2


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``−input[label]`` along axis 1 (log-probabilities [N, C, ...]),
    weighted by ``weight[label]``; ignored labels count 0; ``"mean"``
    divides by the weights' sum (at least 1e-12)."""
    lbl = label.long()
    picked = input.gather(1, lbl.clamp(min=0).unsqueeze(1)).squeeze(1)
    wgt = (lbl != ignore_index).to(input.dtype)
    if weight is not None:
        wgt = wgt * weight[lbl.clamp(min=0)]
    loss = -picked * wgt
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / wgt.sum().clamp(min=1e-12)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = input.clamp(1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``−(pos_weight·t·log σ(z) + (1 − t)·log σ(−z))``, times
    ``weight``."""
    pos = label * TF.logsigmoid(logit)
    if pos_weight is not None:
        pos = pos_weight * pos
    loss = -(pos + (1.0 - label) * TF.logsigmoid(-logit))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``t·(log max(t, 1e-12) − input)``; ``"batchmean"`` divides the sum
    by the batch."""
    loss = label * (torch.log(label.clamp(min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce((-label * (input - other) + margin).clamp(min=0.0),
                    reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    norms = (torch.linalg.vector_norm(input1, dim=-1)
             * torch.linalg.vector_norm(input2, dim=-1))
    cos = (input1 * input2).sum(-1) / norms.clamp(min=1e-12)
    loss = torch.where(label == 1, 1.0 - cos, (cos - margin).clamp(min=0.0))
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = -(label * TF.logsigmoid(logit)
           + (1 - label) * TF.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(d(a, pos) − d(a, neg) + margin, 0)`` with the p-norm
    distance (``epsilon`` is taken and not used, as in the reference)."""
    def dist(a, b):
        return ((a - b).abs() ** p).sum(-1) ** (1.0 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce((dp - dn + margin).clamp(min=0.0), reduction)


_LOG_EPSILON = -1e5  # optax's stand-in for log(0)


def _ctc_per_sequence(logits, logit_pad, labels, label_pad, blank):
    """optax's ``ctc_loss_with_forward_probs`` loss: logits [B, T, C],
    labels [B, N], the paddings 1.0 where padded."""
    b, _, classes = logits.shape
    n = labels.shape[1]
    logp = torch.log_softmax(logits, dim=-1)
    label_lens = n - label_pad.sum(1).long()
    repeat = TF.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype),
                    (0, 1))
    logp_phi = logp[:, :, blank:blank + 1].transpose(0, 1)  # [T, B, 1]
    onehot = _one_hot(labels.long(), classes, logits)
    logp_emit = torch.einsum("btk,bnk->tbn", logp, onehot)
    phi = torch.full((b, n + 1), _LOG_EPSILON, dtype=logits.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    emit = torch.full((b, n), _LOG_EPSILON, dtype=logits.dtype,
                      device=logits.device)

    def add_phi(ph, score):
        return torch.cat([ph[:, :1], torch.logaddexp(ph[:, 1:], score)], 1)

    pads = logit_pad.transpose(0, 1)
    for t in range(logp_emit.shape[0]):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + _LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + logp_emit[t],
                                    emit + logp_emit[t])
        next_phi = prev_phi + logp_phi[t]
        next_phi = add_phi(next_phi, emit + logp_phi[t]
                           + _LOG_EPSILON * (1.0 - repeat))
        pad = pads[t].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -last.gather(1, label_lens[:, None])[:, 0]


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of [T, B, C] logits (``log_softmax`` is applied here, as optax
    does) against [B, N] labels; frames past ``input_lengths`` and labels
    past ``label_lengths`` are padding. ``"mean"`` divides each loss by
    its label length (at least 1) first; ``norm_by_times`` is ignored, as
    in the reference."""
    logits = log_probs.transpose(0, 1)
    b, t, _ = logits.shape
    lbl = labels if labels.dim() == 2 else labels.reshape(b, -1)
    il, ll = input_lengths.reshape(-1), label_lengths.reshape(-1)
    arange = lambda k: torch.arange(k, device=logits.device)  # noqa: E731
    logit_pad = (arange(t)[None, :] >= il[:, None]).to(logits.dtype)
    label_pad = (arange(lbl.shape[1])[None, :] >= ll[:, None]).to(
        logits.dtype)
    loss = _ctc_per_sequence(logits, logit_pad, lbl, label_pad, blank)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return (loss / ll.to(loss.dtype).clamp(min=1.0)).mean()


def _compact(seq, length, ignored):
    """The tokens of each row that are not ``ignored`` and lie within its
    ``length``, moved to the front (stable), and their count."""
    keep = torch.ones_like(seq, dtype=torch.bool)
    for tok in ignored:
        keep &= seq != tok
    keep &= (torch.arange(seq.shape[1], device=seq.device)[None, :]
             < length[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return seq.gather(1, order), keep.sum(1)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance of each row of ``input`` [B, L1] to ``label``
    [B, L2] (within their lengths, ``ignored_tokens`` removed first):
    ``(distance [B, 1] f32, sequence_num [1] f32)``; ``normalized``
    divides by the label's length (at least 1)."""
    b, l1 = input.shape
    l2 = label.shape[1]
    dev = input.device
    li = (input_length.reshape(-1).long() if input_length is not None
          else torch.full((b,), l1, device=dev))
    lj = (label_length.reshape(-1).long() if label_length is not None
          else torch.full((b,), l2, device=dev))
    inp, lab = input, label
    if ignored_tokens:
        inp, li = _compact(inp, li, ignored_tokens)
        lab, lj = _compact(lab, lj, ignored_tokens)
    cols = torch.arange(l2 + 1, dtype=torch.float32, device=dev)[None, :]
    prev = cols.expand(b, l2 + 1)
    cap = prev  # a row of input length 0: the label's length
    for i in range(1, l1 + 1):
        cost = (inp[:, i - 1:i] != lab).float()
        cand = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        cand = torch.cat([prev[:, :1] + 1, cand], 1)
        prev = cols + torch.cummin(cand - cols, dim=1).values
        cap = torch.where((li == i)[:, None], prev, cap)
    dist = cap.gather(1, lj[:, None])[:, 0]
    if normalized:
        dist = dist / lj.float().clamp(min=1.0)
    return dist[:, None], torch.full((1,), float(b), device=dev)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss [N, 1]: over each sample's path of
    internal nodes, ``Σ softplus(p_j) − Σ_{bit_j = 1} p_j`` with
    ``p_j = w[node_j]·x + b[node_j]`` clipped to ±40. The path is the
    default tree's, or ``path_table`` (nodes, −1 past the end) with
    ``path_code`` (bits). ``is_sparse`` is taken and not used."""
    if path_table is not None and path_code is not None:
        mask = path_table >= 0
        idx = path_table.clamp(min=0).long()
        bits = (path_code > 0) & mask
    else:
        c = label.reshape(-1).long() + num_classes
        max_len = int(math.floor(math.log2(2 * num_classes - 1)))
        j = torch.arange(max_len, device=input.device)[None, :]
        length = torch.floor(torch.log2(c.float()))[:, None]
        mask = j.float() < length
        idx = ((c[:, None] >> (j + 1)) - 1).clamp(0, num_classes - 2)
        bits = ((c[:, None] >> j) & 1).bool() & mask
    pre = torch.einsum("nld,nd->nl", weight[idx], input)
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    pre = pre.clamp(-40.0, 40.0)
    loss = ((torch.log1p(torch.exp(pre)) * mask.to(pre.dtype)).sum(1)
            - torch.where(bits, pre, torch.zeros_like(pre)).sum(1))
    return loss[:, None]


def dice_loss(input, label, epsilon=0.00001, name=None):
    """``mean(1 − 2·|x ∩ onehot| / (|x| + |onehot| + ε))`` per sample,
    the one-hot over the trailing class axis."""
    lbl = label.long()
    if lbl.shape[-1] == 1:
        lbl = lbl[..., 0]
    onehot = _one_hot(lbl, input.shape[-1], input)
    dims = tuple(range(1, input.dim()))
    inse = (input * onehot).sum(dims)
    denom = input.sum(dims) + onehot.sum(dims)
    return (1.0 - 2.0 * inse / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: the soft-label cross entropy of ``anchor @
    positive.T`` against the label-equality rows (re-weighted by them
    and averaged, as the reference does) plus ``0.25·l2_reg`` times the
    mean squared norms."""
    bsz = labels.shape[0]
    lbl = labels.reshape(bsz, 1)
    eq = (lbl == lbl.t()).to(anchor.dtype)
    soft = eq / eq.sum(1, keepdim=True)
    l2loss = ((anchor * anchor).sum(1).mean()
              + (positive * positive).sum(1).mean()) * 0.25 * l2_reg
    logp = torch.log_softmax(anchor @ positive.t(), dim=-1)
    ce_rows = -(soft * logp).sum(1)
    return l2loss + (soft * ce_rows[:, None]).sum(0).mean()
