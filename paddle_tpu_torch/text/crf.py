"""Linear-chain CRF — counterpart of ``paddle_tpu.text.crf``:
``linear_chain_crf`` (the per-sequence cost ``log Z − score(labels)``)
and ``crf_decoding`` (Viterbi).

``transition`` is the reference's ``[num_tags + 2, num_tags]`` layout:
row 0 holds the start weights, row 1 the end weights, rows 2.. the
tag→tag weights. Sequences are padded with lengths; a padded step leaves
the recursion's state as it was (and, in decoding, points back at the
same tag), so the padded tags of a path are those of its last valid
step's backtrace, as in the reference.

Both run on the tensors' device with no read back to the host: the
forward algorithm is S−1 dependent steps of a logsumexp over [B, D, D]
(its gradients in the emissions and the transition come from autograd),
Viterbi is S−1 steps of max/argmax and a backtrace of S−1 gathers. Both
compute in their inputs' dtype, as the reference does: bf16 emissions and
a bf16 transition (a bf16 training step casts every float parameter)
give a bf16 recursion, so a caller that wants the sums in f32 casts its
inputs.
"""
from __future__ import annotations

import torch

__all__ = ["linear_chain_crf", "crf_decoding"]


def _norm_inputs(emission, label, length):
    """emission [B, S, D], label [B, S] int64 (or None), length [B]."""
    if emission.dim() == 2:  # one sequence [S, D]
        emission = emission[None]
        if label is not None:
            label = label[None]
    if label is not None:
        if label.dim() == emission.dim():  # trailing [.., 1]
            label = label.squeeze(-1)
        label = label.long()
    if length is not None:
        length = length.reshape(-1).to(device=emission.device,
                                       dtype=torch.int64)
    else:
        length = torch.full((emission.shape[0],), emission.shape[1],
                            dtype=torch.int64, device=emission.device)
    return emission, label, length


def linear_chain_crf(emission, label, transition, length=None):
    """Per-sequence CRF cost ``log Z − score(label)``, shape [B, 1].

    ``emission`` [B, S, D] (or [S, D]); ``label`` [B, S] (or [B, S, 1])
    int tags; ``transition`` [D+2, D]; ``length`` [B] valid lengths (None:
    all S). Differentiable in ``emission`` and ``transition``."""
    em, lbl, ln = _norm_inputs(emission, label.detach(), None if length is
                               None else length.detach())
    b_, s_, d_ = em.shape
    a, b, w = transition[0], transition[1], transition[2:]
    # the partition function: the forward algorithm in log space
    alpha = a[None, :] + em[:, 0]                               # [B, D]
    for t in range(1, s_):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + em[:, t]
        alpha = torch.where((t < ln)[:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + b[None, :], dim=1)           # [B]

    # the score of the gold path
    t_idx = torch.arange(s_, device=em.device)
    valid = t_idx[None, :] < ln[:, None]                         # [B, S]
    picked = torch.gather(em, 2, lbl[..., None])[..., 0]
    zero = torch.zeros((), dtype=em.dtype, device=em.device)
    score = torch.where(valid, picked, zero).sum(1)
    # index_select, not advanced indexing: its backward (index_add_)
    # reads nothing back to the host
    score = score + a.index_select(0, lbl[:, 0])
    last = torch.gather(lbl, 1, (ln - 1).clamp(0, s_ - 1)[:, None])[:, 0]
    score = score + b.index_select(0, last)
    if s_ > 1:
        pairs = (lbl[:, :-1] * d_ + lbl[:, 1:]).reshape(-1)
        tr = w.reshape(-1).index_select(0, pairs).reshape(b_, s_ - 1)
        score = score + torch.where(valid[:, 1:], tr, zero).sum(1)
    return (log_z - score)[:, None]


def crf_decoding(emission, transition, label=None, length=None):
    """Viterbi decoding: the most likely tag path [B, S] int64 (0 on
    padding); with ``label``, the [B, S] 0/1 mask of the steps where it
    equals the gold tag."""
    with torch.no_grad():
        em, lb, ln = _norm_inputs(emission.detach(), None if label is None
                                  else label.detach(),
                                  None if length is None else length.detach())
        return _viterbi(em, transition.detach(), lb, ln)


def _viterbi(em, trans, lb, ln):
    b_, s_, d_ = em.shape
    a, b, w = trans[0], trans[1], trans[2:]
    zero = torch.zeros((), dtype=em.dtype, device=em.device)
    # the end weights join at each row's last valid step
    dp = a[None, :] + em[:, 0] + torch.where((ln == 1)[:, None], b[None, :],
                                             zero)
    tags = torch.arange(d_, device=em.device)[None, :]
    bps = []
    for t in range(1, s_):
        cand = dp[:, :, None] + w[None]                          # [B, from, to]
        best, bp = cand.max(dim=1)
        nxt = best + em[:, t] + torch.where((t == ln - 1)[:, None],
                                            b[None, :], zero)
        keep = (t < ln)[:, None]
        dp = torch.where(keep, nxt, dp)
        # a frozen step points back at itself: the backtrace walks
        # through the padding unchanged
        bps.append(torch.where(keep, bp, tags))
    tag = dp.argmax(dim=1)                                       # [B]
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                        # [B, S]
    valid = torch.arange(s_, device=em.device)[None, :] < ln[:, None]
    path = torch.where(valid, path, torch.zeros_like(path))
    if lb is not None:
        return ((path == lb) & valid).long()
    return path
