"""Text (``paddle_tpu.text`` counterpart): the models (``text.models``),
the linear-chain CRF (``text.crf``), ``FakeTextDataset`` and
``viterbi_decode``. The reference's corpus readers (``text.datasets``)
are not ported."""
from __future__ import annotations

import numpy as np
import torch

from ..io.dataset import Dataset
from . import crf
from .crf import crf_decoding, linear_chain_crf

__all__ = ["FakeTextDataset", "viterbi_decode", "crf", "linear_chain_crf",
           "crf_decoding"]


class FakeTextDataset(Dataset):
    """Deterministic synthetic token sequences for language-model training:
    sample ``idx`` is a zipf(1.1) draw of ``seq_len + 1`` tokens from
    ``np.random.RandomState(seed + idx)``, modulo ``vocab_size``, as
    (inputs, next tokens), int64."""

    def __init__(self, num_samples=2048, seq_len=128, vocab_size=50257,
                 seed=0):
        self.num_samples = num_samples
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        toks = rng.zipf(1.1, size=self.seq_len + 1) % self.vocab_size
        return toks[:-1].astype(np.int64), toks[1:].astype(np.int64)

    def __len__(self):
        return self.num_samples


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """Viterbi decoding of ``potentials`` [B, T, N] under
    ``transition_params`` [N, N] (from-tag × to-tag, no start/end rows):
    (scores [B] float32, paths [B, T] int64) on the potentials' device.
    As in the reference, every sequence is decoded over all T steps:
    ``lengths`` and ``include_bos_eos_tag`` are accepted and not read."""
    pots = torch.as_tensor(potentials)
    trans = torch.as_tensor(transition_params, device=pots.device)
    with torch.no_grad():
        b, t, n = pots.shape
        dp = pots[:, 0]
        back = []
        for ti in range(1, t):
            best, bp = (dp[:, :, None] + trans[None]).max(dim=1)
            back.append(bp)
            dp = best + pots[:, ti]
        scores, tag = dp.max(dim=1)
        path = [tag]
        for bp in reversed(back):
            tag = torch.gather(bp, 1, tag[:, None])[:, 0]
            path.append(tag)
        return scores.float(), torch.stack(path[::-1], dim=1)
