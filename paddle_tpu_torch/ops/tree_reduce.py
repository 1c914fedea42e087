"""The multi-tensor finite sweep and state fingerprint — the port's
device piece for the reference's XLA-level ``core.sanitizer``
``finite_flags`` and ``tree_fingerprint`` (no Pallas kernel there).

``tree_fold(leaves)`` folds a list of tensors, in order, into the
fingerprint ``{"sum", "abs_sum", "xor"}`` of ``core.sanitizer.
tree_fingerprint``; ``tree_finite(leaves)`` gives one bool per leaf, every
element finite (``finite_flags``'s per-leaf flag). CUDA tensors go through
``csrc/tree_reduce.cu`` (one launch over every leaf's chunks, then a
one-block finish: two launches a call, counted in ``tree_reduce.launches``),
CPU tensors through the sanitizer's plain functions. Nothing is read back
to the host: the results are device tensors.

The kernel reads each leaf in 16-byte vectors (a scalar tail, and scalar
loads for a leaf that is not 16-byte aligned), reduces each chunk in a
fixed order and each leaf's chunks in chunk order: the same state gives
the same bits on every call, and the XOR word is bit-exact (the sums
differ from the plain version's by f32 rounding in another order).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..core import sanitizer
from . import _build

__all__ = ["tree_fold", "tree_finite", "tree_reduce"]

# elements of one (leaf, chunk) block: a multiple of every type's 16-byte
# vector
_CHUNK = 16384
# the kernel's element types (csrc/tree_reduce.cu): floats, then raw bits
# by element size
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}
_BITS = {1: 4, 2: 5, 4: 6, 8: 7}
_TABLES: Dict[tuple, tuple] = {}
_TABLES_MAX = 8


def _type_code(t: torch.Tensor) -> int:
    if t.dtype in _TYPES:
        return _TYPES[t.dtype]
    if t.is_floating_point() or t.is_complex():
        raise TypeError(f"tree_reduce: {t.dtype} leaves are not taken on "
                        "the card (float32, bfloat16, float16, float64 and "
                        "integer or bool types)")
    return _BITS[t.element_size()]


def _table(dev, leaves: Sequence[torch.Tensor]):
    """``(tab, chunks, leaf_chunks, nchunks)`` on ``dev``, made once per
    distinct list of (pointer, size, type)."""
    rows = []
    for i, t in enumerate(leaves):
        if t.device != dev:
            raise ValueError(f"tree_reduce: leaf {i} is on {t.device}, the "
                             f"first on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"tree_reduce: leaf {i} is not contiguous")
        rows.append((t.data_ptr(), t.numel(), _type_code(t)))
    key = (dev, tuple(rows))
    hit = _TABLES.get(key)
    if hit is None:
        counts = [-(-n // _CHUNK) for _, n, _ in rows]
        chunks = [(l, c) for l, n in enumerate(counts) for c in range(n)]
        tab = torch.tensor(rows, dtype=torch.int64).reshape(-1, 3)
        ch = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2)
        starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                              dtype=torch.int32)
        hit = (tab.to(dev), ch.to(dev), starts.to(dev), len(chunks))
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.pop(next(iter(_TABLES)))
        _TABLES[key] = hit
    return hit


def tree_reduce(leaves: Sequence[torch.Tensor], mode: str):
    """The kernel's two modes over ``leaves`` (CUDA tensors, one device):
    ``"fold"`` gives the fingerprint dict, ``"finite"`` the bool flags."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("tree_reduce: no leaves")
    dev = leaves[0].device
    if dev.type != "cuda":
        raise ValueError(f"tree_reduce: unsupported device {dev}")
    tab, chunks, starts, nchunks = _table(dev, leaves)
    n = len(leaves)
    partials = torch.empty(3 * nchunks + 2 * n, dtype=torch.float32,
                           device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    xor = torch.empty((), dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ptt_tree_reduce(
            tab.data_ptr(), chunks.data_ptr(), nchunks, starts.data_ptr(), n,
            _CHUNK, 0 if mode == "fold" else 1, partials.data_ptr(),
            sums.data_ptr(), xor.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"tree_reduce ({mode})")
    tree_reduce.launches += 2 if nchunks else 1
    if mode == "fold":
        return {"sum": sums[0], "abs_sum": sums[1], "xor": xor}
    return flags


tree_reduce.launches = 0  # kernel launches (the chunks, then the finish)


def tree_fold(leaves: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The fingerprint of ``leaves`` in order (``core.sanitizer.
    tree_fingerprint`` of the list): the kernel on the card, the plain
    version on the CPU."""
    leaves = list(leaves)
    if not leaves or leaves[0].device.type == "cpu":
        return sanitizer.tree_fingerprint(leaves)
    return tree_reduce(leaves, "fold")


def tree_finite(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """A bool per leaf: every element finite (a non-float leaf is)."""
    leaves = list(leaves)
    if leaves and leaves[0].device.type == "cpu":
        return torch.stack([torch.isfinite(t).all() if sanitizer.float_leaf(t)
                            else torch.ones((), dtype=torch.bool)
                            for t in leaves])
    return tree_reduce(leaves, "finite")

