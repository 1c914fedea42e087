"""Nested containers of tensors — the slice of ``jax.tree_util`` the
port's resilience code and beam search need.

A tree is a dict, list or tuple of trees, ``None`` (an empty subtree) or
a leaf (anything else). Dicts are walked in sorted-key order and a leaf's
path is spelled as ``jax.tree_util.keystr`` spells it (``['fc.weight']``,
``[0]``), so a name made from it (``grad['fc.weight']``) is the
reference's own string.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["flatten_with_path", "leaves", "tree_map", "structure",
           "unflatten", "as_tensor"]


def flatten_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    """The leaves in ``flatten_with_path``'s order (without the paths)."""
    out: list = []
    _collect(tree, out)
    return out


def _collect(tree, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
    else:
        out.append(tree)


def tree_map(fn: Callable, tree, *rest):
    """``tree`` with every leaf replaced by ``fn(leaf, *others)``, where
    ``others`` are the leaves at the same place in ``rest`` (trees of
    ``tree``'s structure), as ``jax.tree_util.tree_map`` does. Containers
    keep their type, namedtuples included; dict keys their insertion
    order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):  # a namedtuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def structure(tree):
    """A picklable skeleton of ``tree``: containers of ``None`` marks
    (``"*"`` where a leaf was), for ``unflatten``."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        return ("dict", [(k, structure(tree[k])) for k in sorted(tree)])
    if isinstance(tree, (list, tuple)):
        return ("list" if isinstance(tree, list) else "tuple",
                [structure(v) for v in tree])
    return ("*",)


def unflatten(skeleton, leaves_: list):
    """The tree of ``skeleton`` (from ``structure``) holding ``leaves_`` in
    flatten order."""
    it = iter(leaves_)

    def build(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "*":
            return next(it)
        if kind == "dict":
            return {k: build(v) for k, v in s[1]}
        items = [build(v) for v in s[1]]
        return items if kind == "list" else tuple(items)

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the skeleton holds")
    return out


def as_tensor(x) -> torch.Tensor:
    """A tensor of ``x``: a tensor as it is, a numpy array or a scalar as a
    CPU tensor of its numpy dtype (a Python float is float64, as the
    reference's x64 mode reads it; the reference's bfloat16 arrays keep
    their bits)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy's extension type of jax
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))
