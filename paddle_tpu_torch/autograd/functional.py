"""``grad`` and ``backward`` — counterpart of
``paddle_tpu.autograd.functional``, over ``torch.autograd``.

``grad`` keeps the reference's rules: the other leaves' ``.grad`` stay
as they were; an input that the outputs do not reach raises unless
``allow_unused``; the graph is kept after the call unless
``retain_graph=False`` (the reference always keeps it), and a graph that
an earlier ``backward`` freed raises torch's "already been freed" error;
with ``create_graph=False`` the gradients cannot be differentiated
again.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def _as_list(x) -> list:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves'
    ``.grad``."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors) or [None] * len(tensors)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None) -> List[Optional[torch.Tensor]]:
    """The gradients of ``outputs`` with respect to ``inputs`` (a list,
    None for an unreached input when ``allow_unused``). ``no_grad_vars``
    is refused: the reference accepts it and never reads it, and the port
    does not take an argument it would ignore."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    gouts = _as_list(grad_outputs) or [None] * len(outputs)
    if no_grad_vars:
        raise NotImplementedError(
            "grad(no_grad_vars=...): detach those tensors where they are "
            "used instead; torch cannot cut an edge of a recorded graph")
    keep = True if retain_graph is None else bool(retain_graph)
    try:
        res = torch.autograd.grad(outputs, inputs, gouts,
                                  retain_graph=keep or create_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    except RuntimeError as e:
        if "does not require grad" in str(e) and not any(
                o.requires_grad for o in outputs):
            raise RuntimeError(
                "grad: no output depends on a tensor that requires grad "
                "(a gradient computed with create_graph=False cannot be "
                "differentiated again)") from e
        raise
    if not allow_unused:
        for t, g in zip(inputs, res):
            if g is None:
                raise RuntimeError(
                    "an input tensor is unreachable from outputs; pass "
                    "allow_unused=True to get None instead")
    return list(res)
