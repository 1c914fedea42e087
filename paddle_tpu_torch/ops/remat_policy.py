"""Activation recompute policies — counterpart of
``paddle_tpu.ops.remat_policy``: its vocabulary (``normalize``) and
``apply_policy``, which puts a training forward under one.

- ``'off'``: nothing is recomputed;
- ``'full'`` and ``'nothing'``: a region saves only its inputs, and its
  forward runs again in the backward
  (``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``);
- ``'dots'``: selective checkpointing — the outputs of the matrix
  products (``aten.mm``, ``aten.addmm``, ``aten.bmm``) are kept, the rest
  is recomputed; ``'dots_no_batch'`` keeps ``mm`` and ``addmm`` only;
- ``'offload'`` and ``'auto'`` are not ported and raise: they need saved
  tensors in pinned host memory and the measured peak-memory ladder.

The reference wraps the whole forward in ``jax.checkpoint`` and XLA
places each recomputation in the backward where it is needed. Eager
PyTorch recomputes a region all at once when the backward first reaches
it, so one region around the whole forward would rebuild every
activation before the backward starts and save no memory. The regions
are therefore the elements of each top-level ``nn.ModuleList`` of the
layer (GPT's decoder blocks, BERT's encoder layers); the whole forward is
one region only where the layer has no ``nn.ModuleList``. The values
recomputed are the reference's; only when they are recomputed differs.

A recomputed region draws the dropout masks it drew the first time: the
model's own dropout generators (every ``torch.Generator`` that a module
holds as ``generator``, which ``checkpoint``'s ``preserve_rng_state``
does not cover) are set to the state they had when the region first ran,
and put back afterwards. A region also recomputes with the parameter
tensors it first ran with (a forward on casts of the parameters, as the
engine's cast mode runs, keeps them). The hand-written kernels inside a
region (LayerNorm and attention forwards) run again in the recompute, and
their launch counters count both runs.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["POLICY_IDS", "normalize", "apply_policy"]

# stable ids of the policies (the reference's gauge/remat/<entry> values)
POLICY_IDS = {"off": 0, "dots": 1, "dots_no_batch": 2, "nothing": 3,
              "offload": 4, "full": 5}

_aten = torch.ops.aten
_SAVED_PRODUCTS = {"dots": (_aten.mm, _aten.addmm, _aten.bmm),
                   "dots_no_batch": (_aten.mm, _aten.addmm)}


def normalize(remat) -> str:
    """Engine constructor values -> canonical policy name. Accepts the
    legacy ``recompute`` vocabulary (False/True/'dots'/'dots_no_batch'/
    'nothing') plus 'off'/'full'/'offload'/'auto'."""
    if remat in (None, False, "off", ""):
        return "off"
    if remat is True or remat == "full":
        return "full"
    name = str(remat)
    if name in POLICY_IDS or name == "auto":
        return name
    raise ValueError(f"unknown remat policy {remat!r}; expected one of "
                     f"{sorted(POLICY_IDS)} or 'auto'")


def apply_policy(fn: Callable, policy, layer: nn.Module) -> Callable:
    """``fn`` (a forward of ``layer``) under the named policy: 'off'
    returns it untouched; otherwise each call of the returned function
    runs ``fn`` with every region of ``layer`` checkpointed."""
    policy = normalize(policy)
    if policy == "off":
        return fn
    if policy in ("offload", "auto"):
        raise NotImplementedError(
            f"remat={policy!r} is not ported yet ('offload' needs saved "
            "tensors in pinned host memory, 'auto' the peak-memory ladder)")
    gens = _generators(layer)
    context_fn = functools.partial(_contexts, gens, policy)
    regions = _regions(layer)
    if not regions:
        return lambda *a, **k: checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context_fn, **k)

    def run(*args, **kwargs):
        with _checkpointed(regions, context_fn):
            return fn(*args, **kwargs)

    return run


def _regions(layer: nn.Module) -> List[nn.Module]:
    """The elements of every ``nn.ModuleList`` of ``layer`` that lies in
    no other region."""
    if isinstance(layer, nn.ModuleList):
        return list(layer)
    return [r for child in layer.children() for r in _regions(child)]


def _generators(layer: nn.Module) -> List[torch.Generator]:
    gens: Dict[int, torch.Generator] = {}
    for m in layer.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            gens[id(g)] = g
    return list(gens.values())


def _contexts(gens: List[torch.Generator], policy: str):
    """The (forward, recompute) context pair of one region's checkpoint."""
    entry: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward_ctx():
        entry[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, entry):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)

    saved = _SAVED_PRODUCTS.get(policy)
    if saved is None:
        return forward_ctx(), recompute_ctx()

    def policy_fn(ctx, op, *args, **kwargs):
        packet = getattr(op, "overloadpacket", op)
        return (CheckpointPolicy.MUST_SAVE if packet in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    sac_fwd, sac_re = create_selective_checkpoint_contexts(policy_fn)
    return _both(forward_ctx(), sac_fwd), _both(recompute_ctx(), sac_re)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _region_call(block: nn.Module, forward: Callable, context_fn, *args,
                 **kwargs):
    # (owner, name, tensor) of every parameter the block holds now: the
    # recompute puts these back in place for its run
    held = [(m, name, t) for m in block.modules()
            for name, t in m._parameters.items() if t is not None]

    def region(*a, **k):
        found = [(m, name, m._parameters[name]) for m, name, _ in held]
        for m, name, t in held:
            m._parameters[name] = t
        try:
            return forward(*a, **k)
        finally:
            for m, name, t in found:
                m._parameters[name] = t

    return checkpoint(region, *args, use_reentrant=False,
                      context_fn=context_fn, **kwargs)


@contextlib.contextmanager
def _checkpointed(regions: List[nn.Module], context_fn):
    """Route each region's calls through a checkpoint while inside."""
    for block in regions:
        forward = type(block).forward.__get__(block)
        block.forward = functools.partial(_region_call, block, forward,
                                          context_fn)
    try:
        yield
    finally:
        for block in regions:
            del block.forward
