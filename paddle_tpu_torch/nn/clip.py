"""Gradient clipping — counterpart of ``paddle_tpu.nn.clip``.

The three clip classes an optimizer takes as ``grad_clip``, and
``clip_grads_global_norm_raw``, the form the reference's compiled engines
call. The arithmetic is the reference's: squares summed in f32 from each
gradient cast to f32, ``scale = clip / max(norm, clip)`` for the global
norm, and each gradient becomes ``(g · scale)`` rounded back to its own
dtype. A parameter whose ``need_clip`` attribute is False is left out
(the raw form clips every gradient, as the reference's does).

The global norm goes through ``ops.fused.grad_global_norm``: the
sum-of-squares kernel for gradients on the card, its plain version on
the CPU. ``Adam`` and ``AdamW`` do not call these classes for a global
norm: they fold the clip into the multi-tensor Adam kernel
(``ops.fused.fused_adam_step``), unless row-sparse gradients take part.

A row-sparse gradient (a ``core.selected_rows.RowSparseGrad``, or a
sparse COO tensor, read as one) is clipped as the reference clips one:
its duplicate rows are merged first (the dense gradient holds their
sum), padding rows left out; ``ClipGradByValue`` clamps the merged values
(and densifies when its range excludes 0, which moves untouched rows
too); the norms count the merged values, and the global norm takes them
into the same sum-of-squares pass as the dense gradients; a scale is
applied to the values in their dtype.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core.selected_rows import RowSparseGrad
from ..ops.fused import grad_global_norm

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grads_global_norm_raw"]

ParamsGrads = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _clipped(p, g) -> bool:
    """Whether the gradient ``g`` of ``p`` takes part in a clip."""
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g · scale`` in f32, rounded back to ``g``'s dtype."""
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        return self._clip([
            (p, RowSparseGrad.from_coo(g) if isinstance(g, torch.Tensor)
             and g.is_sparse else g) for p, g in params_grads])

    def _clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into [min, max] (``min`` defaults to ``-max``)."""

    def __init__(self, max: float, min: Optional[float] = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, self._clamp(g) if _clipped(p, g) else g)
                for p, g in params_grads]

    def _clamp(self, g):
        if not isinstance(g, RowSparseGrad):
            return g.clamp(self.min, self.max)
        if self.min > 0.0 or self.max < 0.0:
            # a range without 0 moves the untouched rows too
            return g.to_dense().clamp(self.min, self.max)
        m = g.merged()
        return RowSparseGrad(m.rows, m.values.clamp(self.min, self.max),
                             m.num_rows, merged=True)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / ‖g‖, 1)`` on its own."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                sparse = isinstance(g, RowSparseGrad)
                sq = g.sq_l2norm() if sparse else g.float().square().sum()
                scale = (self.clip_norm / sq.sqrt().clamp(min=1e-12)).clamp(
                    max=1.0)
                g = g.scale(scale.to(g.dtype)) if sparse else _scaled(g,
                                                                      scale)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(‖g‖, clip_norm)``, the
    norm taken over all of them together."""

    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        # a row-sparse gradient's merged values join the dense gradients
        # in one sum of squares
        grads = [g.merged().values if isinstance(g, RowSparseGrad) else g
                 for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        scale = grad_global_norm(grads, self.clip_norm)[1]
        return [(p, _global_scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


def _global_scaled(g, scale: torch.Tensor):
    """``g`` times the global clip's ``scale``: a dense gradient in f32,
    rounded back; a row-sparse one by the scale in its dtype, as the
    reference scales each."""
    if isinstance(g, RowSparseGrad):
        return g.scale(scale.to(g.dtype))
    return _scaled(g, scale)


def clip_grads_global_norm_raw(grads, clip_norm: float):
    """``grads`` (a list or a dict of tensors) clipped to the global norm
    ``clip_norm``, every one of them, in the same structure."""
    items = list(grads.values()) if isinstance(grads, dict) else list(grads)
    if not items:
        return grads
    scale = grad_global_norm(items, clip_norm)[1]
    if isinstance(grads, dict):
        return {k: _scaled(g, scale) for k, g in grads.items()}
    return [_scaled(g, scale) for g in items]
