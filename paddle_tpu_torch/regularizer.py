"""Regularizers — counterpart of ``paddle_tpu.regularizer``.

An optimizer takes one as ``weight_decay``, and a parameter may carry
its own as a ``regularizer`` attribute, which wins over the optimizer's.
Either way the optimizer reads only ``coeff`` and folds ``coeff · p`` into
the gradient: the reference does the same for ``L1Decay`` (its ``_l1``
flag is set and never read), so the port does too.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        self._coeff = self.coeff
        self._l1 = True


class L2Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        self._coeff = self.coeff
        self._l1 = False
