"""Optimizers — counterpart of ``paddle_tpu.optimizer.optimizer``, kept
to the Adam and AdamW the training slices run.

The update is the reference's ``Adam._update``, which is not
``torch.optim.Adam``: ``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)`` and
``p ← p − lr_t·m/(√v + eps)``, so eps is not bias-corrected, and the
beta powers are per-parameter f32 state multiplied once per step.

State per parameter: ``moment1``, ``moment2``, ``beta1_pow``,
``beta2_pow`` (device f32 scalars) and, under ``multi_precision`` for a
float parameter that is not f32, the f32 ``master`` the update runs on
(the parameter is then re-cast from it). ``step()`` hands every parameter
with a gradient to ``ops.fused.fused_adam_step`` in one call: the
multi-tensor CUDA kernel for parameters on the card, the plain
``_adam_reference`` for parameters on the CPU. The learning rate lives on
the device too, so a step never reads anything back to the host.

``AdamW`` adds the reference's decoupled decay: before its Adam update a
parameter is scaled by ``1 − lr·weight_decay``, unless
``apply_decay_param_fun(name)`` says no. The name is the parameter's name
in the model (``bert.encoder.0.ln1.bias``), as the reference's engine
passes it; ``ParallelTrainStep`` hands the optimizer those names
(``name_parameters``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..ops import fused

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate: float = 0.001,
                 parameters: Optional[Iterable[torch.Tensor]] = None,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float")
        if isinstance(parameters, nn.Module):
            parameters = parameters.parameters()
        self._parameter_list: List[torch.Tensor] = list(parameters)
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, dict] = {}
        self._lr_dev: Dict[torch.device, torch.Tensor] = {}
        self._names: Dict[int, str] = {}
        self._global_step = 0

    def name_parameters(self, named: Iterable[Tuple[str, torch.Tensor]]
                        ) -> None:
        """Record each parameter's name in its model (``named`` is
        ``model.named_parameters()``), for options that select
        parameters by name."""
        for name, p in named:
            self._names[id(p)] = name

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        self._learning_rate = float(value)
        self._lr_dev.clear()

    def lr_device_scalar(self, device) -> torch.Tensor:
        """The learning rate as a 0-d f32 tensor on ``device``, made once
        per value with a fill (no host-to-device copy to wait for)."""
        dev = torch.device(device)
        t = self._lr_dev.get(dev)
        if t is None:
            t = self._lr_dev[dev] = torch.full(
                (), self._learning_rate, dtype=torch.float32, device=dev)
        return t

    # -- state ------------------------------------------------------------
    def _init_state(self, value: torch.Tensor) -> dict:
        return {}

    def state_for(self, p: torch.Tensor,
                  master: Optional[torch.Tensor] = None) -> dict:
        """The state of ``p``, made on first use. Under
        ``multi_precision`` a float parameter that is not f32 gets an f32
        ``master``: ``master`` when given (the engine passes the f32 values
        before it casts the parameter), else ``p`` cast to f32."""
        key = id(p)
        if key not in self._accumulators:
            low = (self._multi_precision and p.is_floating_point()
                   and p.dtype != torch.float32)
            if master is not None or low:
                m = (master if master is not None else p.detach()).to(
                    device=p.device, dtype=torch.float32, copy=True)
                st = self._init_state(m)
                st["master"] = m
            else:
                st = self._init_state(p.detach())
            self._accumulators[key] = st
        return self._accumulators[key]

    # -- entry points -----------------------------------------------------
    def clear_grad(self) -> None:
        """Drop every gradient (the next backward allocates new ones)."""
        for p in self._parameter_list:
            p.grad = None

    def step(self) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay: Optional[float] = None,
                 grad_clip=None, lazy_mode: bool = False,
                 multi_precision: bool = False):
        if lazy_mode:
            raise NotImplementedError("lazy_mode (sparse rows) is not "
                                      "ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _init_state(self, value: torch.Tensor) -> dict:
        ones = lambda: torch.ones((), dtype=torch.float32,
                                  device=value.device)
        return {"moment1": torch.zeros_like(value),
                "moment2": torch.zeros_like(value),
                "beta1_pow": ones(), "beta2_pow": ones()}

    def _decay_coeff(self, p: torch.Tensor) -> float:
        """The decoupled-decay coefficient of ``p`` (0 for Adam)."""
        return 0.0

    @torch.no_grad()
    def step(self) -> None:
        """One Adam step over every parameter that has a gradient, in
        place, in one ``fused_adam_step`` call per device."""
        self._global_step += 1
        by_device: Dict[torch.device, list] = {}
        for p in self._parameter_list:
            if p.grad is not None:
                by_device.setdefault(p.device, []).append(p)
        for dev, params in by_device.items():
            states = [self.state_for(p) for p in params]
            fused.fused_adam_step(
                [p.data for p in params], [p.grad for p in params],
                [s["moment1"] for s in states],
                [s["moment2"] for s in states],
                [s["beta1_pow"] for s in states],
                [s["beta2_pow"] for s in states],
                self.lr_device_scalar(dev),
                masters=[s.get("master") for s in states],
                beta1=self._beta1, beta2=self._beta2, eps=self._epsilon,
                weight_decay=self._weight_decay,
                decoupled_decay=[self._decay_coeff(p) for p in params])


class AdamW(Adam):
    """Adam with decoupled weight decay (the reference's ``AdamW``):
    each step scales a parameter's f32 value (its master, under
    ``multi_precision``) by ``1 − lr·weight_decay``, then applies the Adam
    update — the order of the reference engine's
    ``apply_optimizer_update``. ``apply_decay_param_fun(name) -> bool``
    picks the parameters that decay, by their names in the model (see
    ``Optimizer.name_parameters``). ``lr_ratio`` is not ported: the
    reference's engine ignores it too."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay: float = 0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW: lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, p: torch.Tensor) -> float:
        if not self._coeff:
            return 0.0
        if self._apply_decay_param_fun is None:
            return self._coeff
        name = self._names.get(id(p))
        if name is None:
            raise ValueError(
                "AdamW: apply_decay_param_fun needs the parameters' names; "
                "train through ParallelTrainStep or call "
                "name_parameters(model.named_parameters())")
        return self._coeff if self._apply_decay_param_fun(name) else 0.0
