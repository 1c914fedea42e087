"""Optimizers — counterpart of ``paddle_tpu.optimizer.optimizer``.

Every optimizer takes the reference's options: a float or an
``LRScheduler`` (``optimizer.lr``) as ``learning_rate``, a float or a
regularizer (``regularizer.L1Decay``/``L2Decay``) as ``weight_decay``
(a parameter's own ``regularizer`` attribute wins over it; either is
folded into the gradient as ``coeff · p``, L1 too, as in the reference),
and a clip (``nn.clip``) as ``grad_clip``. A parameter's learning rate
is the optimizer's times its ``optimize_attr['learning_rate']`` (its
``ParamAttr``'s; the reference's ``_lr_for``), and, for ``AdamW``, times
``lr_ratio(p)``.

``minimize(loss)`` binds the optimizer to the Program being recorded
(``static.program_guard``), where ``parameters`` may be left out (the
program's trainable parameters are taken); eagerly it is ``backward``,
then ``step``.

``step()`` runs, as the reference's eager ``step`` does: the clip over
every parameter that has a gradient, then per parameter the L2 fold and
the update. Under ``multi_precision`` a float parameter that is not f32
(bf16, or fp16 under ``amp.decorate(level='O2')``) gets an f32
``master``, which the L2 fold and the update run on; the parameter is
then re-cast from it.

A row-sparse gradient (``nn.Embedding(..., sparse=True)``'s: a sparse
COO tensor, read as a ``core.selected_rows.RowSparseGrad``) takes the
reference's row path: ``SGD`` adds ``-lr·values`` at its rows, ``Adam``
and ``AdamW`` update the merged rows (``lazy_mode=False``: every moment
decays and only the rows get the gradient's term, as the dense update
would; ``lazy_mode=True``: only the rows' moments and values are read and
written; AdamW decays only those rows), all in plain PyTorch, as the
reference's are XLA-level code. Every other optimizer, and any parameter
with an L2 coefficient, densifies it first. A master takes the row
update and the rows are re-cast into the parameter.

The reference's compiled steps (its engines and its static Executor)
update otherwise: every parameter at the optimizer's learning rate (no
``optimize_attr``, no ``lr_ratio``) and from dense gradients (a traced
lookup has no sparse gradient). The port's engines and Executor step
inside ``compiled_update()``, which does the same.

``Adam`` and ``AdamW`` are the training path: their update is the
reference's ``Adam._update``, which is not ``torch.optim.Adam``:
``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)`` and ``p ← p − lr_t·m/(√v + eps)``, so eps
is not bias-corrected, and the beta powers are per-parameter f32 state
multiplied once per step. Their ``step()`` hands every parameter with a
gradient to ``ops.fused.fused_adam_step`` in one call per device: the
multi-tensor CUDA kernel on the card (with a ``ClipGradByGlobalNorm``
folded into it: its sum-of-squares pass and the update's scale both run
on the device), the plain ``_adam_reference`` on the CPU. The learning
rate lives on the device too, so a step never reads anything back to the
host. ``AdamW`` adds the reference's decoupled decay: before its Adam
update a parameter is scaled by ``1 − lr·weight_decay``, unless
``apply_decay_param_fun(name)`` says no. The name is the parameter's name
in the model (``bert.encoder.0.ln1.bias``), as the reference's engine
passes it; ``ParallelTrainStep`` hands the optimizer those names
(``name_parameters``).

``state_dict()`` and ``set_state_dict()`` keep the reference's layout:
``global_step``, ``{name}__{key}`` for each state tensor of each
parameter that has state (``moment1``, ``beta1_pow``, ``velocity``, …,
and ``master``), and ``LR_Scheduler`` when the learning rate is a
scheduler. ``name`` is the parameter's name in its model (recorded by
``name_parameters``), else its position in the parameter list; the
reference's is the generated ``p.name``, so optimizer state does not
cross between the packages. ``set_state_dict`` copies the saved values
into the state in place, and makes the state of a parameter that has
none yet.

The other optimizers (``SGD``, ``Momentum``, ``LarsMomentum``,
``Adagrad``, ``Adamax``, ``Adadelta``, ``RMSProp``, ``Lamb``) have no
Pallas kernel in the reference: each ``_update`` is the reference's
formula in plain PyTorch over the f32 master or the parameter, a few
launches per parameter.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.selected_rows import RowSparseGrad
from ..nn.clip import ClipGradBase, ClipGradByGlobalNorm
from ..ops import fused, tree_reduce
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "LarsMomentum", "Adagrad",
           "Adam", "AdamW", "Adamax", "Adadelta", "RMSProp", "Lamb"]

State = Dict[str, torch.Tensor]


class Optimizer:
    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Iterable[torch.Tensor]] = None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = False):
        if parameters is None:
            if not _static_recording():
                raise ValueError("parameters is required (pass "
                                 "model.parameters())")
            parameters = ()  # bound to the program's by minimize
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate).__name__}")
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError("grad_clip must be a ClipGradByValue, "
                            "ClipGradByNorm or ClipGradByGlobalNorm, got "
                            f"{type(grad_clip).__name__}")
        if isinstance(parameters, nn.Module):
            parameters = parameters.parameters()
        self._parameter_list: List[torch.Tensor] = list(parameters)
        self._learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, State] = {}
        # device -> (value, its 0-d f32 tensor on that device)
        self._lr_dev: Dict[torch.device, Tuple[float, torch.Tensor]] = {}
        self._names: Dict[int, str] = {}
        self._global_step = 0
        self._compiled = False  # inside compiled_update()

    @contextlib.contextmanager
    def compiled_update(self):
        """Within: step as the reference's compiled steps (engines, static
        Executor) update — every parameter at the optimizer's learning
        rate, and a row-sparse gradient densified (in ``p.grad``) first."""
        prev, self._compiled = self._compiled, True
        try:
            yield self
        finally:
            self._compiled = prev

    def name_parameters(self, named: Iterable[Tuple[str, torch.Tensor]]
                        ) -> None:
        """Record each parameter's name in its model (``named`` is
        ``model.named_parameters()``), for options that select
        parameters by name."""
        for name, p in named:
            self._names[id(p)] = name

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when learning_rate is a "
                               "scheduler")
        self._learning_rate = float(value)

    def _lr_scale(self, p: torch.Tensor) -> float:
        """The factor of ``p``'s learning rate: its ``optimize_attr``
        ``learning_rate`` (1 inside ``compiled_update``)."""
        if self._compiled:
            return 1.0
        attr = getattr(p, "optimize_attr", None) or {}
        return float(attr.get("learning_rate", 1.0))

    def lr_device_scalar(self, device) -> torch.Tensor:
        """The current learning rate as a 0-d f32 tensor on ``device``,
        made anew with a fill (no host-to-device copy to wait for) only
        when the value changed since the last call."""
        dev = torch.device(device)
        value = self.get_lr()
        cached = self._lr_dev.get(dev)
        if cached is None or cached[0] != value:
            cached = self._lr_dev[dev] = (value, torch.full(
                (), value, dtype=torch.float32, device=dev))
        return cached[1]

    # -- state ------------------------------------------------------------
    def _init_state(self, value: torch.Tensor) -> State:
        return {}

    def state_for(self, p: torch.Tensor,
                  master: Optional[torch.Tensor] = None) -> State:
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

    def _decay_coeff(self, p: torch.Tensor) -> float:
        """The L2 coefficient folded into ``p``'s gradient: its own
        ``regularizer``'s, else the optimizer's ``weight_decay``."""
        reg = getattr(p, "regularizer", None)
        wd = reg if reg is not None else self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "coeff", wd))

    # -- checkpoint -------------------------------------------------------
    def _state_key(self, i: int, p: torch.Tensor) -> str:
        return self._names.get(id(p), str(i))

    def state_dict(self) -> dict:
        """The optimizer's state in the reference's layout (the state
        tensors themselves, not copies)."""
        out = {"global_step": self._global_step}
        for i, p in enumerate(self._parameter_list):
            st = self._accumulators.get(id(p))
            if st is None:
                continue
            name = self._state_key(i, p)
            for k, v in st.items():
                out[f"{name}__{k}"] = v
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict: dict) -> None:
        """Restore what ``state_dict`` returned (tensors or numpy
        arrays): the step count, the scheduler's state, and each saved
        state tensor copied into the parameter's state in place."""
        self._global_step = int(state_dict.get("global_step", 0))
        sched = state_dict.get("LR_Scheduler")
        if sched is not None and isinstance(self._learning_rate,
                                            LRScheduler):
            self._learning_rate.set_state_dict(sched)
        for i, p in enumerate(self._parameter_list):
            prefix = self._state_key(i, p) + "__"
            saved = {k[len(prefix):]: v for k, v in state_dict.items()
                     if k.startswith(prefix)}
            if not saved:
                continue
            st = self.state_for(p)
            for k, v in saved.items():
                v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.asarray(v))
                cur = st.get(k)
                if cur is not None and cur.shape == v.shape:
                    cur.copy_(v)
                else:
                    st[k] = v.to(device=p.device, dtype=torch.float32,
                                 copy=True)

    # -- entry points -----------------------------------------------------
    def minimize(self, loss: torch.Tensor, startup_program=None,
                 parameters=None, no_grad_set=None):
        """While a Program records: bind ``(self, loss)`` to it, so that
        ``static.Executor`` runs backward and this optimizer's ``step``
        each run (an optimizer made without ``parameters`` takes the
        program's trainable ones). Eager: ``loss.backward()``, then
        ``step()``. Returns ``([], [(param, grad), ...])``."""
        from ..static.program import current_program

        prog = current_program()
        if prog is not None and _static_recording():
            if parameters is not None:
                self._parameter_list = list(parameters)
            elif not self._parameter_list:
                self._parameter_list = [
                    p for p in prog.all_parameters() if p.requires_grad
                    and getattr(p, "trainable", True)]
            prog._optimize = (self, loss)
            return [], [(p, None) for p in self._parameter_list]
        loss.backward()
        self.step()
        return [], [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self) -> None:
        """Drop every gradient (the next backward allocates new ones)."""
        for p in self._parameter_list:
            p.grad = None

    def _params_grads(self) -> List[Tuple[torch.Tensor, object]]:
        """``(p, grad)`` for every parameter with a gradient; a sparse
        one as a ``RowSparseGrad`` (inside ``compiled_update``: densified
        into ``p.grad`` first)."""
        out = []
        for p in self._parameter_list:
            g = p.grad
            if g is None:
                continue
            if g.is_sparse:
                if self._compiled:
                    g = p.grad = g.to_dense()
                else:
                    g = RowSparseGrad.from_coo(g)
            out.append((p, g))
        return out

    @torch.no_grad()
    def step(self) -> None:
        """One step over every parameter that has a gradient: the clip,
        then per parameter the L2 fold and ``_update`` (on the f32 master
        when there is one) at its learning rate; a row-sparse gradient
        takes the row path (``_step_sparse``) or is densified."""
        params_grads = self._params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._global_step += 1
        lr = self.get_lr()
        for p, g in params_grads:
            lr_p = lr * self._lr_scale(p)
            if isinstance(g, RowSparseGrad):
                if self._step_sparse(p, g, lr_p):
                    continue
                g = g.to_dense()
            state = self.state_for(p)
            master = state.get("master")
            target = master if master is not None else p.detach()
            g = g.to(target.dtype)
            wd = self._decay_coeff(p)
            if wd:
                g = g + wd * target
            sub = {k: v for k, v in state.items() if k != "master"}
            new, new_state = self._update_param(p, target, g, sub, lr_p)
            target.copy_(new)
            if master is not None:
                new_state["master"] = master
                p.detach().copy_(master)
            self._accumulators[id(p)] = new_state

    def _step_sparse(self, p: torch.Tensor, g: RowSparseGrad,
                     lr: float) -> bool:
        """The row update of ``p`` (on its master when it has one, whose
        written rows are then re-cast into ``p``), in place; False when
        this optimizer has no row path for ``p`` (the caller densifies)."""
        state = self.state_for(p)
        master = state.get("master")
        target = master if master is not None else p.detach()
        rows = self._update_rows(p, target, g, state, lr)
        if rows is False:
            return False
        if master is not None:
            if rows is None:
                p.detach().copy_(master)
            else:
                p.detach().index_copy_(0, rows, master.index_select(
                    0, rows).to(p.dtype))
        return True

    def _update_rows(self, p, target, g: RowSparseGrad, state, lr):
        """Update ``target`` (and ``state``) in place from the row-sparse
        ``g``; returns the rows written (None: every row), or False for
        no row path (the base class: densify)."""
        return False

    @torch.no_grad()
    def step_checked(self, loss: torch.Tensor,
                     order: List[torch.Tensor], gate: bool,
                     consensus=None) -> torch.Tensor:
        """``step()`` with the reference engines' finite sweep: returns the
        bool flags ``[loss, grad of each of order, each of order after the
        update]`` on the device (a parameter without a gradient has a true
        grad flag). With ``gate`` a step whose flags are not all true keeps
        every parameter, master and state tensor it came with (a
        ``torch.where`` on the device, no host sync). ``consensus`` (flags
        -> flags, e.g. their AND over a world of ranks) is applied before
        the gate reads them. This plain route copies the stepped state
        first; Adam's kernel needs no copy."""
        stepped = [p for p, _ in self._params_grads()]
        old = {}
        if gate:
            for p in stepped:
                st = self.state_for(p)
                old[id(p)] = (p.detach().clone(),
                              {k: v.clone() for k, v in st.items()})
        self.step()
        flags = _sweep(loss, order)
        if consensus is not None:
            flags = consensus(flags)
        if gate:
            ok = flags.all()
            for p in stepped:
                p_old, st_old = old[id(p)]
                p.detach().copy_(torch.where(ok, p.detach(), p_old))
                st = self._accumulators[id(p)]
                for k, v in st_old.items():
                    st[k].copy_(torch.where(ok, st[k], v))
        return flags

    def _update_param(self, p, value, grad, state, lr):
        """``_update`` for parameter ``p`` (a hook for per-parameter
        options)."""
        return self._update(value, grad, state, lr)

    def _update(self, param: torch.Tensor, grad: torch.Tensor,
                state: State, lr: float) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError


def _static_recording() -> bool:
    from ..core import recording

    return recording.active() is not None


def _sweep(loss: torch.Tensor, order: List[torch.Tensor]) -> torch.Tensor:
    """The finite flags of ``loss``, each parameter's gradient and each
    parameter, in that order (``ops.tree_reduce.tree_finite``: one walk of
    the multi-tensor kernel on the card)."""
    none = torch.zeros((), dtype=torch.float32, device=loss.device)
    leaves = ([loss.reshape(())]
              + [p.grad if p.grad is not None else none for p in order]
              + [p.detach() for p in order])
    return tree_reduce.tree_finite(leaves)


def _zeros(value: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(value)


def _one(value: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=value.device)


def _norm(t: torch.Tensor) -> torch.Tensor:
    return t.float().square().sum().sqrt()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _update(self, param, grad, state, lr):
        return param - lr * grad, state

    def _update_rows(self, p, target, g, state, lr):
        """``target[rows] -= lr·values`` for every entry (a repeated row
        takes each of its entries), unless ``p`` has an L2 coefficient."""
        if self._decay_coeff(p):
            return False
        v = g._valid()
        target.index_add_(0, v.rows, -(lr * v.values.float()).to(
            target.dtype))
        return v.rows.unique()


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, value):
        return {"velocity": _zeros(value)}

    def _update(self, param, grad, state, lr):
        v = self._momentum * state["velocity"] + grad
        if self._nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}


class LarsMomentum(Momentum):
    """LARS: the step of each tensor scaled by ``lars_coeff·‖p‖ / (‖g‖ +
    lars_weight_decay·‖p‖ + epsilon)`` (``lr`` where a norm is 0).
    ``exclude_from_weight_decay`` is taken and, as in the reference, not
    used."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 lars_coeff: float = 0.001,
                 lars_weight_decay: float = 0.0005, parameters=None,
                 grad_clip=None, exclude_from_weight_decay=None,
                 epsilon: float = 0, multi_precision: bool = False):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, multi_precision)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon

    def _update(self, param, grad, state, lr):
        pn, gn = _norm(param), _norm(grad)
        local_lr = torch.where(
            (pn > 0) & (gn > 0),
            lr * self._lars_coeff * pn
            / (gn + self._lars_wd * pn + self._epsilon),
            torch.tensor(lr, dtype=torch.float32, device=param.device),
        ).to(param.dtype)
        v = self._momentum * state["velocity"] + local_lr * (
            grad + self._lars_wd * param)
        return param - v, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon: float = 1e-06,
                 parameters=None, weight_decay=None, grad_clip=None,
                 initial_accumulator_value: float = 0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, value):
        return {"moment": torch.full_like(value, self._init_acc)}

    def _update(self, param, grad, state, lr):
        m = state["moment"] + grad * grad
        new_p = param - lr * grad / (torch.sqrt(m) + self._epsilon)
        return new_p, {"moment": m}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._lazy = bool(lazy_mode)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        # index tensors that put the check pass's flags in a caller's order
        self._flag_order: Dict[tuple, torch.Tensor] = {}

    def _init_state(self, value: torch.Tensor) -> State:
        return {"moment1": _zeros(value), "moment2": _zeros(value),
                "beta1_pow": _one(value), "beta2_pow": _one(value)}

    def _l2_coeff(self, p: torch.Tensor) -> float:
        """The L2 coefficient folded into ``p``'s gradient."""
        return self._decay_coeff(p)

    def _decoupled_coeff(self, p: torch.Tensor) -> float:
        """The decoupled-decay coefficient of ``p`` (0 for Adam)."""
        return 0.0

    @torch.no_grad()
    def step(self) -> None:
        """One Adam step over every parameter that has a gradient, in
        place: the dense gradients in one ``fused_adam_step`` call per
        device, each tensor at its learning-rate scale; a
        ``ClipGradByGlobalNorm`` runs inside that call (unless row-sparse
        gradients take part: the clip then scales every gradient first,
        its dense norm still the kernel's sum-of-squares pass); the other
        clips run on the gradients first. Row-sparse gradients take the
        row path (``_update_rows``)."""
        self._fused_step()

    @torch.no_grad()
    def step_checked(self, loss: torch.Tensor,
                     order: List[torch.Tensor], gate: bool,
                     consensus=None) -> torch.Tensor:
        """``Optimizer.step_checked`` through the kernel's check pass
        (``fused_adam_step(check=...)``): the sweep evaluates the update
        before it, and under ``gate`` the update reads the verdict on the
        device and writes nothing on a bad step. With ``consensus`` the
        check pass runs alone first (``adam_finite_check``), the flags go
        through ``consensus``, and their AND gates the update."""
        check = fused.FiniteCheck(loss.reshape(()), gate, consensus)
        params = self._fused_step(check)
        if check.flags is None:  # no parameter had a gradient
            flags = _sweep(loss, order)
            return consensus(flags) if consensus is not None else flags
        # the kernel's flags follow `params` (the stepped ones); reorder
        # to `order`, the last slot (always true) for the rest
        n = len(params)
        pos = {id(p): i for i, p in enumerate(params)}
        key = (check.flags.device, tuple(pos.get(id(p), -1) for p in order),
               n)
        pick = self._flag_order.get(key)
        if pick is None:
            last = 2 * n + 1
            grad = [1 + pos[id(p)] if id(p) in pos else last for p in order]
            par = [1 + n + pos[id(p)] if id(p) in pos else last
                   for p in order]
            pick = self._flag_order[key] = torch.tensor(
                [0] + grad + par, device=check.flags.device)
        return check.flags[pick]

    def _fused_step(self, check=None) -> List[torch.Tensor]:
        params_grads = self._params_grads()
        clip = self._grad_clip
        sparse = any(isinstance(g, RowSparseGrad) for _, g in params_grads)
        if clip is not None and (sparse or not isinstance(
                clip, ClipGradByGlobalNorm)):
            params_grads = clip(params_grads)
            clip = None
        self._global_step += 1
        lr = self.get_lr()
        by_device: Dict[torch.device, list] = {}
        for p, g in params_grads:
            if isinstance(g, RowSparseGrad):
                if check is not None:
                    raise NotImplementedError(
                        "a checked Adam step takes dense gradients (the "
                        "engines densify inside compiled_update)")
                if self._step_sparse(p, g, lr * self._lr_scale(p)):
                    continue
                g = g.to_dense()
            by_device.setdefault(p.device, []).append((p, g))
        if check is not None and len(by_device) > 1:
            raise NotImplementedError(
                "a checked Adam step takes the parameters of one device")
        for dev, pairs in by_device.items():
            params = [p for p, _ in pairs]
            states = [self.state_for(p) for p in params]
            args = ([p.data for p in params], [g for _, g in pairs],
                    [s["moment1"] for s in states],
                    [s["moment2"] for s in states],
                    [s["beta1_pow"] for s in states],
                    [s["beta2_pow"] for s in states],
                    self.lr_device_scalar(dev))
            kw = dict(
                masters=[s.get("master") for s in states],
                beta1=self._beta1, beta2=self._beta2, eps=self._epsilon,
                weight_decay=[self._l2_coeff(p) for p in params],
                decoupled_decay=[self._decoupled_coeff(p) for p in params],
                need_clip=[getattr(p, "need_clip", True) for p in params],
                lr_scale=[self._lr_scale(p) for p in params])
            consensus = check.consensus if check is not None else None
            if consensus is None:
                fused.fused_adam_step(
                    *args, clip_norm=clip.clip_norm if clip is not None
                    else None, check=check, **kw)
                continue
            # the check pass alone, the verdict through consensus, then the
            # update gated on it
            norm = (fused.grad_global_norm(args[1], clip.clip_norm,
                                           kw["need_clip"])
                    if clip is not None else None)
            check.flags, _ = fused.adam_finite_check(
                *args, norm=norm, loss=check.loss, **kw)
            check.flags = consensus(check.flags)
            check.ok = check.flags.all().to(torch.int32)
            fused.fused_adam_step(*args, norm=norm, ok=check.ok
                                  if check.gate else None, **kw)
        return [p for p, _ in params_grads]

    def _update_rows(self, p, target, g, state, lr):
        """The reference's sparse Adam over the merged rows (AdamW first
        decays those rows by ``1 − lr·c``): ``lazy_mode=False`` decays
        every moment and adds the gradient's terms at the rows, so the
        result is the dense update's; ``lazy_mode=True`` reads and writes
        only the rows' moments and values. A parameter with an L2
        coefficient (a regularizer or ``weight_decay``) is densified and
        takes the plain dense update, as in the reference."""
        m = g.merged()
        rows = m.rows
        c = self._decoupled_coeff(p)
        if c:
            target.index_copy_(0, rows, target.index_select(0, rows)
                               * (1.0 - lr * c))
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1, m2 = state["moment1"], state["moment2"]
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        if self._decay_coeff(p):
            fused._adam_reference(
                [target], [m.to_dense()], [m1], [m2], [b1p], [b2p],
                torch.tensor(lr, dtype=torch.float32, device=target.device),
                beta1=b1, beta2=b2, eps=eps, weight_decay=self._l2_coeff(p))
            return None
        vals = m.values.float()
        new_b1p, new_b2p = b1p * b1, b2p * b2
        lr_t = lr * torch.sqrt(1 - new_b2p) / (1 - new_b1p)
        if not self._lazy:
            m1.mul_(b1).index_add_(0, rows, ((1 - b1) * vals).to(m1.dtype))
            m2.mul_(b2).index_add_(0, rows,
                                   ((1 - b2) * vals * vals).to(m2.dtype))
            target.sub_((lr_t * m1 / (torch.sqrt(m2) + eps)).to(
                target.dtype))
            written = None
        else:
            m1n = b1 * m1.index_select(0, rows).float() + (1 - b1) * vals
            m2n = (b2 * m2.index_select(0, rows).float()
                   + (1 - b2) * vals * vals)
            target.index_copy_(0, rows, target.index_select(0, rows) - (
                lr_t * m1n / (torch.sqrt(m2n) + eps)).to(target.dtype))
            m1.index_copy_(0, rows, m1n.to(m1.dtype))
            m2.index_copy_(0, rows, m2n.to(m2.dtype))
            written = rows
        b1p.copy_(new_b1p)
        b2p.copy_(new_b2p)
        return written


class AdamW(Adam):
    """Adam with decoupled weight decay (the reference's ``AdamW``):
    each step scales a parameter's f32 value (its master, under
    ``multi_precision``) by ``1 − lr·weight_decay``, then applies the Adam
    update — the order of the reference engine's
    ``apply_optimizer_update``. ``apply_decay_param_fun(name) -> bool``
    picks the parameters that decay, by their names in the model (see
    ``Optimizer.name_parameters``). No L2 term is folded into the
    gradient, whatever a parameter's ``regularizer``, as in the
    reference's AdamW. ``lr_ratio(p)`` scales the parameter's learning
    rate (for the decay too), as the reference's ``AdamW.step`` does; the
    compiled steps ignore it, as the reference's do."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _lr_scale(self, p: torch.Tensor) -> float:
        scale = super()._lr_scale(p)
        if self._lr_ratio is not None and not self._compiled:
            scale *= float(self._lr_ratio(p))
        return scale

    def _l2_coeff(self, p: torch.Tensor) -> float:
        return 0.0

    def _decoupled_coeff(self, p: torch.Tensor) -> float:
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, value):
        return {"moment": _zeros(value), "inf_norm": _zeros(value),
                "beta1_pow": _one(value)}

    def _update(self, param, grad, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        m = b1 * state["moment"] + (1 - b1) * grad
        u = torch.maximum(b2 * state["inf_norm"], grad.abs() + eps)
        new_p = param - (lr / (1 - b1p)).to(param.dtype) * m / u
        return new_p, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon: float = 1e-06,
                 rho: float = 0.95, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, value):
        return {"avg_squared_grad": _zeros(value),
                "avg_squared_update": _zeros(value)}

    def _update(self, param, grad, state, lr):
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * grad * grad
        update = grad * torch.sqrt(state["avg_squared_update"] + eps) \
            / torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * update * update
        return param - lr * update, {"avg_squared_grad": asg,
                                     "avg_squared_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho: float = 0.95,
                 epsilon: float = 1e-06, momentum: float = 0.0,
                 centered: bool = False, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, value):
        return {"mean_square": _zeros(value), "mean_grad": _zeros(value),
                "momentum_acc": _zeros(value)}

    def _update(self, param, grad, state, lr):
        rho, eps = self._rho, self._epsilon
        ms = rho * state["mean_square"] + (1 - rho) * grad * grad
        mg = state["mean_grad"]
        if self._centered:
            mg = rho * mg + (1 - rho) * grad
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum_acc"] + lr * grad / denom
        return param - mom, {"mean_square": ms, "mean_grad": mg,
                             "momentum_acc": mom}


class Lamb(Optimizer):
    """LAMB: the bias-corrected Adam direction ``r`` (plus
    ``lamb_weight_decay · p`` unless ``exclude_from_weight_decay_fn(p)``
    says so) scaled by the trust ratio ``‖p‖ / ‖r‖`` (1 where a norm is
    0). The function is given the parameter tensor, as the reference
    gives it the parameter. No L2 term is folded into the gradient, as in
    the reference's ``Lamb.step``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-06, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, value):
        return {"moment1": _zeros(value), "moment2": _zeros(value),
                "beta1_pow": _one(value), "beta2_pow": _one(value)}

    def _decay_coeff(self, p):
        return 0.0

    def _update_param(self, p, value, grad, state, lr):
        decay = self._exclude_fn is None or not self._exclude_fn(p)
        return self._update(value, grad, state, lr, decay)

    def _update(self, param, grad, state, lr, decay=True):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + eps)
        if decay and self._lamb_wd:
            r = r + self._lamb_wd * param
        w_norm, r_norm = _norm(param), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm)).to(param.dtype)
        new_p = param - lr * trust * r
        return new_p, {"moment1": m1, "moment2": m2, "beta1_pow": b1p,
                       "beta2_pow": b2p}
