"""Dynamic loss scaling — counterpart of ``paddle_tpu.amp.grad_scaler``:
``AmpScaler``, ``GradScaler`` and ``current_loss_scale``.

The fp16 loop is the reference's dygraph one::

    with amp.auto_cast(dtype="float16"):
        loss = loss_fn(model(x), y)
    scaled = scaler.scale(loss)
    scaled.backward()
    scaler.minimize(opt, scaled)  # unscale, step unless non-finite, update

The schedule is the reference's ``_update``: ``decr_every_n_nan_or_inf``
steps with a non-finite gradient multiply the scale by ``decr_ratio``
(never below 1), ``incr_every_n_steps`` finite steps in a row multiply it
by ``incr_ratio``. A step whose gradients are not all finite is skipped:
the optimizer's ``step`` is not called, so no parameter, master, moment,
beta power or ``global_step`` changes.

``unscale_`` multiplies every gradient by ``1/scale`` in f32 and rounds it
back to the gradient's dtype (the reference's values), with
``torch._foreach_mul_`` over the f32 gradients, and reads ONE flag back to
the host: whether every unscaled gradient is finite (one max-abs
reduction a tensor, ``torch._foreach_norm(..., inf)``, which propagates
NaN and inf). The reference reads one flag per parameter. A row-sparse
gradient (a sparse COO tensor) is unscaled and checked through its
values, in place.

Unlike the reference, ``unscale_`` followed by ``step`` (or ``minimize``)
unscales once: ``unscale_`` sets a flag that ``step`` checks, and
``step``/``minimize`` clear it. The reference's ``step`` checks the flag
and its ``unscale_`` never sets it, so the gradients are divided twice.
The state dict's keys are the reference's, so a scaler's state loads
into either package's scaler.
"""
from __future__ import annotations

import torch

__all__ = ["AmpScaler", "GradScaler", "current_loss_scale"]

# the last scale any enabled scaler set in this process
_last_scale = None


def current_loss_scale():
    """The most recently set loss scale of any enabled AmpScaler in this
    process, or None when no scaler is in play."""
    return _last_scale


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        if enable:
            self._publish_scale()
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        """``var`` times the loss scale (``var`` itself when disabled)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer``'s parameters by the
        scale, in place, and record whether they are all finite."""
        if not self._enable:
            return
        # a sparse gradient through its values (a view of them)
        grads = [p.grad._values() if p.grad.is_sparse else p.grad
                 for p in optimizer._parameter_list if p.grad is not None]
        inv = 1.0 / self._scale
        f32 = [g for g in grads if g.dtype == torch.float32]
        if f32:
            torch._foreach_mul_(f32, inv)
        for g in grads:
            if g.dtype != torch.float32:
                g.copy_((g.float() * inv).to(g.dtype))
        found = False
        if grads:
            amax = torch.stack([n.float() for n in
                                torch._foreach_norm(grads, float("inf"))])
            found = not bool(torch.isfinite(amax).all())
        self._found_inf = found
        self._unscaled = True

    def minimize(self, optimizer, scaled_loss, *args, **kwargs):
        """Unscale (unless ``unscale_`` already did), step the optimizer
        if every gradient is finite, update the scale, clear the
        gradients."""
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False
        self._update()
        optimizer.clear_grad()

    def step(self, optimizer):
        """Unscale (unless ``unscale_`` already did) and step the
        optimizer if every gradient is finite; ``update()`` follows."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if self._enable:
            self._update()

    def _publish_scale(self):
        global _last_scale
        _last_scale = self._scale

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._publish_scale()

    def backoff(self, factor=None, min_scale=1.0):
        """Out-of-band scale decrease, for a non-finite step found outside
        ``unscale_``: shrink the scale (by ``decr_ratio`` unless
        ``factor``), not below ``min_scale``, and restart the good-step
        count. A no-op for a static scale."""
        if not self._enable or not self._dynamic:
            return self._scale
        f = self._decr_ratio if factor is None else float(factor)
        self._scale = max(self._scale * f, float(min_scale))
        self._good_steps = 0
        self._bad_steps = 0
        self._publish_scale()
        return self._scale

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)
        if self._enable:
            self._publish_scale()

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, d):
        self._scale = float(d.get("scale", self._scale))
        self._incr_ratio = float(d.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = float(d.get("decr_ratio", self._decr_ratio))
        self._incr_every_n_steps = int(
            d.get("incr_every_n_steps", self._incr_every_n_steps))
        self._decr_every_n = int(
            d.get("decr_every_n_nan_or_inf", self._decr_every_n))
        self._good_steps = int(d.get("good_steps", 0))
        self._bad_steps = int(d.get("bad_steps", 0))
        if self._enable:
            self._publish_scale()


class GradScaler(AmpScaler):
    def get_loss_scaling(self):
        """The scale as a 0-d f32 tensor on the CPU."""
        return torch.tensor(self._scale, dtype=torch.float32)
