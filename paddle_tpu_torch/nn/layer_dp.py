"""DataParallel — counterpart of ``paddle_tpu.nn.layer_dp`` (Paddle's
``DataParallel`` over its C++ Reducer).

Each rank runs the wrapped layer on its own rows; the gradients are
averaged over the data-parallel group (``group``, default the world)
while the backward runs: every parameter's hook marks its gradient ready,
and a bucket (the parameters of one dtype, in reverse order, up to
``comm_buffer_size`` MB) is packed into one flat buffer and all-reduced
as soon as its last gradient lands; the buckets still open when the
backward ends are reduced then (a parameter that got no gradient takes
part with zeros when ``find_unused_parameters``, and is skipped
otherwise). With no world joined (one process) the layer is the wrapped
layer. ``scale_loss`` returns the loss as it is (the average is taken on
the gradients), ``apply_collective_grads`` reduces any gradient not yet
reduced, and ``state_dict`` and the parameter lists carry the wrapped
layer's names, without the wrapper's prefix.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

__all__ = ["DataParallel", "average_gradients"]


@torch.no_grad()
def average_gradients(params, group=None) -> None:
    """Average the gradients of ``params`` (those that have one) over
    ``group`` (default the world): one all-reduce per dtype, of the
    gradients packed into one buffer, written back in place."""
    from ..distributed import communication as comm
    from ..distributed.parallel import is_initialized

    if not is_initialized():
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    n = torch.distributed.get_world_size(comm._pg(group))
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        comm.all_reduce(flat, group=group)
        flat.div_(n)
        parts = flat.split([p.numel() for p in ps])
        torch._foreach_copy_([p.grad for p in ps],
                             [c.view(p.shape) for c, p in zip(parts, ps)])


class _Bucket:
    def __init__(self, params: List[torch.Tensor]):
        self.params = params
        self.ready = 0
        self.done = False


class DataParallel(nn.Module):
    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = bool(find_unused_parameters)
        self._group = group
        self._hooks = []
        self._buckets: List[_Bucket] = []
        self._bucket_of = {}
        self._pending = False
        from ..distributed.parallel import is_initialized

        if is_initialized():
            self._build_buckets(float(comm_buffer_size) * 2 ** 20)

    # -- the reducer ----------------------------------------------------------
    def _build_buckets(self, cap_bytes: float) -> None:
        params = [p for p in self._layers.parameters() if p.requires_grad]
        by_dtype = {}
        for p in reversed(params):  # gradients arrive roughly in reverse
            by_dtype.setdefault(p.dtype, []).append(p)
        for ps in by_dtype.values():
            cur, size = [], 0
            for p in ps:
                cur.append(p)
                size += p.numel() * p.element_size()
                if size >= cap_bytes:
                    self._buckets.append(_Bucket(cur))
                    cur, size = [], 0
            if cur:
                self._buckets.append(_Bucket(cur))
        for b in self._buckets:
            for p in b.params:
                self._bucket_of[id(p)] = b
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._on_grad))

    def _on_grad(self, p) -> None:
        if not self._pending:
            # the first gradient of this backward: reduce what is left
            # when the backward ends
            self._pending = True
            for b in self._buckets:
                b.ready, b.done = 0, False
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        b = self._bucket_of[id(p)]
        b.ready += 1
        if b.ready == len(b.params):
            self._reduce(b)

    @torch.no_grad()
    def _reduce(self, b: _Bucket) -> None:
        params = [p for p in b.params
                  if p.grad is not None or self.find_unused_parameters]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(params, self._group)
        b.done = True

    def _finish(self) -> None:
        for b in self._buckets:
            if not b.done:
                self._reduce(b)
        self._pending = False

    # -- the reference's surface ----------------------------------------------
    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self) -> None:
        """Reduce every gradient that the backward's buckets have not."""
        if self._pending:
            self._finish()

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        from .layer_base import set_state_dict

        return set_state_dict(self._layers, state_dict, *args, **kwargs)

    set_dict = set_state_dict
    load_dict = set_state_dict

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        return self._layers.load_state_dict(state_dict, strict, assign)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def __del__(self):
        for h in getattr(self, "_hooks", ()):
            h.remove()

