"""Model summary — counterpart of ``paddle_tpu.hapi.summary``: each leaf
layer's output shape and parameter count, through forward hooks on one
eval-mode forward of zeros, and the totals."""
from __future__ import annotations

import torch
from torch import nn

from ..amp.auto_cast import _convert_dtype

__all__ = ["summary"]


def summary(net: nn.Module, input_size=None, dtypes=None, input=None):
    """Print per-layer output shapes and parameter counts; return
    ``{"total_params", "trainable_params"}``. ``input_size`` is a shape
    (or a list of shapes, one per input) whose ``None`` or ``-1`` batch
    becomes 1; ``input`` gives the inputs themselves."""
    rows = []
    hooks = []

    def register(layer, name):
        def hook(module, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            shape = list(out.shape) if isinstance(out, torch.Tensor) \
                else "?"
            n_params = sum(p.numel() for p in
                           module.parameters(recurse=False))
            rows.append((name or type(module).__name__, str(shape),
                         n_params))

        hooks.append(layer.register_forward_hook(hook))

    for name, sub in net.named_modules():
        if name and not any(True for _ in sub.children()):  # leaves only
            register(sub, name)

    if input is not None:
        x = list(input) if isinstance(input, (list, tuple)) else [input]
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = [input_size] if isinstance(input_size, tuple) \
            else list(input_size)
        sizes = [list(s) for s in (
            sizes if isinstance(sizes[0], (list, tuple)) else [sizes])]
        dev = next(net.parameters()).device
        dtype = _convert_dtype(dtypes if isinstance(dtypes, str)
                               else "float32")
        x = [torch.zeros([1 if (d is None or d == -1) else d for d in s],
                         dtype=dtype, device=dev) for s in sizes]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*x)
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    width = 70
    print("-" * width)
    print(f"{'Layer (type)':35s} {'Output Shape':20s} {'Param #':>12s}")
    print("=" * width)
    for name, shape, n in rows:
        print(f"{name:35.35s} {shape:20.20s} {n:12,d}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}
