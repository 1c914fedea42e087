"""``flops`` — counterpart of ``paddle_tpu.hapi.dynamic_flops``: a
network's FLOPs by forward hooks on its leaf layers, with the
reference's counting rules (multiply-adds; the table in
``_register_hooks``), a ``custom_ops`` override keyed by layer class, an
optional per-layer table and an integer total. The input is drawn from
numpy's global generator, as the reference draws it, on the device of
the network's parameters.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn as _tnn

__all__ = ["flops", "dynamic_flops"]


def _numel(t):
    return int(np.prod(t.shape)) if hasattr(t, "shape") else 0


def count_convNd(m, x, y):
    x = x[0]
    kernel_ops = int(np.prod(m.weight.shape[2:]))
    bias_ops = 1 if getattr(m, "bias", None) is not None else 0
    groups = getattr(m, "_groups", 1)
    m.total_ops += abs(int(
        _numel(y) * (x.shape[1] / groups * kernel_ops + bias_ops)))


def count_leaky_relu(m, x, y):
    m.total_ops += _numel(x[0])


def count_bn(m, x, y):
    if not m.training:
        m.total_ops += abs(int(2 * _numel(x[0])))


def count_linear(m, x, y):
    # the weight is [in, out], as the reference keeps it
    m.total_ops += abs(int(m.weight.shape[0] * _numel(y)))


def count_avgpool(m, x, y):
    m.total_ops += _numel(y)


def count_adap_avgpool(m, x, y):
    kernel = np.array(x[0].shape[2:]) // np.array(y.shape[2:])
    m.total_ops += abs(int((int(np.prod(kernel)) + 1) * _numel(y)))


def count_zero_ops(m, x, y):
    m.total_ops += 0


def count_parameters(m, x, y):
    m.total_params = sum(_numel(p) for p in m.parameters(recurse=False))


def count_io_info(m, x, y):
    m.input_shape = list(x[0].shape)
    out = y[0] if isinstance(y, (list, tuple)) else y
    m.output_shape = list(out.shape)


_RULES = (
    (("Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
      "Conv3DTranspose"), count_convNd),
    (("ReLU", "ReLU6", "Dropout"), count_zero_ops),
    (("LeakyReLU",), count_leaky_relu),
    (("Linear",), count_linear),
    (("AvgPool1D", "AvgPool2D", "AvgPool3D"), count_avgpool),
    (("AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D"),
     count_adap_avgpool),
    (("BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D"), count_bn),
)


def _register_hooks():
    """The port's layer class → its counting function."""
    from .. import nn

    return {getattr(nn, name): fn for names, fn in _RULES for name in names
            if getattr(nn, name, None) is not None}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The FLOPs of ``net`` (a module) on one input batch of shape
    ``input_size`` (e.g. ``[1, 3, 224, 224]``). ``custom_ops`` maps layer
    classes to ``fn(layer, inputs, output)`` that add into
    ``layer.total_ops``. Returns the integer total; ``print_detail``
    prints the per-layer table."""
    if not isinstance(net, _tnn.Module):
        raise TypeError("flops expects a module (the Program path of the "
                        "reference's static_flops is not ported)")
    p = next(net.parameters(), None)
    dev = p.device if p is not None else torch.device("cpu")
    inputs = torch.from_numpy(
        np.random.rand(*input_size).astype("float32")).to(dev)
    return dynamic_flops(net, inputs, custom_ops=custom_ops,
                         print_detail=print_detail)


def _print_table(rows):
    header = ("Layer Name", "Input Shape", "Output Shape", "Params",
              "Flops")
    rows = [tuple(str(c) for c in r) for r in rows]
    widths = [max([len(h)] + [len(r[i]) for r in rows])
              for i, h in enumerate(header)]
    line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    print(line)
    print("|" + "|".join(f" {h:<{w}} " for h, w in zip(header, widths))
          + "|")
    print(line)
    for r in rows:
        print("|" + "|".join(f" {c:<{w}} " for c, w in zip(r, widths))
              + "|")
    print(line)


def dynamic_flops(model, inputs, custom_ops=None, print_detail=False):
    handles = []
    custom_ops = custom_ops or {}
    rules = _register_hooks()
    seen_types = set()

    def add_hooks(m):
        if len(list(m.children())) > 0:
            return
        m.total_ops = 0
        m.total_params = 0
        m_type = type(m)
        fn = custom_ops.get(m_type, rules.get(m_type))
        if m_type not in seen_types:
            if m_type in custom_ops:
                print(f"Customize Function has been applied to {m_type}")
            elif fn is None:
                print(f"Cannot find suitable count function for {m_type}. "
                      "Treat it as zero FLOPs.")
            seen_types.add(m_type)
        if fn is not None:
            handles.append(m.register_forward_hook(fn))
        handles.append(m.register_forward_hook(count_parameters))
        handles.append(m.register_forward_hook(count_io_info))

    training = model.training
    model.eval()
    model.apply(add_hooks)
    with torch.no_grad():
        model(inputs)
    if training:
        model.train()
    for h in handles:
        h.remove()

    rows, total_ops, total_params = [], 0, 0
    for name, m in model.named_modules():
        if m is model or len(list(m.children())) > 0 \
                or not hasattr(m, "input_shape"):
            continue
        rows.append((name, m.input_shape, m.output_shape,
                     int(m.total_params), int(m.total_ops)))
        total_ops += m.total_ops
        total_params += m.total_params
        for attr in ("total_ops", "total_params", "input_shape",
                     "output_shape"):
            delattr(m, attr)
    if print_detail:
        _print_table(rows)
    print(f"Total Flops: {int(total_ops)}     "
          f"Total Params: {int(total_params)}")
    return int(total_ops)
