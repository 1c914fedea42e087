"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s module paths so each counterpart is
easy to find (``paddle_tpu.ops.fused`` -> ``paddle_tpu_torch.ops.fused``),
and is idiomatic PyTorch inside: ``nn.Module``s, plain functions on
tensors, an explicit ``device`` and explicit ``torch.Generator``s.

It imports neither ``jax`` nor ``paddle_tpu``. Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``; asking for CUDA on
a machine without it raises instead of quietly running on the CPU.

Every Pallas kernel that the served path reaches has a hand-written
CUDA C++ counterpart under ``csrc/`` (built at first use by
``ops._build``); each sits beside its plain PyTorch version, which a
wrapper takes only for tensors that lie on the CPU.

Serving: GPT-2 token serving over a paged KV cache
(``inference.serving``) and the model (``text.models.gpt``). Training:
the single-device ``ParallelTrainStep`` (``distributed.fleet.engine``)
and ``jit.train_step.TrainStep``, with recompute policies
(``ops.remat_policy``), the optimizers, learning-rate schedulers and
regularizers (``optimizer``, ``optimizer.lr``, ``regularizer``),
gradient clips (``nn.clip``) and cross entropy (``nn.functional``,
``nn.CrossEntropyLoss``), for GPT-2 and for BERT pretraining
(``text.models.bert``, with the layers of ``nn.layer``). Their kernels
(``ops``): LayerNorm forward and backward, flash-attention forward and
dQ / dK-dV backward (causal or over every key), and a multi-tensor
Adam/AdamW with the global-norm clip's sum-of-squares pass;
``experiments`` holds the packed dK/dV experiment. The vision family
trains on the same steps: LeNet and the ResNets (``vision.models``)
over convolutions, pooling, BatchNorm, activations and containers
(``nn``), with mixed precision (``amp.auto_cast``), the data pipeline
(``io``, ``vision.datasets``) and metrics (``metric``); these run
through cuDNN and plain PyTorch, as the reference runs them through XLA.
The high-level API trains them: ``Model`` (``hapi``) with its callbacks
(``callbacks``), ``summary``, checkpoints (``save``/``load``,
``framework.io``, with the optimizers' state dicts), the device
prefetcher (``io.DevicePrefetcher``), vision transforms
(``vision.transforms``), VGG and MobileNet, and fp16 loss scaling
(``amp.GradScaler``); the spans and the goodput ledger (``profiler``) and
the preemption exit (``resilience``) go with them. Guarded and
fingerprinted training: the engines' finite sweep, gated update and state
fingerprints (``core.sanitizer``; on the card the Adam kernel's check
pass and the multi-tensor fold of ``ops.tree_reduce``), ``StepGuard``, the
watchdog, fault injection and the integrity monitor (``resilience``), and
train-state checkpoints (``incubate.checkpoint``). The static graph:
``static`` records a ``Program`` under ``program_guard`` and replays it
with an ``Executor`` (``run``, ``run_steps``), with control flow and
``static.nn``; ``jit.to_static`` (with the ``dy2static`` converter),
``jit.save`` / ``jit.load``; ``enable_static`` / ``disable_static`` switch
the mode.

The top level is the reference's user surface: the tensor functions
(``tensor``: ``to_tensor``, ``zeros``, ``matmul``, ``topk``, ...) on
``torch.Tensor``, ``grad`` and ``PyLayer`` (``autograd``), ``seed`` and
the random state (``core.rng``), the dtypes, places and
``set_device`` / ``get_device``, flags, and the subpackages. Tensors that
these functions create lie on the current device, the card unless
``set_device("cpu")`` says otherwise.
"""
from torch import nn as _torch_nn

from . import core
from .core import dtype as _dtype_mod
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.flags import get_flags, set_flags
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace,
                         Place, TPUPlace, XPUPlace, get_device,
                         is_compiled_with_cuda, is_compiled_with_tpu,
                         resolve_device, set_device)
from .core.rng import (get_cuda_rng_state, get_rng_state, seed,
                       set_cuda_rng_state, set_rng_state)
from .core.tensor import (Parameter, Tensor, enable_grad, is_grad_enabled,
                          no_grad, set_grad_enabled, to_tensor)

from . import tensor
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all
from .tensor import (attribute, creation, linalg, logic,  # noqa: F401
                     manipulation, math, random, search, sequence, stat,
                     to_string)

from . import autograd
from .autograd import grad

from . import (amp, framework, hapi, incubate, inference, io, jit, metric,
               nn, optimizer, profiler, quant, resilience, static, text,
               vision)
from . import callbacks, hub
from .framework import load, save
from .hapi import Model, flops, summary
from .nn import ParamAttr
from .tensor.manipulation import crop as crop_tensor
from .tensor.math import floor_mod

Layer = _torch_nn.Module
VarBase = Tensor
dtype = _dtype_mod.convert_dtype

__all__ = sorted(set(_tensor_all) | {
    "core", "tensor", "autograd", "grad", "amp", "framework", "hapi",
    "incubate", "inference", "io", "jit", "metric", "nn", "optimizer",
    "profiler", "quant", "resilience", "static", "text", "vision",
    "callbacks", "Model", "summary", "flops", "hub", "save", "load",
    "Layer", "ParamAttr",
    "resolve_device", "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
    "NPUPlace", "TPUPlace", "XPUPlace", "set_device", "get_device",
    "is_compiled_with_cuda", "is_compiled_with_tpu", "is_compiled_with_npu",
    "is_compiled_with_xpu", "get_cudnn_version", "bool_", "uint8", "int8",
    "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64",
    "complex64", "complex128", "dtype", "get_default_dtype",
    "set_default_dtype", "get_flags", "set_flags", "seed", "get_rng_state",
    "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state",
    "to_tensor", "Tensor", "Parameter", "VarBase", "no_grad",
    "enable_grad", "set_grad_enabled", "is_grad_enabled", "enable_static",
    "disable_static", "in_dynamic_mode", "in_dygraph_mode",
    "enable_dygraph", "disable_dygraph", "disable_signal_handler",
    "floor_mod", "crop_tensor", "check_shape"})


def enable_static() -> None:
    """Turn static mode on (``static``'s Program / Executor style)."""
    from .static.program import _enable_static_mode

    _enable_static_mode()


def disable_static(place=None) -> None:
    """Back to dygraph (eager) mode."""
    from .static.program import _disable_static_mode

    _disable_static_mode()


def in_dynamic_mode() -> bool:
    from .static.program import _in_static_mode

    return not _in_static_mode()


in_dygraph_mode = in_dynamic_mode
enable_dygraph = disable_static


def disable_dygraph() -> None:
    enable_static()


def disable_signal_handler() -> None:
    """Nothing to do: the port installs no signal handler at import."""
    return None


def check_shape(shape):
    """A shape argument checked: every entry an int (or None / -1 for an
    inferred one)."""
    if shape is None:
        raise TypeError("shape must not be None")
    for s in (shape if isinstance(shape, (list, tuple)) else [shape]):
        if s is not None and not isinstance(s, int):
            raise TypeError(f"shape entries must be int/None, got {type(s)}")
    return shape


def get_cudnn_version():
    """The cuDNN version torch runs with (None where it has none)."""
    import torch

    return torch.backends.cudnn.version()


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False
