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
"""
from . import callbacks
from .core.place import CPUPlace, CUDAPlace, resolve_device
from .framework import load, save
from .hapi import Model, summary

__all__ = ["resolve_device", "CPUPlace", "CUDAPlace", "Model", "save",
           "load", "summary", "callbacks", "enable_static",
           "disable_static", "in_dynamic_mode", "enable_dygraph",
           "disable_dygraph"]


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


enable_dygraph = disable_static


def disable_dygraph() -> None:
    enable_static()
