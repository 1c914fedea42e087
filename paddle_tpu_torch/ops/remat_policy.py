"""Activation recompute policies — counterpart of
``paddle_tpu.ops.remat_policy``: its vocabulary (``normalize``),
``apply_policy``, which puts a training forward under one, and the
measured ladder of ``remat='auto'`` (``resolve``).

- ``'off'``: nothing is recomputed;
- ``'full'`` and ``'nothing'``: a region saves only its inputs, and its
  forward runs again in the backward
  (``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``);
- ``'dots'``: selective checkpointing — the outputs of the matrix
  products (``aten.mm``, ``aten.addmm``, ``aten.bmm``) are kept, the rest
  is recomputed; ``'dots_no_batch'`` keeps ``mm`` and ``addmm`` only;
- ``'offload'``: ``'dots_no_batch'``'s selection, held in pinned host
  memory (the reference's ``offload_dot_with_no_batch_dims("device",
  "pinned_host")``): the region's forward copies each kept product to the
  host as it is made, and its recompute copies them back in place of
  running them. Selective checkpointing keeps its tensors in a cache of
  its own, out of reach of ``torch.autograd.graph.save_on_cpu``, so the
  policy has its own pair of dispatch modes (``_OffloadSave``,
  ``_OffloadLoad``) where the kept tensors are stored;
- ``'auto'``: resolved once, on the engine's first batch, by ``resolve``
  over ``step_cost`` measurements (``ParallelTrainStep.lower_cost``).

``resolve`` is the reference's ladder line for line: no recompute when the
measured 'off' peak fits ``budget_bytes()`` (the device's memory, or
``PADDLE_TPU_DEVICE_HBM_BYTES``, times ``PADDLE_TPU_REMAT_BUDGET_FRAC``,
0.9); over it, a memory-bound step (its own FLOPs per byte below the
device's balance point, ``profiler.xla_cost.chip_peaks``) tries
``['nothing', 'offload']``, a compute-bound one ``['dots', 'nothing',
'offload']``, and the first that fits wins, else the smallest measured
peak. It publishes ``gauge/remat/<entry>`` (the policy's id) and
``gauge/remat/peak_hbm/<entry>``. ``step_cost`` is the counterpart of
``program_cost``: where the reference reads a compiled program's own
accounting, it measures one forward and backward (see its docstring).

The reference wraps the whole forward in ``jax.checkpoint`` and XLA
places each recomputation in the backward where it is needed. Eager
PyTorch recomputes a region all at once when the backward first reaches
it, so one region around the whole forward would rebuild every
activation before the backward starts and save no memory. The regions
are therefore the elements of each top-level ``nn.ModuleList`` of the
layer (GPT's decoder blocks, BERT's encoder layers); the whole forward is
one region only where the layer has no ``nn.ModuleList``. The values
recomputed are the reference's; only when they are recomputed differs.

A recomputed region draws the dropout masks it drew the first time: the
model's own dropout generators (every ``torch.Generator`` that a module
holds as ``generator``, which ``checkpoint``'s ``preserve_rng_state``
does not cover) are set to the state they had when the region first ran,
and put back afterwards. A region also recomputes with the parameter
tensors it first ran with (a forward on casts of the parameters, as the
engine's cast mode runs, keeps them). The hand-written kernels inside a
region (LayerNorm and attention forwards) run again in the recompute, and
their launch counters count both runs.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)
from torch.utils.flop_counter import FlopCounterMode

logger = logging.getLogger("paddle_tpu_torch.ops")

__all__ = ["POLICY_IDS", "normalize", "apply_policy", "step_cost",
           "budget_bytes", "resolve"]

# stable ids of the policies (the reference's gauge/remat/<entry> values)
POLICY_IDS = {"off": 0, "dots": 1, "dots_no_batch": 2, "nothing": 3,
              "offload": 4, "full": 5}

_aten = torch.ops.aten
_SAVED_PRODUCTS = {"dots": (_aten.mm, _aten.addmm, _aten.bmm),
                   "dots_no_batch": (_aten.mm, _aten.addmm),
                   "offload": (_aten.mm, _aten.addmm)}


def normalize(remat) -> str:
    """Engine constructor values -> canonical policy name. Accepts the
    legacy ``recompute`` vocabulary (False/True/'dots'/'dots_no_batch'/
    'nothing') plus 'off'/'full'/'offload'/'auto'."""
    if remat in (None, False, "off", ""):
        return "off"
    if remat is True or remat == "full":
        return "full"
    name = str(remat)
    if name in POLICY_IDS or name == "auto":
        return name
    raise ValueError(f"unknown remat policy {remat!r}; expected one of "
                     f"{sorted(POLICY_IDS)} or 'auto'")


def apply_policy(fn: Callable, policy, layer: nn.Module) -> Callable:
    """``fn`` (a forward of ``layer``) under the named policy: 'off'
    returns it untouched; otherwise each call of the returned function
    runs ``fn`` with every region of ``layer`` checkpointed."""
    policy = normalize(policy)
    if policy == "off":
        return fn
    if policy == "auto":
        raise ValueError("remat='auto' names no policy until resolve() "
                         "has measured one (the engines resolve it on "
                         "their first batch)")
    gens = _generators(layer)
    context_fn = functools.partial(_contexts, gens, policy)
    regions = _regions(layer)
    if not regions:
        return lambda *a, **k: checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context_fn, **k)

    def run(*args, **kwargs):
        with _checkpointed(regions, context_fn):
            return fn(*args, **kwargs)

    return run


def _regions(layer: nn.Module) -> List[nn.Module]:
    """The elements of every ``nn.ModuleList`` of ``layer`` that lies in
    no other region."""
    if isinstance(layer, nn.ModuleList):
        return list(layer)
    return [r for child in layer.children() for r in _regions(child)]


def _generators(layer: nn.Module) -> List[torch.Generator]:
    gens: Dict[int, torch.Generator] = {}
    for m in layer.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            gens[id(g)] = g
    return list(gens.values())


def _contexts(gens: List[torch.Generator], policy: str):
    """The (forward, recompute) context pair of one region's checkpoint."""
    entry: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward_ctx():
        entry[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, entry):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)

    saved = _SAVED_PRODUCTS.get(policy)
    if saved is None:
        return forward_ctx(), recompute_ctx()
    if policy == "offload":
        store: collections.deque = collections.deque()
        return (_both(forward_ctx(), _OffloadSave(store, saved)),
                _both(recompute_ctx(), _OffloadLoad(store, saved)))

    def policy_fn(ctx, op, *args, **kwargs):
        packet = getattr(op, "overloadpacket", op)
        return (CheckpointPolicy.MUST_SAVE if packet in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    sac_fwd, sac_re = create_selective_checkpoint_contexts(policy_fn)
    return _both(forward_ctx(), sac_fwd), _both(recompute_ctx(), sac_re)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _region_call(block: nn.Module, forward: Callable, context_fn, *args,
                 **kwargs):
    # (owner, name, tensor) of every parameter the block holds now: the
    # recompute puts these back in place for its run
    held = [(m, name, t) for m in block.modules()
            for name, t in m._parameters.items() if t is not None]

    def region(*a, **k):
        found = [(m, name, m._parameters[name]) for m, name, _ in held]
        for m, name, t in held:
            m._parameters[name] = t
        try:
            return forward(*a, **k)
        finally:
            for m, name, t in found:
                m._parameters[name] = t

    return checkpoint(region, *args, use_reentrant=False,
                      context_fn=context_fn, **kwargs)


@contextlib.contextmanager
def _checkpointed(regions: List[nn.Module], context_fn):
    """Route each region's calls through a checkpoint while inside."""
    for block in regions:
        forward = type(block).forward.__get__(block)
        block.forward = functools.partial(_region_call, block, forward,
                                          context_fn)
    try:
        yield
    finally:
        for block in regions:
            del block.forward


# ---------------------------------------------------------------------------
# 'offload': the kept products in pinned host memory
# ---------------------------------------------------------------------------
class _OffloadSave(TorchDispatchMode):
    """A region's forward: each kept product is copied to the host (pinned
    when it lies on the card) as it is made, in order."""

    def __init__(self, store: collections.deque, saved):
        super().__init__()
        self._store, self._saved = store, saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "overloadpacket", func) in self._saved:
            host = torch.empty_like(out, device="cpu",
                                    pin_memory=out.is_cuda)
            host.copy_(out, non_blocking=True)
            self._store.append((host, out.device))
        return out


class _OffloadLoad(TorchDispatchMode):
    """The region's recompute: each kept product is copied back in place
    of running it again (the forward's order)."""

    def __init__(self, store: collections.deque, saved):
        super().__init__()
        self._store, self._saved = store, saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "overloadpacket", func) in self._saved:
            host, device = self._store.popleft()
            return host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# 'auto': measured peaks and the reference's ladder
# ---------------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _StepCounter(TorchDispatchMode):
    """Counts every op's input and output bytes (XLA's unfused 'bytes
    accessed') and, with ``live``, the peak of the bytes of the storages
    that the ops create: each new storage's bytes are added when an op
    returns it and taken off by a finalizer when it dies."""

    def __init__(self, live: bool):
        super().__init__()
        self.bytes_accessed = 0
        self._live = live
        self._tracked: Dict[int, int] = {}
        self._now = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self._now -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
            map(_nbytes, outs))
        if self._live:
            old = {t.untyped_storage().data_ptr() for t in ins}
            for t in outs:
                st = t.untyped_storage()
                key = st.data_ptr()
                if not key or key in old or key in self._tracked:
                    continue  # a view, an in-place result or no storage
                self._tracked[key] = st.nbytes()
                self._now += st.nbytes()
                weakref.finalize(st, self._free, key)
            self.peak = max(self.peak, self._now)
        return out


def step_cost(run: Callable[[], None], device, resident_bytes: float = 0.0
              ) -> Optional[Dict[str, float]]:
    """``{peak_hbm_bytes, flops, bytes_accessed}`` of ``run()``, one
    forward and backward of a step, or None when it runs out of memory.

    ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count (the
    hand-written kernels, called outside ATen, are not in it) and
    ``bytes_accessed`` every op's input and output bytes. On the card
    ``run`` is called twice: once under those counters, then alone after
    ``torch.cuda.reset_peak_memory_stats()``, and the peak is
    ``torch.cuda.max_memory_allocated()`` (everything allocated,
    ``resident_bytes`` ignored). On the CPU, whose allocator keeps no
    statistics, ``run`` is called once and the peak is ``resident_bytes``
    plus the peak of the live bytes of the storages its ops create."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    counter = _StepCounter(live=not cuda)
    flops = FlopCounterMode(display=False)
    try:
        with flops, counter:
            run()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            run()
            torch.cuda.synchronize(device)
            peak = float(torch.cuda.max_memory_allocated(device))
        else:
            peak = float(resident_bytes) + counter.peak
    except torch.OutOfMemoryError as e:
        logger.info("remat_policy: candidate ran out of memory (%s)",
                    str(e)[:200])
        if cuda:
            torch.cuda.empty_cache()
        return None
    return {"peak_hbm_bytes": peak, "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes_accessed)}


def budget_bytes(device=None) -> float:
    """The peak a step must fit: the device's memory times
    ``PADDLE_TPU_REMAT_BUDGET_FRAC`` (default 0.9, clamped to
    [0.05, 1])."""
    from ..profiler.xla_cost import hbm_capacity_bytes

    try:
        frac = float(os.environ.get("PADDLE_TPU_REMAT_BUDGET_FRAC", "0.9"))
    except ValueError:
        frac = 0.9
    return hbm_capacity_bytes(device) * min(max(frac, 0.05), 1.0)


def _verdict_for(entry: str, base_cost: Dict[str, float],
                 device=None) -> str:
    """'compute-bound' | 'memory-bound': the candidate's own FLOPs per
    byte against the device's balance point (the port keeps no registry of
    earlier compiles for ``entry``)."""
    from ..profiler.xla_cost import chip_peaks

    peaks = chip_peaks(device)
    if base_cost["bytes_accessed"] <= 0 or peaks["bytes_per_s"] <= 0:
        return "compute-bound"
    intensity = base_cost["flops"] / base_cost["bytes_accessed"]
    return ("compute-bound"
            if intensity >= peaks["flops"] / peaks["bytes_per_s"]
            else "memory-bound")


_warned_off = False


def resolve(entry: str, lower_cost: Callable[[str], Optional[Dict]],
            telemetry=None, device=None) -> str:
    """The cheapest policy whose measured peak fits the budget
    (``lower_cost(policy)`` returns ``step_cost`` of the step under it, or
    None); publishes ``gauge/remat/<entry>`` and
    ``gauge/remat/peak_hbm/<entry>``."""
    from ..profiler.telemetry import get_telemetry
    from ..profiler.xla_cost import cost_analysis_mode

    global _warned_off
    tel = telemetry or get_telemetry()

    def publish(policy: str, peak: Optional[float]) -> str:
        tel.gauge(f"remat/{entry}", POLICY_IDS[policy])
        if peak is not None:
            tel.gauge(f"remat/peak_hbm/{entry}", peak)
        return policy

    if cost_analysis_mode() == "off":
        if not _warned_off:
            _warned_off = True
            logger.warning(
                "remat_policy: PADDLE_TPU_COST_ANALYSIS=0 — remat='auto' "
                "cannot measure peak memory and resolves to no remat; set a "
                "policy explicitly if this runs out of memory")
        return publish("off", None)
    budget = budget_bytes(device)
    base = lower_cost("off")
    if base is None:
        logger.warning("remat_policy: could not cost the no-remat step for "
                       "%s — resolving to no remat", entry)
        return publish("off", None)
    if base["peak_hbm_bytes"] <= budget:
        logger.info("remat_policy: %s peak %.2f GB fits budget %.2f GB — "
                    "no remat", entry, base["peak_hbm_bytes"] / 1e9,
                    budget / 1e9)
        return publish("off", base["peak_hbm_bytes"])
    verdict = _verdict_for(entry, base, device)
    ladder = (["nothing", "offload"] if verdict == "memory-bound"
              else ["dots", "nothing", "offload"])
    best_policy, best_peak = "off", base["peak_hbm_bytes"]
    for policy in ladder:
        cost = lower_cost(policy)
        if cost is None:
            continue
        peak = cost["peak_hbm_bytes"]
        if peak < best_peak:
            best_policy, best_peak = policy, peak
        if peak <= budget:
            logger.info(
                "remat_policy: %s (%s) over budget at %.2f GB — policy "
                "%r fits at %.2f GB (budget %.2f GB)", entry, verdict,
                base["peak_hbm_bytes"] / 1e9, policy, peak / 1e9,
                budget / 1e9)
            return publish(policy, peak)
    logger.warning(
        "remat_policy: %s (%s): no policy fits the %.2f GB budget — "
        "taking the smallest measured peak (%r at %.2f GB); expect "
        "allocator pressure", entry, verdict, budget / 1e9, best_policy,
        best_peak / 1e9)
    return publish(best_policy, best_peak)
