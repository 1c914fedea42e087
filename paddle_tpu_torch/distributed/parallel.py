"""Process environment of a distributed run — counterpart of
``paddle_tpu.distributed.parallel``.

``init_parallel_env()`` joins this process to its ``torch.distributed``
world: NCCL when the device is the card (the default; each rank takes
``cuda:<local rank>``), gloo when the caller asks for the CPU
(``device="cpu"``). The world comes from the launcher's environment, as
the reference reads it: ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID`` and
``PADDLE_TRAINER_ENDPOINTS`` (its first endpoint is the rendezvous), or
torch's ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
(``distributed.launch`` exports both). ``init_method`` overrides the
rendezvous, e.g. a ``file://`` store; ``PADDLE_DIST_DEVICE`` (``launch
--backend cpu`` exports ``cpu``) is the default device. A single process
with no launcher environment is a world of one, as in the reference, and
still gets a process group (an in-process store), so that every
collective runs through the backend; a backend that fails to start
raises.

Every collective of the world carries a timeout: ``timeout_s``, else
``PADDLE_TPU_COLLECTIVE_TIMEOUT_S``, else 600 s.

``data_parallel_scope(group, size)`` is the engines' hook for means whose
denominator depends on the data (a masked or ``ignore_index`` loss):
inside it, ``mean_denominator(count)`` is the global count over the
group's ``size`` ranks divided by ``size``, so that the average of the
ranks' means is the mean over the global batch.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "is_initialized", "data_parallel_scope", "mean_denominator"]

_DEFAULT_TIMEOUT_S = 600.0
_device: Optional[torch.device] = None  # the device of this rank's world


def _env_int(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _timeout(timeout_s) -> datetime.timedelta:
    if timeout_s is None:
        raw = os.environ.get("PADDLE_TPU_COLLECTIVE_TIMEOUT_S", "")
        timeout_s = float(raw) if raw.strip() else _DEFAULT_TIMEOUT_S
        if timeout_s <= 0:
            timeout_s = _DEFAULT_TIMEOUT_S
    return datetime.timedelta(seconds=float(timeout_s))


def is_initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def init_parallel_env(device=None, init_method: Optional[str] = None,
                      timeout_s: Optional[float] = None) -> "ParallelEnv":
    """Join the launcher's world (see the module docstring); a second call
    returns the world already joined."""
    global _device
    dist = torch.distributed
    if is_initialized():
        return ParallelEnv()
    from ..core.place import resolve_device

    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE")
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                     "").split(",") if e]
    if world is None and eps:
        world = len(eps)
    if init_method is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                           f"{os.environ['MASTER_PORT']}")
        elif eps:
            init_method = f"tcp://{eps[0]}"
    if device is None:
        device = os.environ.get("PADDLE_DIST_DEVICE") or None
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK",
                         "PADDLE_RANK_IN_NODE", default=0)
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_parallel_env: no backend for {dev}")
    kw = dict(backend=backend, timeout=_timeout(timeout_s))
    if init_method is None:
        if world not in (None, 1):
            raise RuntimeError(
                f"init_parallel_env: a world of {world} ranks but no "
                "rendezvous (PADDLE_TRAINER_ENDPOINTS, MASTER_ADDR/"
                "MASTER_PORT or init_method=)")
        # a single process: a world of one over an in-process store
        dist.init_process_group(store=dist.HashStore(), world_size=1,
                                rank=0, **kw)
    else:
        dist.init_process_group(init_method=init_method,
                                world_size=1 if world is None else world,
                                rank=rank, **kw)
    _device = dev
    return ParallelEnv()


def world_device() -> torch.device:
    """The device of this rank's collectives (the card for NCCL, the CPU
    for gloo)."""
    if _device is not None:
        return _device
    if is_initialized() and torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def get_rank(group=None) -> int:
    """This process's rank in the world (or in ``group``); 0 without a
    world."""
    if group is not None:
        return group.rank
    if is_initialized():
        return torch.distributed.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size(group=None) -> int:
    """The number of ranks of the world (or of ``group``); the launcher's
    count before the world is joined, 1 without one."""
    if group is not None:
        return group.nranks
    if is_initialized():
        return torch.distributed.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _env_int("PADDLE_RANK_IN_NODE", "PADDLE_LOCAL_RANK",
                        "LOCAL_RANK", default=get_rank())

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return self.world_size

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        return eps[self.rank] if eps and self.rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")


# -- means over the data-parallel group --------------------------------------
_data_scope: list = []  # (process group or None, size), innermost last


@contextlib.contextmanager
def data_parallel_scope(group, size: int):
    """Within: ``mean_denominator`` counts over ``group`` (``size``
    ranks that split the batch)."""
    _data_scope.append((group, int(size)))
    try:
        yield
    finally:
        _data_scope.pop()


def mean_denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a mean over ``count`` data-dependent entries
    (at least 1): ``max(count, 1)`` alone; inside a
    ``data_parallel_scope`` ``max(Σ count, 1) / size`` over the group,
    without a gradient."""
    count = count.float()
    if not _data_scope:
        return count.clamp(min=1)
    group, size = _data_scope[-1]
    total = count.detach().clone()
    if group is not None:
        torch.distributed.all_reduce(total, group=group)
    return total.clamp(min=1) / size
