"""Eager collectives over ``torch.distributed`` — counterpart of
``paddle_tpu.distributed.communication``.

Each function takes the reference's arguments and works in place on its
tensor (NCCL for tensors on the card, gloo for CPU tensors: the backend
``init_parallel_env`` started). ``group`` is ``None`` (the world), a
``Group`` (``new_group``, a mesh axis's group, the hybrid topology's), or
a mesh axis name: in the reference a group's ``axis_name`` names a mesh
axis inside ``shard_map``; here it is that axis's process subgroup that
holds this rank (``fleet.mesh_utils``). ``src`` and ``dst`` are ranks of
the world, as in the reference and in ``torch.distributed``. ``ReduceOp.AVG``
is the sum divided by the group's size where the backend has no average.
Before ``init_parallel_env`` a single process is a world of one and each
collective is the identity; a process that the launcher made one of
several ranks raises instead (no transport to skip).

Every collective is recorded (``collective_events``: sequence number,
name, axis, arrival, duration, payload bytes; with
``PADDLE_TPU_COLLECTIVE_LOG`` a JSONL line each in this rank's file; the
``collective/<axis>/{count,ms,bytes}.eager`` telemetry gauges), and runs
under a hang guard when ``PADDLE_TPU_COLLECTIVE_TIMEOUT_S`` > 0: a peer
that died mid-call would park this rank forever, so past the timeout the
guard dumps every thread's stack and exits with the watchdog's
restartable code (113), which ``distributed.launch`` relaunches. The
process group's own timeout (``init_parallel_env``) bounds each call as
well.

``all_gather_object`` gathers one small JSON object per rank (the
integrity monitor's fingerprint exchange): over the process group when
the world is joined and its size is the one asked for, else through a
shared directory (``rendezvous_dir`` or ``PADDLE_TPU_INTEGRITY_DIR``)
that threads or processes of one machine, or hosts sharing a
filesystem, can use; a peer that never writes its part raises
``CollectiveTimeout``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import torch

from ..framework.io import atomic_replace
from .parallel import get_rank, get_world_size, is_initialized

__all__ = [
    "ReduceOp", "Group", "CollectiveTimeout", "all_reduce", "all_gather",
    "all_gather_object", "broadcast", "reduce", "scatter", "alltoall",
    "reduce_scatter", "barrier", "send", "recv", "wait", "new_group",
    "get_group", "split_group", "launch_world_rank", "collective_events",
    "collective_log_path", "reset_collective_recorder",
]


class CollectiveTimeout(RuntimeError):
    """A cross-rank wait exceeded its deadline — some peer is dead or
    hung. The caller converts this into a restartable exit; blocking
    forever is the one unacceptable outcome."""


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _torch_op(op):
    R = torch.distributed.ReduceOp
    return {ReduceOp.SUM: R.SUM, ReduceOp.MAX: R.MAX, ReduceOp.MIN: R.MIN,
            ReduceOp.PROD: R.PRODUCT, ReduceOp.AVG: R.SUM}[op]


class Group:
    """A communication group: explicit ``ranks`` (a ``torch.distributed``
    subgroup) or a mesh axis (``axis_name``: the subgroup of the current
    mesh along that axis that holds this rank)."""

    def __init__(self, ranks=None, axis_name=None, id=0, pg=None):
        self.ranks = sorted(ranks) if ranks else []
        self.axis_name = axis_name
        self.id = id
        self._pg = pg

    @property
    def process_group(self):
        """The ``torch.distributed`` group (None: the world)."""
        if self._pg is None and self.axis_name is not None:
            from .fleet.mesh_utils import get_mesh

            mesh = get_mesh()
            if mesh is not None and self.axis_name in mesh.axis_names:
                return mesh.group(self.axis_name).process_group
        return self._pg

    @property
    def nranks(self) -> int:
        if self.ranks:
            return len(self.ranks)
        if self.axis_name is not None:
            from .fleet.mesh_utils import axis_size

            n = axis_size(self.axis_name)
            if n is not None:
                return n
        return get_world_size()

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 outside it)."""
        me = get_rank()
        if self.ranks:
            return self.ranks.index(me) if me in self.ranks else -1
        if self.axis_name is not None:
            from .fleet.mesh_utils import get_mesh

            mesh = get_mesh()
            if mesh is not None and self.axis_name in mesh.axis_names:
                return mesh.group(self.axis_name).rank
        return me

    @property
    def world_size(self) -> int:
        return self.nranks

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis_name={self.axis_name!r})")


_groups: Dict[int, Group] = {0: Group(id=0)}
_next_gid = [1]


def new_group(ranks=None, backend=None, axis_name=None) -> Group:
    """A group over ``ranks`` (every rank of the world must call it, in
    the same order, as ``torch.distributed.new_group`` requires) or over
    a mesh axis (``axis_name``)."""
    gid = _next_gid[0]
    _next_gid[0] += 1
    pg = None
    if ranks is not None and axis_name is None:
        _require_world("new_group")
        if is_initialized():
            pg = torch.distributed.new_group(ranks=sorted(ranks),
                                             backend=backend)
    g = Group(ranks=ranks, axis_name=axis_name, id=gid, pg=pg)
    _groups[gid] = g
    return g


def get_group(gid=0) -> Optional[Group]:
    return _groups.get(gid)


def split_group(*a, **k):
    raise NotImplementedError("split_group is not implemented in the "
                              "reference either")


def _axis_of(group) -> Optional[str]:
    if group is None:
        return None
    if isinstance(group, str):
        return group
    return getattr(group, "axis_name", None)


def _pg(group):
    """The ``torch.distributed`` group of ``group`` (None: the world)."""
    if group is None:
        return None
    if isinstance(group, str):
        return Group(axis_name=group).process_group
    if isinstance(group, Group):
        return group.process_group
    return group  # a torch.distributed ProcessGroup


def _require_world(name: str) -> bool:
    """True when a world is joined; False for a single process without
    one (the collective is the identity); raises when the launcher made
    this process one of several ranks and no world was joined."""
    if is_initialized():
        return True
    world, _ = launch_world_rank()
    if world > 1:
        raise RuntimeError(
            f"{name}: this process is one of {world} ranks but the world "
            "is not joined; call distributed.init_parallel_env() first")
    return False


# -- hang conversion ----------------------------------------------------------
class _CollectiveGuard:
    """A timer armed around one collective: past ``timeout_s`` it dumps
    every thread's stack to stderr and exits the process with
    ``EXIT_WATCHDOG`` (``os._exit``: the rank is parked in the transport,
    and only the process's end releases it)."""

    def __init__(self, timeout_s: float, name: str):
        self.timeout_s = float(timeout_s)
        self.name = name
        self._timer: Optional[threading.Timer] = None

    def _fire(self) -> None:
        import sys

        from ..resilience.watchdog import EXIT_WATCHDOG, dump_stacks

        sys.stderr.write(dump_stacks(
            f"collective {self.name!r} exceeded {self.timeout_s:.1f}s — "
            f"peer dead or hung; exiting {EXIT_WATCHDOG} for a relaunch")
            + "\n")
        sys.stderr.flush()
        os._exit(EXIT_WATCHDOG)

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        return False


def _hang_guard(name: str):
    """The guard of one collective, armed only when
    ``PADDLE_TPU_COLLECTIVE_TIMEOUT_S`` > 0."""
    try:
        timeout = float(os.environ.get("PADDLE_TPU_COLLECTIVE_TIMEOUT_S",
                                       "0") or 0)
    except ValueError:
        timeout = 0.0
    if timeout <= 0:
        return contextlib.nullcontext()
    return _CollectiveGuard(timeout, f"communication.{name}")


# -- the collective recorder ----------------------------------------------------
# Collectives run in program order on every rank, so the per-rank sequence
# numbers name the same instance across ranks (a straggler shows up as a
# late arrival). Times are ``time.perf_counter``, the spans' clock.
_COLLECTIVE_LOG_ENV = "PADDLE_TPU_COLLECTIVE_LOG"
_GAUGE_AXES = {"dp", "mp", "tp", "pp", "sp", "sharding", "world"}
_recorder_lock = threading.Lock()
_collective_seq = itertools.count()
_collective_tail: deque = deque(maxlen=512)
_eager_totals: dict = {}  # axis -> {count, ms, bytes}
_log_path_cache: Optional[str] = None
_log_path_checked = False


def collective_log_path() -> Optional[str]:
    """This rank's collective-event JSONL path, or None (the in-memory
    tail only). A base path lands per rank: ``c.jsonl`` becomes
    ``c.rank3.jsonl`` unless its name already holds a ``rank<N>``."""
    global _log_path_cache, _log_path_checked
    if _log_path_checked:
        return _log_path_cache
    base = os.environ.get(_COLLECTIVE_LOG_ENV)
    if base:
        _, rank = launch_world_rank()
        if re.search(r"rank\d+", os.path.basename(base)):
            _log_path_cache = base
        else:
            root, ext = os.path.splitext(base)
            _log_path_cache = f"{root}.rank{rank}{ext or '.jsonl'}"
    _log_path_checked = True
    return _log_path_cache


def reset_collective_recorder() -> None:
    """Drop the tail and totals and re-read the log variable."""
    global _collective_seq, _log_path_cache, _log_path_checked
    with _recorder_lock:
        _collective_seq = itertools.count()
        _collective_tail.clear()
        _eager_totals.clear()
        _log_path_cache = None
        _log_path_checked = False


def collective_events(n: Optional[int] = None) -> list:
    """The most recent collective events (newest last)."""
    with _recorder_lock:
        events = list(_collective_tail)
    return events if n is None else events[-int(n):]


def _gauge_axis(axis: str) -> str:
    """An axis label of the telemetry gauges: the mesh vocabulary
    (``+``-joined for a group over several axes), else ``unmapped``."""
    parts = axis.split("+")
    return axis if all(p in _GAUGE_AXES for p in parts) else "unmapped"


def _record_collective(name: str, axis: Optional[str], t_start: float,
                       dur_s: float, nbytes: float) -> None:
    ev = {"seq": next(_collective_seq), "name": name,
          "axis": axis or "world", "t_start": float(t_start),
          "dur_s": float(dur_s), "nbytes": float(nbytes),
          "rank": get_rank()}
    with _recorder_lock:
        _collective_tail.append(ev)
        tot = _eager_totals.setdefault(ev["axis"], {"count": 0.0, "ms": 0.0,
                                                    "bytes": 0.0})
        tot["count"] += 1
        tot["ms"] += dur_s * 1e3
        tot["bytes"] += ev["nbytes"]
        snapshot = {a: dict(t) for a, t in _eager_totals.items()}
    from ..profiler.telemetry import get_telemetry

    tel = get_telemetry()
    tel.counter("collective/eager_calls")
    for a, t in snapshot.items():
        ga = _gauge_axis(a)
        tel.gauge(f"collective/{ga}/count.eager", t["count"])
        tel.gauge(f"collective/{ga}/ms.eager", t["ms"])
        tel.gauge(f"collective/{ga}/bytes.eager", t["bytes"])
    path = collective_log_path()
    if path:
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(ev) + "\n")
        except OSError:
            pass


@contextlib.contextmanager
def _collective_span(name: str, group=None, nbytes: float = 0.0):
    """Record one collective: its arrival is the entry (before any
    transport work), so a straggler shows as a late arrival."""
    t0 = time.perf_counter()
    try:
        with _hang_guard(name):
            yield
    finally:
        _record_collective(name, _axis_of(group), t0,
                           time.perf_counter() - t0, nbytes)


def _nbytes(t) -> float:
    if isinstance(t, torch.Tensor):
        return float(t.numel() * t.element_size())
    if isinstance(t, (list, tuple)):
        return float(sum(_nbytes(x) for x in t))
    return 0.0


# -- the collectives ------------------------------------------------------------
def all_gather_into(out: torch.Tensor, inp: torch.Tensor, pg=None) -> None:
    """``out`` ← the concatenation of every rank's ``inp`` (the
    single-tensor all-gather; newer torch names it ``all_gather_single``)."""
    dist = torch.distributed
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=pg)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, op, pg=None
                        ) -> None:
    """``out`` ← this rank's chunk of the reduction of every rank's
    ``inp`` (``reduce_scatter_single`` in newer torch)."""
    dist = torch.distributed
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, op=op, group=pg)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place on every rank; returns
    it (its pending work when ``sync_op`` is False)."""
    if not _require_world("all_reduce"):
        return tensor
    dist = torch.distributed
    pg = _pg(group)
    with _collective_span("all_reduce", group, _nbytes(tensor)):
        work = dist.all_reduce(tensor, op=_torch_op(op), group=pg,
                               async_op=not sync_op)
        if op == ReduceOp.AVG:
            if work is not None:
                work.wait()
                work = None
            tensor.div_(dist.get_world_size(pg))
    return tensor if work is None else work


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor`` in rank order, appended to ``tensor_list``
    (when given) and returned."""
    if not _require_world("all_gather"):
        parts = [tensor]
    else:
        pg = _pg(group)
        parts = [torch.empty_like(tensor)
                 for _ in range(torch.distributed.get_world_size(pg))]
        with _collective_span("all_gather", group, _nbytes(tensor)):
            torch.distributed.all_gather(parts, tensor.contiguous(),
                                         group=pg)
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
        return tensor_list
    return parts


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the concatenation of ``tensor_or_tensor_list`` (one chunk a
    rank along dim 0) over the group; this rank's chunk lands in
    ``tensor``."""
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([t.reshape(-1, *t.shape[1:]) for t in src])
    if not _require_world("reduce_scatter"):
        tensor.copy_(src.reshape(tensor.shape))
        return tensor
    dist = torch.distributed
    pg = _pg(group)
    with _collective_span("reduce_scatter", group, _nbytes(src)):
        reduce_scatter_into(tensor, src.contiguous(), _torch_op(op), pg)
        if op == ReduceOp.AVG:
            tensor.div_(dist.get_world_size(pg))
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s ``tensor`` on every rank of the group, in place."""
    if not _require_world("broadcast"):
        return tensor
    with _collective_span("broadcast", group, _nbytes(tensor)):
        torch.distributed.broadcast(tensor, src, group=_pg(group))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group into ``dst``'s copy (the other
    ranks' copies are left unspecified, as the backend leaves them)."""
    if not _require_world("reduce"):
        return tensor
    dist = torch.distributed
    pg = _pg(group)
    with _collective_span("reduce", group, _nbytes(tensor)):
        dist.reduce(tensor, dst, op=_torch_op(op), group=pg)
        if op == ReduceOp.AVG and get_rank() == dst:
            tensor.div_(dist.get_world_size(pg))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives ``src``'s ``tensor_list[i]`` into
    ``tensor``."""
    if not _require_world("scatter"):
        if tensor_list is not None:
            tensor.copy_(tensor_list[0])
        return tensor
    me = get_rank()
    if me == src and tensor_list is None:
        raise ValueError("scatter: the source rank needs tensor_list")
    with _collective_span("scatter", group, _nbytes(tensor_list)):
        torch.distributed.scatter(
            tensor, [t.contiguous() for t in tensor_list] if me == src
            else None, src=src, group=_pg(group))
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Rank r sends ``in_tensor_list[i]`` to rank i and receives rank i's
    ``in_tensor_list[r]`` as its i-th output."""
    if not _require_world("alltoall"):
        parts = list(in_tensor_list)
    else:
        x = torch.stack([t for t in in_tensor_list])
        out = torch.empty_like(x)
        with _collective_span("alltoall", group, _nbytes(x)):
            torch.distributed.all_to_all_single(out, x, group=_pg(group))
        parts = list(out.unbind(0))
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(parts)
        return out_tensor_list
    return parts


def barrier(group=None):
    if not _require_world("barrier"):
        return
    with _collective_span("barrier", group):
        torch.distributed.barrier(group=_pg(group))


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to rank ``dst`` (its pending work when
    ``sync_op`` is False)."""
    _require_world("send")
    dist = torch.distributed
    with _collective_span("send", group, _nbytes(tensor)):
        if sync_op:
            dist.send(tensor.contiguous(), dst, group=_pg(group))
            return None
        return dist.isend(tensor.contiguous(), dst, group=_pg(group))


def recv(tensor, src=0, group=None, sync_op=True):
    """Point-to-point receive from rank ``src`` into ``tensor``."""
    _require_world("recv")
    dist = torch.distributed
    with _collective_span("recv", group, _nbytes(tensor)):
        if sync_op:
            dist.recv(tensor, src, group=_pg(group))
            return tensor
        return dist.irecv(tensor, src, group=_pg(group))


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued on ``tensor``'s device is done (a
    pending work object is waited for)."""
    if hasattr(tensor, "wait") and not isinstance(tensor, torch.Tensor):
        tensor.wait()
        return tensor
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """A differentiable in-group sum: the gradient of every rank's input
    is the group's sum of the output gradients."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = x.clone()
        torch.distributed.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=ctx.pg)
        return g, None


def all_reduce_sum_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce(SUM)`` as a differentiable function (a new tensor)."""
    if not _require_world("all_reduce"):
        return x
    with _collective_span("all_reduce", group, _nbytes(x)):
        return _AllReduceSum.apply(x, _pg(group))


# -- the launcher's world and the small-object gather ---------------------------
def launch_world_rank() -> Tuple[int, int]:
    """``(world, rank)`` from the launcher's environment
    (``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``; 1 and 0 when unset or
    unreadable)."""
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    except ValueError:
        world = 1
    try:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        rank = 0
    return world, rank


# this rank's file of its previous gather, by rendezvous directory
_prev_gather_file: Dict[tuple, str] = {}


def all_gather_object(obj, key, rendezvous_dir=None, timeout_s=120.0,
                      poll_s=0.05, rank=None, world_size=None,
                      cleanup_prev=False) -> list:
    """Gather one small JSON-serializable object from each rank; returns
    the ``world_size`` objects ordered by rank.

    In a world of one the object comes back alone. In a joined world of
    ``world_size`` ranks it goes over the process group. Otherwise each
    rank atomically writes ``<key>.rank<r>.json`` under
    ``rendezvous_dir`` (default ``$PADDLE_TPU_INTEGRITY_DIR``) and polls
    for every peer's, raising ``CollectiveTimeout`` past ``timeout_s``.
    ``key`` must be unique per logical collective (callers key on the
    step). ``cleanup_prev=True`` removes this rank's file of its previous
    gather once the current one completes: every rank wrote this key only
    after reading all of the previous one, so that file is dead weight."""
    world, env_rank = launch_world_rank()
    if world_size is not None:
        world = int(world_size)
    r = env_rank if rank is None else int(rank)
    if world <= 1:
        return [obj]
    data = json.dumps(obj)
    if is_initialized() and torch.distributed.get_world_size() == world:
        out = [None] * world
        with _collective_span("all_gather_object", None, len(data)):
            torch.distributed.all_gather_object(out, data)
        return [json.loads(x) for x in out]
    if rendezvous_dir is None:
        rendezvous_dir = os.environ.get("PADDLE_TPU_INTEGRITY_DIR")
    if not rendezvous_dir:
        raise RuntimeError(
            f"all_gather_object: world size {world} but the world is not "
            f"joined (init_parallel_env) and no rendezvous_dir "
            f"(PADDLE_TPU_INTEGRITY_DIR) is set — no transport can carry "
            f"the gather")
    os.makedirs(rendezvous_dir, exist_ok=True)
    mine = os.path.join(rendezvous_dir, f"{key}.rank{r}.json")

    def _write(tmp):
        with open(tmp, "w") as f:
            f.write(data)

    with _collective_span("all_gather_object", None, len(data)):
        atomic_replace(mine, _write)
        paths = [os.path.join(rendezvous_dir, f"{key}.rank{i}.json")
                 for i in range(world)]
        deadline = time.monotonic() + float(timeout_s)
        while not all(os.path.exists(p) for p in paths):
            if time.monotonic() > deadline:
                missing = [i for i, p in enumerate(paths)
                           if not os.path.exists(p)]
                raise CollectiveTimeout(
                    f"rank {r}: all_gather_object({key!r}) gave up waiting "
                    f"for rank(s) {missing} after {timeout_s:.1f}s — a peer "
                    f"rank is dead or hung")
            time.sleep(float(poll_s))
        out = []
        for p in paths:
            with open(p) as f:
                out.append(json.load(f))
    if cleanup_prev:
        prev = _prev_gather_file.get((rendezvous_dir, r))
        if prev and prev != mine:
            try:
                os.unlink(prev)
            except OSError:
                pass
        _prev_gather_file[(rendezvous_dir, r)] = mine
    return out
