"""Executor — counterpart of ``paddle_tpu.static.executor``.

``run`` replays a Program's trace on the fed values, on the executor's
one device (``place``: ``CPUPlace()``, ``CUDAPlace(i)``, a device string;
the default is the card, and asking for it without one raises). The
reference compiles the trace into one jitted XLA step; the port replays it
eagerly, op by op, and its "compile" is the cached replay plan: the ops
the fetches, the loss and the ``buffer_updates`` depend on (the
reference's prune), built once per (program, fetch list). Neither
``torch.compile`` nor CUDA-graph capture is used.

- A **forward** program (no optimizer) replays under ``torch.no_grad``.
- A **training** program (``Optimizer.minimize`` recorded its loss):
  replay under autograd, ``backward`` of the loss, the gradients bound to
  the ``static.gradients`` / ``append_backward`` variables, the port's own
  ``optimizer.step()`` (Adam and AdamW: the multi-tensor kernel on the
  card, a global-norm clip folded in), the gradients cleared, the
  ``buffer_updates`` committed, and under ``FLAGS_check_nan_inf`` the
  finite check of the loss, gradients and parameters after the commit.
  Like the port's engines the step refuses ``ClipGradByValue`` and
  ``ClipGradByNorm``, which the reference's compiled step skips without a
  word.
- ``run_steps`` runs a window of ``n_steps`` training steps: each feed is
  the same every step, or stacked on a leading ``[n_steps]`` axis
  (detected by rank); an ``LRScheduler`` is sampled ``n_steps - 1`` times
  (stepped before every step but the first), and the fetches come back
  stacked.

Feeds given as numpy arrays go to the device in one pinned copy; a feed
given as a tensor must already be on the executor's device. A fetch of a
bf16 tensor comes back as f32 numpy, as ``framework.io`` writes one.
Telemetry: the counters ``executor/compiles`` (replay plans built) and
``executor/runs`` (steps replayed), the histogram ``executor/step_ms``
(the host interval between two runs, a window's over its steps), the
spans ``h2d``, ``compute`` and ``d2h``, goodput's ``productive_step``
and the watchdog's heartbeat at every call.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..core import recording, sanitizer
from ..core.place import CPUPlace, CUDAPlace, resolve_device
from ..nn.clip import ClipGradByGlobalNorm
from ..optimizer.lr import LRScheduler
from ..profiler import goodput as _goodput
from ..profiler import spans as _spans
from ..profiler.telemetry import get_telemetry
from ..resilience import watchdog as _watchdog
from .program import Program, default_main_program, param_name, prune

__all__ = ["Executor", "global_scope", "scope_guard"]


# ---------------------------------------------------------------------------
# scope: a name -> host tensor store
# ---------------------------------------------------------------------------
class _ScopeTensor:
    """Minimal LoDTensor facade held by a scope variable."""

    def __init__(self):
        self._array = None

    def set(self, array, place=None):
        self._array = np.asarray(array)

    def shape(self):
        return [] if self._array is None else list(self._array.shape)

    def __array__(self, dtype=None, copy=None):
        a = self._array if self._array is not None else np.zeros(0)
        return a.astype(dtype) if dtype else a


class _ScopeVar:
    def __init__(self, name):
        self.name = name
        self._tensor = _ScopeTensor()

    def get_tensor(self):
        return self._tensor


class _Scope:
    """Name -> variable store (``var`` creates or gets a variable holding
    a host tensor)."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        if name not in self._vars:
            self._vars[name] = _ScopeVar(name)
        return self._vars[name]

    def find_var(self, name):
        return self._vars.get(name)


_global_scope = _Scope()


def global_scope() -> _Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    yield scope


# ---------------------------------------------------------------------------
# devices and feeds
# ---------------------------------------------------------------------------
def _device_of(place) -> torch.device:
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        place = f"cuda:{place.index}"
    dev = resolve_device(place)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    if t.device.type != dev.type:
        return False
    return dev.type != "cuda" or (
        t.device.index if t.device.index is not None
        else torch.cuda.current_device()) == dev.index


def _host_to_device(host: Dict[str, np.ndarray], dev: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Numpy arrays as tensors on ``dev``: on the card one pinned buffer
    and one copy for them all."""
    if dev.type != "cuda":
        return {n: torch.tensor(a) for n, a in host.items()}
    arrays = {n: np.ascontiguousarray(a) for n, a in host.items()}
    offsets, total = {}, 0
    for n, a in arrays.items():
        offsets[n] = total
        total += -(-a.nbytes // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    for n, a in arrays.items():
        if a.nbytes:
            buf[offsets[n]:offsets[n] + a.nbytes].copy_(
                torch.from_numpy(a.reshape(-1).view(np.uint8)))
    on_dev = buf.to(dev, non_blocking=True)
    out = {}
    for n, a in arrays.items():
        dtype = torch.from_numpy(a[:0].reshape(-1)).dtype
        out[n] = on_dev[offsets[n]:offsets[n] + a.nbytes].view(
            dtype).reshape(a.shape)
    return out


def _program_of(program) -> Program:
    if isinstance(program, Program):
        return program
    return getattr(program, "_program", None) or default_main_program()


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Plan:
    """A program's cached replay: the pruned ops, and after each the
    variables no later op reads and the step does not need (dropped from
    the replay's environment, so an activation lives only as long as
    autograd or a later op holds it, as in eager code)."""

    def __init__(self, program: Program, ops, fetch, feed_ids, train,
                 keep):
        self.program, self.ops, self.fetch = program, ops, fetch
        self.feed_ids = feed_ids  # name -> variable id (the fed ones)
        self.train = train
        self.check = sanitizer.jit_check_enabled()  # read at build
        self.nan_names: List[str] = []
        last = {}
        for i, op in enumerate(ops):
            for uid in (*op.reads, *op.produces):
                last[uid] = i
        self.release = [[] for _ in ops]
        for uid, i in last.items():
            if uid not in keep:
                self.release[i].append(uid)

    def replay(self, env: dict) -> None:
        for op, dead in zip(self.ops, self.release):
            op.run(env)
            for uid in dead:
                env.pop(uid, None)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
class Executor:
    def __init__(self, place=None):
        self.place = place
        self.device = _device_of(place)
        self._plans: Dict[tuple, _Plan] = {}
        self._last_t: Optional[float] = None

    def close(self):
        self._plans.clear()

    # -- the public entry points ---------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        _watchdog.heartbeat()
        with _goodput.activity("productive_step"):
            program = _program_of(program)
            feeds = self._feeds(program, feed or {})
            plan, fresh = self._plan(program, fetch_list or [])
            with _spans.span("compute", cat="compute"):
                outs = self._step(plan, feeds)
            self._observe(fresh, 1)
            return self._fetched(outs, return_numpy)

    def run_steps(self, program=None, feed=None, fetch_list=None,
                  n_steps=None, return_numpy=True, step_scheduler=True):
        """A window of ``n_steps`` training steps; the fetches stacked on
        a leading [n_steps] axis."""
        program = _program_of(program)
        if program._optimize is None:
            raise ValueError("run_steps requires a program with an "
                             "optimizer (opt.minimize(loss) recorded)")
        if n_steps is None:
            raise ValueError("n_steps is required")
        n_steps = int(n_steps)
        _watchdog.heartbeat()
        with _goodput.activity("productive_step"):
            feeds = self._feeds(program, feed or {})
            windowed = {n: t.dim() == len(program.feed_vars[n].shape) + 1
                        for n, t in feeds.items()}
            plan, fresh = self._plan(program, fetch_list or [])
            opt = program._optimize[0]
            sched = opt._learning_rate if step_scheduler and isinstance(
                opt._learning_rate, LRScheduler) else None
            steps = []
            with _spans.span("compute", cat="compute"):
                for i in range(n_steps):
                    if i and sched is not None:
                        sched.step()
                    steps.append(self._step(plan, {
                        n: t[i] if windowed[n] else t
                        for n, t in feeds.items()}))
            self._observe(fresh, n_steps)
            outs = [torch.stack([s[j] for s in steps])
                    for j in range(len(plan.fetch))]
            return self._fetched(outs, return_numpy)

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.train_from_dataset needs io/data_feed.py (the "
            "dataset feed), which is not ported yet")

    def infer_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.infer_from_dataset needs io/data_feed.py (the "
            "dataset feed), which is not ported yet")

    # -- feeds and fetches ---------------------------------------------------
    def _feeds(self, program: Program, feed: dict) -> Dict[str, torch.Tensor]:
        out, host = {}, {}
        for name, v in feed.items():
            var = program.feed_vars.get(name)
            if var is None:
                raise KeyError(f"feed {name!r}: the program has no such "
                               f"placeholder ({sorted(program.feed_vars)})")
            if isinstance(v, torch.Tensor):
                if not _on(v, self.device):
                    raise ValueError(
                        f"feed {name!r} is on {v.device}, the executor "
                        f"runs on {self.device}: move it first")
                out[name] = v
            else:
                host[name] = np.asarray(v)
        if host:
            with _spans.span("h2d", cat="h2d"):
                out.update(_host_to_device(host, self.device))
        for name, t in out.items():
            want = program.feed_vars[name].dtype
            if t.dtype != want:
                out[name] = t.to(want)
        return out

    def _fetched(self, outs, return_numpy):
        if not return_numpy:
            return outs
        with _spans.span("d2h", cat="d2h"):
            return [_numpy(o) for o in outs]

    def _fetch_spec(self, program: Program, f):
        if isinstance(f, str):
            f = program.vars_by_name[f]
        if isinstance(f, nn.Parameter):
            return ("param", f)
        if isinstance(f, torch.Tensor):
            return ("var", id(f))
        raise TypeError(f"cannot fetch {f!r}")

    # -- the plan --------------------------------------------------------------
    def _plan(self, program: Program, fetch_list):
        fetch = [self._fetch_spec(program, f) for f in fetch_list]
        key = (id(program), len(program.ops), tuple(
            v if k == "var" else id(v) for k, v in fetch),
            None if program._optimize is None else (
                id(program._optimize[0]), id(program._optimize[1])))
        plan = self._plans.get(key)
        if plan is not None and plan.program is program:
            return plan, False
        get_telemetry().counter("executor/compiles")
        self._check_devices(program)
        targets = [v for k, v in fetch if k == "var"]
        train = None
        if program._optimize is not None:
            opt, loss = program._optimize
            clip = opt._grad_clip
            if clip is not None and not isinstance(clip,
                                                   ClipGradByGlobalNorm):
                raise NotImplementedError(
                    f"Executor: {type(clip).__name__} needs a pass of its "
                    "own that the static step does not have; the "
                    "reference's compiled step skips it silently. Use "
                    "ClipGradByGlobalNorm")
            targets += [id(loss), *program.buffer_updates.values()]
            train = (opt, id(loss))
        ops = prune(program.ops, targets)
        needed = set(targets)
        for op in ops:
            needed.update(op.reads)
        feed_ids = {n: id(t) for n, t in program.feed_vars.items()
                    if id(t) in needed}
        keep = set(targets) | {id(g) for g in program._grad_map.values()}
        plan = _Plan(program, ops, fetch, feed_ids, train, keep)
        self._plans[key] = plan
        self._last_t = None  # the interval spanning a build is no step
        return plan, True

    def _check_devices(self, program: Program) -> None:
        for what, t in [*(("placeholder " + n, v)
                          for n, v in program.feed_vars.items()),
                        *(("parameter " + param_name(p), p)
                          for p in program.parameters.values())]:
            if not _on(t, self.device):
                raise ValueError(f"{what} is on {t.device}, the executor "
                                 f"runs on {self.device}")

    # -- one step ----------------------------------------------------------------
    def _step(self, plan: _Plan, feeds: Dict[str, torch.Tensor]) -> list:
        rec = recording.active()  # a run inside program_guard records no op
        with rec.quieted() if rec is not None else contextlib.nullcontext():
            return self._replay_step(plan, feeds)

    def _replay_step(self, plan: _Plan, feeds: Dict[str, torch.Tensor]
                     ) -> list:
        missing = sorted(set(plan.feed_ids) - set(feeds))
        if missing:
            raise ValueError(f"the fetched values need the feeds {missing}")
        env = {uid: feeds[n] for n, uid in plan.feed_ids.items()}
        if plan.train is None:
            with torch.no_grad():
                plan.replay(env)
            return self._collect(plan, env)
        program = plan.program
        opt, loss_id = plan.train
        with torch.enable_grad():
            plan.replay(env)
            env[loss_id].backward()
        for pid, gvar in program._grad_map.items():
            g = program.parameters[pid].grad
            env[id(gvar)] = (g.detach().clone() if g is not None
                             else torch.zeros_like(gvar))
        outs = self._collect(plan, env)
        grads = ({param_name(p): p.grad for p in opt._parameter_list
                  if p.grad is not None} if plan.check else None)
        opt.step()
        opt.clear_grad()
        with torch.no_grad():
            for pid, src in program.buffer_updates.items():
                p = program.parameters[pid]
                p.copy_(env[src].to(p.dtype))
        if plan.check:
            flags = sanitizer.finite_flags(
                plan.nan_names, loss=env[loss_id], grad=grads,
                param={param_name(p): p for p in program.all_parameters()})
            sanitizer.raise_if_nonfinite(plan.nan_names, flags)
        return outs

    @staticmethod
    def _collect(plan: _Plan, env: dict) -> list:
        outs = []
        refs = plan.program._var_refs
        for kind, v in plan.fetch:
            if kind == "param":
                outs.append(v.detach().clone())
            else:
                outs.append((env[v] if v in env else refs[v]).detach())
        return outs

    def _observe(self, fresh: bool, n_steps: int) -> None:
        tel = get_telemetry()
        tel.counter("executor/runs", n_steps)
        now = time.perf_counter()
        if not fresh and self._last_t is not None:
            tel.observe("executor/step_ms",
                        (now - self._last_t) * 1e3 / n_steps)
        self._last_t = now
