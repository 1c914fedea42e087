"""Program: the declarative graph — counterpart of
``paddle_tpu.static.program``.

While ``program_guard`` is active, the enclosed code runs eagerly as
usual and its torch calls are also appended to the Program (an SSA trace:
each op's function, its inputs as variable references or captured
constants, and its outputs). ``Executor.run`` replays the trace on the
fed values. The reference records at its own op layer (``apply_op``); the
port records with a ``torch.overrides.TorchFunctionMode`` (``_Recorder``)
that ``program_guard`` pushes, and the port's ``autograd.Function``s go
through ``core.recording.record_opaque`` (re-exported here), so each
records as one op that replays as its ``.apply``.

What is recorded:

- an op is recorded when one of its tensor inputs is a variable (a feed
  from ``data``, or the output of an earlier recorded op) or a parameter
  (``nn.Parameter``). Every other tensor it reads is a captured constant,
  as the reference's ``build_replay`` treats external tensors: a factory
  call (``torch.zeros``, ``torch.empty(...).bernoulli_``) stays out of the
  program and its value is fixed at record time — so dropout's mask is
  drawn once and reused by every run, as the reference's is;
- an in-place op is recorded only when it writes into a variable. A
  write into a parameter or a buffer (an initializer's fill, BatchNorm's
  running statistics) runs at record time and is not replayed: the
  program changes parameters only through its optimizer and
  ``buffer_updates``, as in the reference, where those writes are not
  ops;
- parameters are read live: a recorded op keeps the parameter object
  itself, so a run sees its current value, and the Program lists it in
  ``parameters`` (first use first);
- attribute reads (``.shape``, ``.dtype``, ``.data``) and anything that
  returns no tensor are not ops; a size read at record time is a
  constant, so an op that captured a placeholder's batch of 1 keeps it
  (``data`` records ``None``/-1 dims as 1, as the reference does).

Placeholders and parameters live on one device, named explicitly: the
default is ``"cuda"``, which raises without a card; the tests ask for the
CPU. A Program whose placeholders disagree on the device raises.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakIdKeyDictionary

from ..core import recording
from ..core.place import resolve_device

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "data", "InputSpec", "name_scope",
           "record_opaque", "current_program", "param_name",
           "convert_dtype"]

record_opaque = recording.record_opaque

_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool, "complex64": torch.complex64,
}


def convert_dtype(dtype, default: torch.dtype = torch.float32
                  ) -> torch.dtype:
    """A dtype given as a torch dtype, a numpy dtype or its name."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    try:
        return _DTYPES[name.replace("paddle.", "").replace("torch.", "")]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


# parameter names: given by ParamAttr(name=...), else made on first use
_param_names: "WeakIdKeyDictionary" = WeakIdKeyDictionary()
_param_counter = itertools.count()


def param_name(p: torch.Tensor) -> str:
    """The parameter's name (``ParamAttr``'s, else ``param_<n>`` given on
    its first use in a Program)."""
    name = _param_names.get(p)
    if name is None:
        name = _param_names[p] = f"param_{next(_param_counter)}"
    return name


def set_param_name(p: torch.Tensor, name: str) -> None:
    _param_names[p] = name


# ---------------------------------------------------------------------------
# op records
# ---------------------------------------------------------------------------
class _Var:
    """An input slot bound to a variable at replay."""
    __slots__ = ("uid",)

    def __init__(self, uid: int):
        self.uid = uid


class _Out:
    """An output slot: the variable id the value is bound to."""
    __slots__ = ("uid",)

    def __init__(self, uid: int):
        self.uid = uid


def _tensor_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensor_leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensor_leaves(x)


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_tensors(x, fn) for x in tree]
    if isinstance(tree, tuple) and type(tree) is tuple:
        return tuple(_map_tensors(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def _has_var(t) -> bool:
    if isinstance(t, _Var):
        return True
    if isinstance(t, (list, tuple)):
        return any(_has_var(x) for x in t)
    if isinstance(t, dict):
        return any(_has_var(x) for x in t.values())
    return False


def _resolver(t) -> Callable[[dict], Any]:
    """env -> the value of template ``t`` (variables looked up)."""
    if isinstance(t, _Var):
        uid = t.uid
        return lambda env: env[uid]
    if isinstance(t, (list, tuple)):
        subs = [_resolver(x) for x in t]
        if isinstance(t, list):
            return lambda env: [s(env) for s in subs]
        return lambda env: tuple(s(env) for s in subs)
    if isinstance(t, dict):
        subs = {k: _resolver(v) for k, v in t.items()}
        return lambda env: {k: s(env) for k, s in subs.items()}
    return lambda env: t


def _binder(t) -> Optional[Callable[[dict, Any], None]]:
    """(env, value) -> binds the output ids of template ``t``."""
    if isinstance(t, _Out):
        def bind(env, v, uid=t.uid):
            env[uid] = v
        return bind
    if not isinstance(t, (list, tuple)):
        return None
    subs = [_binder(x) for x in t]
    if not any(subs):
        return None

    def bind_all(env, v):
        for b, x in zip(subs, v):
            if b is not None:
                b(env, x)
    return bind_all


class OpRecord:
    """One recorded op: ``fn`` over inputs that are variable slots or
    constants, binding its outputs' ids. ``reads`` and ``produces`` are
    variable ids (for pruning and for a control-flow body's inputs)."""

    __slots__ = ("fn", "name", "args", "kwargs", "outs", "reads",
                 "produces", "_fixed", "_slots", "_kw", "_bind")

    def __init__(self, fn, name, args, kwargs, outs, reads, produces):
        self.fn, self.name = fn, name
        self.args, self.kwargs, self.outs = args, kwargs, outs
        self.reads, self.produces = tuple(reads), tuple(produces)
        self._fixed = list(args)
        self._slots = [(i, _resolver(a)) for i, a in enumerate(args)
                       if _has_var(a)]
        self._kw = _resolver(kwargs) if _has_var(kwargs) else None
        self._bind = _binder(outs)

    def run(self, env: dict):
        args = self._fixed
        if self._slots:
            args = list(args)
            for i, r in self._slots:
                args[i] = r(env)
        kwargs = self._kw(env) if self._kw is not None else self.kwargs
        out = self.fn(*args, **kwargs)
        if self._bind is not None:
            self._bind(env, out)
        return out

    def __repr__(self):
        return (f"{self.name}(reads={len(self.reads)}, "
                f"produces={len(self.produces)})")


def run_ops(ops, env: dict) -> dict:
    """Replay ``ops`` over ``env`` (variable id -> tensor) in place."""
    for op in ops:
        op.run(env)
    return env


def prune(ops, needed) -> list:
    """The ops that ``needed`` (variable ids) transitively depend on, in
    order — the reference's ``_prune_program`` walk. An id a later op
    re-binds (an in-place write, ``increment``) keeps both producers."""
    needed = set(needed)
    kept = []
    for op in reversed(ops):
        if any(p in needed for p in op.produces):
            kept.append(op)
            needed.update(op.reads)
    kept.reverse()
    return kept


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
class Program:
    def __init__(self):
        self.ops: List[OpRecord] = []
        self.feed_vars: Dict[str, torch.Tensor] = {}
        self.vars_by_name: Dict[str, torch.Tensor] = {}
        self.parameters: Dict[int, torch.Tensor] = {}
        self._var_refs: Dict[int, torch.Tensor] = {}  # keeps ids unique
        self._optimize = None  # (optimizer, loss variable)
        self._grad_map: Dict[int, torch.Tensor] = {}  # param id -> grad var
        self.declared_shapes: Dict[str, list] = {}
        # persistent-var updates that ride the training step (data_norm's
        # summaries): param id -> id of the recorded output holding its
        # post-step value; the Executor commits them after every
        # optimized run
        self.buffer_updates: Dict[int, int] = {}
        self.device: Optional[torch.device] = None

    # -- recording ---------------------------------------------------------
    def _add_param(self, p: torch.Tensor) -> None:
        if id(p) not in self.parameters:
            self.parameters[id(p)] = p
            param_name(p)

    def _add_var(self, t: torch.Tensor) -> None:
        self._var_refs[id(t)] = t

    def add_feed_var(self, name: str, t: torch.Tensor) -> None:
        if self.device is not None and t.device != self.device:
            raise ValueError(f"placeholder {name!r} on {t.device}, but the "
                             f"program's placeholders are on {self.device}")
        self.device = t.device
        self.feed_vars[name] = t
        self.vars_by_name[name] = t
        self._add_var(t)

    # -- paddle API ----------------------------------------------------------
    def global_block(self):
        return _BlockFacade(self)

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.ops = list(self.ops)
        p.feed_vars = dict(self.feed_vars)
        p.vars_by_name = dict(self.vars_by_name)
        p.parameters = dict(self.parameters)
        p._var_refs = dict(self._var_refs)
        p._optimize = None if for_test else self._optimize
        p._grad_map = {} if for_test else dict(self._grad_map)
        p.declared_shapes = dict(self.declared_shapes)
        p.buffer_updates = {} if for_test else dict(self.buffer_updates)
        p.device = self.device
        return p

    def all_parameters(self) -> List[torch.Tensor]:
        return list(self.parameters.values())

    def list_vars(self) -> List[torch.Tensor]:
        return list(self._var_refs.values())

    def __repr__(self):
        opt = (type(self._optimize[0]).__name__ if self._optimize
               else None)
        return (f"Program(ops={len(self.ops)}, feeds={list(self.feed_vars)}, "
                f"params={len(self.parameters)}, optimizer={opt}, "
                f"buffer_updates={len(self.buffer_updates)})")


class _BlockFacade:
    """Enough of Block's surface for common user code."""

    def __init__(self, program: Program):
        self.program = program

    @property
    def ops(self):
        return self.program.ops

    def var(self, name: str):
        return self.program.vars_by_name[name]

    def all_parameters(self):
        return self.program.all_parameters()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
# tensor properties that are ops (others — shape, dtype, data, grad — are
# metadata or aliases and never recorded)
_PROPERTY_OPS = frozenset({"T", "mT", "H", "mH", "real", "imag"})


class _Frame:
    __slots__ = ("program", "bound")

    def __init__(self, program: Program, bound=()):
        self.program = program
        self.bound = {id(t): t for t in bound}  # a loop body's carries


class _Recorder(TorchFunctionMode):
    """Records the torch calls made while its Program is being built.
    Control flow traces a branch or a loop body into a sub-Program by
    pushing a frame (``frame``); the variables of every frame below
    count as variables there (a body's external inputs), and ``bound``
    tensors (a loop's carries) too."""

    def __init__(self, program: Program):
        super().__init__()
        self.frames = [_Frame(program)]
        self.quiet = 0

    @property
    def program(self) -> Program:
        return self.frames[-1].program

    def is_var(self, t) -> bool:
        uid = id(t)
        for f in self.frames:
            if uid in f.program._var_refs or uid in f.bound:
                return True
        return False

    def tracked(self, t) -> bool:
        return isinstance(t, nn.Parameter) or self.is_var(t)

    @contextlib.contextmanager
    def frame(self, program: Program, bound=()):
        """Record into ``program``, ``bound`` (tensors) counting as
        variables."""
        self.frames.append(_Frame(program, bound))
        try:
            yield program
        finally:
            self.frames.pop()

    @contextlib.contextmanager
    def quieted(self):
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.quiet:
            self._maybe_record(func, args, kwargs, out)
        return out

    def _maybe_record(self, func, args, kwargs, out) -> None:
        name = getattr(func, "__name__", "")
        if name == "__get__":
            owner = getattr(func, "__self__", None)
            if getattr(owner, "__name__", "") not in _PROPERTY_OPS:
                return
        elif name == "__set__":
            return
        if not any(self.tracked(t) for t in _tensor_leaves((args, kwargs))):
            return
        dest = None
        if "out" in kwargs or name == "__setitem__" or (
                name.endswith("_") and not name.endswith("__")):
            dest = kwargs.get("out", args[0] if args else None)
            if not self.is_var(dest):
                return  # a write into a parameter, buffer or constant
        else:
            outs = list(_tensor_leaves(out))
            if not outs or any(isinstance(o, nn.Parameter) for o in outs):
                return  # metadata, or a parameter handed back (``.to``)
        self.record(func, args, kwargs, out, name, dest)

    def record(self, fn, args, kwargs, out, name, dest=None) -> None:
        """Append ``fn(*args, **kwargs) -> out`` to the current frame's
        program (``dest``: the variable an in-place op writes)."""
        prog = self.program
        reads = []

        def slot(t):
            if self.is_var(t):
                reads.append(id(t))
                return _Var(id(t))
            if isinstance(t, nn.Parameter):
                prog._add_param(t)
            return t

        args_t = _map_tensors(tuple(args), slot)
        kwargs_t = _map_tensors(dict(kwargs), slot)
        if dest is not None:
            outs_t, produces = None, [id(dest)]
        else:
            produces = []

            def out_slot(t):
                produces.append(id(t))
                prog._add_var(t)
                return _Out(id(t))

            outs_t = _map_tensors(tuple(out) if isinstance(out, tuple)
                                  else out, out_slot)
        prog.ops.append(OpRecord(fn, name, args_t, kwargs_t, outs_t, reads,
                                 produces))

    def record_op(self, fn, inputs, outputs, name) -> None:
        """Record ``fn(*inputs)``, which returns a tuple, as one op whose
        results bind ``outputs``: the control-flow composites and the
        aliases of ``py_func`` and ``accuracy``."""
        self.record(fn, inputs, {}, tuple(outputs), name)

    def record_opaque(self, fn, args):
        if self.quiet:
            return fn(*args)
        with self.quieted():
            out = fn(*args)
        if any(self.tracked(t) for t in _tensor_leaves(args)):
            owner = getattr(fn, "__self__", None)
            name = (f"{owner.__name__}.{fn.__name__}" if isinstance(
                owner, type) else getattr(fn, "__qualname__", "opaque"))
            self.record(fn, args, {}, out, name)
        return out


# ---------------------------------------------------------------------------
# default programs and the guard
# ---------------------------------------------------------------------------
class _State(threading.local):
    def __init__(self):
        self.main: Optional[Program] = None
        self.startup: Optional[Program] = None
        self.static_mode = False


_state = _State()
_default_main = Program()
_default_startup = Program()


def _enable_static_mode():
    _state.static_mode = True


def _disable_static_mode():
    _state.static_mode = False


def _in_static_mode() -> bool:
    return _state.static_mode


def current_program() -> Optional[Program]:
    return _state.main


def default_main_program() -> Program:
    return _state.main if _state.main is not None else _default_main


def default_startup_program() -> Program:
    return _state.startup if _state.startup is not None else _default_startup


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program=None):
    """Record the enclosed torch calls into ``main_program``. A guard
    inside a guard records into the inner program only."""
    prev_m, prev_s = _state.main, _state.startup
    _state.main = main_program
    _state.startup = startup_program or _default_startup
    rec = _Recorder(main_program)
    prev_rec = recording.set_active(rec)
    if prev_rec is not None:
        prev_rec.quiet += 1
    try:
        with rec:
            yield
    finally:
        recording.set_active(prev_rec)
        if prev_rec is not None:
            prev_rec.quiet -= 1
        _state.main, _state.startup = prev_m, prev_s


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def data(name: str, shape, dtype="float32", lod_level: int = 0,
         device=None) -> torch.Tensor:
    """A feed placeholder of the current program, on ``device`` (default
    ``"cuda"``, which raises without a card). ``None``/-1 dims are 1 for
    the recording pass; a run may feed any size there, but an op that
    read the size at record time keeps it."""
    dev = resolve_device(device)
    declared = list(shape)
    concrete = [1 if s is None or int(s) < 0 else int(s) for s in shape]
    t = torch.zeros(concrete, dtype=convert_dtype(dtype), device=dev)
    prog = default_main_program()
    prog.add_feed_var(name, t)
    prog.declared_shapes[name] = declared
    return t


class InputSpec:
    """The shape (``None``/-1 for a free dim), dtype and name of an
    input."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, t: torch.Tensor, name=None) -> "InputSpec":
        return cls(list(t.shape), str(t.dtype).replace("torch.", ""), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
