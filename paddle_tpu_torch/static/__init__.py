"""``paddle_tpu_torch.static`` — the Program / Executor declarative mode,
counterpart of ``paddle_tpu.static``.

Record a program with ``program_guard`` and ``data`` placeholders, attach
an optimizer with ``minimize``, and run it with ``Executor.run`` or
``run_steps`` (``program.py``, ``executor.py``); control flow
(``control_flow.py``) and the layers that make their own parameters
(``nn.py``). This module adds ``append_backward`` / ``gradients`` (the
parameters' gradients as fetchable variables), ``accuracy``, ``auc``,
``create_global_var``, ``Print``, the compatibility shims
(``CompiledProgram``, ``BuildStrategy``, ``ExecutionStrategy``,
``ParallelExecutor``, ``cpu_places``, ``cuda_places``, ``device_guard``)
and the program-state functions (``save``/``load``, ``save_vars``/
``load_vars``, ``set_program_state``/``load_program_state``,
``serialize_persistables``/``deserialize_persistables``,
``save_to_file``/``load_from_file``, ``normalize_program``). A program's
state is a dict of numpy arrays keyed by parameter name
(``program.param_name``), pickled. ``save_inference_model``,
``load_inference_model``, ``serialize_program`` and
``deserialize_program`` need the export of ``inference/_export.py`` and
``create_predictor``, which are not ported yet, and raise.
"""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from .. import amp  # noqa: F401
from ..core import recording
from ..core.place import CPUPlace, CUDAPlace
from ..nn.param_attr import ParamAttr  # noqa: F401
from . import nn  # noqa: F401
from .control_flow import (array_length, array_read, array_write,  # noqa
                           case, cond, create_array, increment, switch_case,
                           while_loop)
from .executor import Executor, _Scope, global_scope, scope_guard  # noqa
from .nn import create_parameter, py_func  # noqa: F401
from .program import (InputSpec, Program, _disable_static_mode,  # noqa
                      _enable_static_mode, _in_static_mode, current_program,
                      data, default_main_program, default_startup_program,
                      name_scope, param_name, program_guard, prune,
                      _tensor_leaves, _Var)

Scope = _Scope
Variable = torch.Tensor  # recorded variables are tensors


def _program(program=None) -> Program:
    return program or current_program() or default_main_program()


def _record_alias(src, dst, name) -> None:
    rec = recording.active()
    if rec is not None and not rec.quiet:
        rec.record_op(nn._alias, [src], [dst], name)


# ---------------------------------------------------------------------------
# gradients as variables
# ---------------------------------------------------------------------------
def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """``[(param, grad variable)]``: each gradient variable is bound to its
    parameter's gradient at every optimized run, so it can be fetched."""
    prog = _program()
    params = parameter_list or prog.all_parameters()
    out = []
    for p in params:
        g = prog._grad_map.get(id(p))
        if g is None:
            g = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
            prog._grad_map[id(p)] = g
            prog.vars_by_name[param_name(p) + "@GRAD"] = g
        out.append((p, g))
    return out


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradient variables of ``inputs`` (trainable parameters) for
    the program's one loss."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise NotImplementedError(
            "gradients() supports a single scalar target (the Executor "
            "differentiates the program's one loss)")
    if target_gradients is not None:
        raise NotImplementedError("target_gradients is not supported")
    prog = _program()
    append_backward(targets[0])
    outs = []
    for p in inputs:
        g = prog._grad_map.get(id(p))
        if g is None or not (p.requires_grad
                             and getattr(p, "trainable", True)):
            raise NotImplementedError(
                "gradients() can only return gradients of trainable "
                f"parameters (got {type(p).__name__}); gradients of "
                "intermediate values and frozen parameters are not bound "
                "by the Executor")
        outs.append(g)
    return outs


# ---------------------------------------------------------------------------
# metrics and Print
# ---------------------------------------------------------------------------
def _accuracy_counts(pred, lbl, k):
    topk = torch.topk(pred, k, dim=-1).indices
    hit = (topk == lbl.reshape(-1, 1).to(topk.dtype)).any(dim=-1)
    n_correct = hit.sum().to(torch.int64)
    n_total = torch.tensor(hit.shape[0] if hit.dim() else 1,
                           dtype=torch.int64, device=pred.device)
    acc = n_correct.float() / n_total.clamp(min=1).float()
    return acc, n_correct, n_total


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-``k`` accuracy of a batch; ``correct`` / ``total``, when given,
    are bound to the batch's counts (recorded: per run)."""
    acc, n_correct, n_total = recording.record_opaque(
        _accuracy_counts, input, label, k)
    for user, computed, name in ((correct, n_correct, "accuracy_correct"),
                                 (total, n_total, "accuracy_total")):
        if user is not None:
            with torch.no_grad():
                user.copy_(computed.reshape(user.shape))
            _record_alias(computed, user, name)
    return acc


def _auc_parts(pred, lbl, num_thresholds):
    pos = pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    y = lbl.reshape(-1).float()
    thr = torch.linspace(0.0, 1.0, num_thresholds, device=pred.device)
    ge = (pos[None, :] >= thr[:, None]).float()
    tp = (ge * y[None, :]).sum(1)
    fp = (ge * (1 - y[None, :])).sum(1)
    P = y.sum().clamp(min=1e-6)
    N = (1 - y).sum().clamp(min=1e-6)
    tpr, fpr = tp / P, fp / N
    a = ((tpr[:-1] + tpr[1:]) * 0.5 * (fpr[:-1] - fpr[1:])).sum()
    return a, tp, P - tp, N - fp, fp


def auc(input, label, curve="ROC", num_thresholds=2 ** 12 - 1, topk=1,
        slide_steps=1):
    """A batch's ROC AUC from the thresholded confusion counts: the
    reference's ``(auc, batch_auc, [tp, fn, tn, fp])``."""
    a, tp, fn, tn, fp = recording.record_opaque(_auc_parts, input, label,
                                                num_thresholds)
    return a, a, [tp, fn, tn, fp]


def _print_value(x, message):
    print(f"{message or ''} {x}")
    return x


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Print ``input`` when the op runs (every replay) and pass it on."""
    return recording.record_opaque(_print_value, input, message)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None, device=None):
    """A named tensor of ``shape`` filled with ``value`` in the current
    program; ``persistable`` makes it an untrained parameter, saved with
    the program's state."""
    from ..core.place import resolve_device
    from .program import convert_dtype, set_param_name

    prog = _program()
    dev = prog.device if device is None and prog.device is not None \
        else resolve_device(device)
    val = torch.full([int(s) for s in shape], float(value),
                     dtype=convert_dtype(dtype), device=dev)
    if persistable:
        t = torch.nn.Parameter(val, requires_grad=False)
        t.trainable = False
        if name:
            set_param_name(t, name)
        prog._add_param(t)
    else:
        t = val
    if name:
        prog.vars_by_name[name] = t
    return t


# ---------------------------------------------------------------------------
# compatibility shims
# ---------------------------------------------------------------------------
class CompiledProgram:
    """``with_data_parallel`` is accepted; the port runs one device."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        return self


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class BuildStrategy:
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = False
        self.memory_optimize = True
        self.enable_inplace = True


class ParallelExecutor:
    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, **kw):
        self._program = main_program


def cpu_places(device_count=None):
    return [CPUPlace()]


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else range(
        torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


xpu_places = cuda_places


@contextlib.contextmanager
def device_guard(device=None):
    yield


# ---------------------------------------------------------------------------
# program state
# ---------------------------------------------------------------------------
def _state_of(params) -> dict:
    return {param_name(p): p.detach().float().cpu().numpy()
            if p.dtype == torch.bfloat16 else p.detach().cpu().numpy()
            for p in params}


@torch.no_grad()
def _load_into(params, state: dict) -> None:
    for p in params:
        v = state.get(param_name(p))
        if v is None:
            continue
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{param_name(p)}: saved shape "
                             f"{tuple(v.shape)} != {tuple(p.shape)}")
        p.copy_(v.to(device=p.device, dtype=p.dtype))


def set_program_state(program, state_dict) -> None:
    """Copy ``state_dict``'s arrays (by parameter name) into the program's
    parameters, in place."""
    _load_into(program.all_parameters(), state_dict)


def _pdparams(path: str) -> str:
    return path if path.endswith(".pdparams") else path + ".pdparams"


def save(program, model_path, protocol=4) -> None:
    """The program's parameters to ``model_path.pdparams``."""
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(_pdparams(model_path), "wb") as f:
        pickle.dump(_state_of(program.all_parameters()), f, protocol)


def load(program, model_path, executor=None, var_list=None) -> None:
    set_program_state(program, load_program_state(model_path))


def load_program_state(model_path, var_list=None) -> dict:
    """The name -> array dict a saved program state holds (a
    ``.pdparams`` file, or a ``save_vars`` directory)."""
    path = _pdparams(model_path)
    if not os.path.exists(path) and os.path.isdir(model_path):
        path = os.path.join(model_path, "__all__.pdparams")
    with open(path, "rb") as f:
        return pickle.load(f)


def _selected(program, vars, predicate):
    ps = list(vars) if vars else _program(program).all_parameters()
    return [p for p in ps if predicate is None or predicate(p)]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None) -> None:
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, filename or "__all__.pdparams"),
              "wb") as f:
        pickle.dump(_state_of(_selected(main_program, vars, predicate)), f)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None) -> None:
    with open(os.path.join(dirname, filename or "__all__.pdparams"),
              "rb") as f:
        state = pickle.load(f)
    _load_into(_selected(main_program, vars, predicate), state)


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None) -> bytes:
    return pickle.dumps(_state_of(_program(program).all_parameters()))


def deserialize_persistables(program, data, executor=None) -> None:
    set_program_state(program, pickle.loads(data))


def save_to_file(path, content) -> None:
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars, fetch_vars) -> Program:
    """The program pruned to the ops the fetches depend on."""
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    pruned = Program()
    pruned.ops = prune(program.ops, [id(t) for t in fetch_vars])
    names = {id(t): n for n, t in program.feed_vars.items()}
    for t in feed_vars:
        pruned.add_feed_var(names.get(id(t), f"feed_{len(pruned.feed_vars)}"),
                            t)
    pruned._var_refs.update(program._var_refs)
    used = {id(t) for op in pruned.ops
            for t in _tensor_leaves((op.args, op.kwargs))}
    pruned.parameters = {uid: p for uid, p in program.parameters.items()
                         if uid in used}
    return pruned


def _bound(t, env, consts):
    """Template ``t`` of a recorded op's arguments with its variable
    slots read from ``env`` and its constant tensors (parameters,
    buffers) replaced by the module's copies in ``consts``."""
    if isinstance(t, _Var):
        return env[t.uid]
    if isinstance(t, torch.Tensor):
        return consts.get(id(t), t)
    if isinstance(t, list):
        return [_bound(x, env, consts) for x in t]
    if isinstance(t, tuple) and type(t) is tuple:
        return tuple(_bound(x, env, consts) for x in t)
    if isinstance(t, dict):
        return {k: _bound(v, env, consts) for k, v in t.items()}
    return t


class _InferenceProgram(torch.nn.Module):
    """A pruned program's feed → fetch replay as a module whose buffers
    are the constant tensors its ops read (what ``torch.export`` needs
    to store the weights beside the graph)."""

    def __init__(self, ops, feed_ids, fetch_ids):
        super().__init__()
        self._ops, self._feed_ids, self._fetch_ids = ops, feed_ids, fetch_ids
        self._const_ids = []
        seen = set()
        for op in ops:
            for t in _tensor_leaves((op.args, op.kwargs)):
                if id(t) not in seen:
                    seen.add(id(t))
                    self.register_buffer(f"c{len(self._const_ids)}",
                                         t.detach())
                    self._const_ids.append(id(t))

    def forward(self, *feeds):
        env = dict(zip(self._feed_ids, feeds))
        consts = {uid: getattr(self, f"c{i}")
                  for i, uid in enumerate(self._const_ids)}
        for op in self._ops:
            out = op.fn(*_bound(op.args, env, consts),
                        **_bound(op.kwargs, env, consts))
            if op._bind is not None:
                op._bind(env, out)
        return tuple(env[uid] for uid in self._fetch_ids)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None) -> None:
    """The program pruned to the feed → fetch subgraph (the training ops
    of a loss a fetch does not need are dropped), exported with its
    weights as ``path_prefix.pdexport`` (``inference/_export.py``), which
    ``load_inference_model`` and ``inference.create_predictor`` serve;
    ``path_prefix.pdmodel`` holds the feed and fetch names. A None/-1 dim
    of a placeholder stays dynamic in the artifact."""
    from ..inference._export import export_module, write_pdexport

    program = program or default_main_program()
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    names = {id(t): n for n, t in program.feed_vars.items()}
    feed_names = [names.get(id(t)) for t in feed_vars]
    if None in feed_names:
        raise ValueError("feed_vars must be placeholders of the program "
                         "(static.data)")
    ops = prune(program.ops, [id(t) for t in fetch_vars])
    produced = {uid for op in ops for uid in op.produces}
    needed = {uid for op in ops for uid in op.reads} - produced
    missing = sorted(n for n, t in program.feed_vars.items()
                     if id(t) in needed and n not in feed_names)
    if missing:
        raise ValueError(
            f"inference subgraph reads feed vars {missing} that are not in "
            "feed_vars — include them or fetch something upstream")
    module = _InferenceProgram(ops, [id(t) for t in feed_vars],
                               [id(t) for t in fetch_vars])
    specs = [(program.declared_shapes.get(n, list(t.shape)), t.dtype)
             for n, t in zip(feed_names, feed_vars)]
    device = program.device or feed_vars[0].device
    ep = export_module(module, specs, device)
    output_names = [f"output{i}" for i in range(len(fetch_vars))]
    in_specs = [([None if d is None or int(d) < 0 else int(d)
                  for d in shape], str(dt).replace("torch.", ""))
                for shape, dt in specs]
    write_pdexport(path_prefix, ep, feed_names, output_names, in_specs,
                   dtype="float32")
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump({"feed_names": feed_names, "fetch_names": output_names,
                     "in_specs": in_specs, "device": device.type}, f)


def load_inference_model(path_prefix, executor=None):
    """``(predictor, feed_names, fetch_names)`` of what
    ``save_inference_model`` wrote; the predictor runs on the executor's
    device, or without an executor where the program was exported."""
    from ..inference import Config, create_predictor

    with open(path_prefix + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    config = Config(path_prefix)
    device = getattr(executor, "device", None)
    if (device.type if device is not None else meta["device"]) == "cpu":
        config.disable_gpu()
    return create_predictor(config), meta["feed_names"], meta["fetch_names"]


def serialize_program(feed_vars, fetch_vars, program=None) -> bytes:
    """The deployable program as bytes: what ``save_inference_model``
    writes (the exported program with its weights)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "m")
        save_inference_model(prefix, feed_vars, fetch_vars, program=program)
        with open(prefix + ".pdexport", "rb") as f:
            export_bytes = f.read()
        with open(prefix + ".pdmodel", "rb") as f:
            meta = f.read()
    return pickle.dumps({"export": export_bytes, "meta": meta})


def deserialize_program(data, executor=None):
    """``(predictor, feed_names, fetch_names)`` of ``serialize_program``'s
    bytes, as ``load_inference_model`` returns them."""
    import tempfile

    blob = pickle.loads(data)
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "m")
        with open(prefix + ".pdexport", "wb") as f:
            f.write(blob["export"])
        with open(prefix + ".pdmodel", "wb") as f:
            f.write(blob["meta"])
        return load_inference_model(prefix, executor)
