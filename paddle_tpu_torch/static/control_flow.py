"""Control-flow ops: ``cond``, ``case``, ``switch_case``, ``while_loop``,
``increment`` and the tensor arrays — counterpart of
``paddle_tpu.static.control_flow``.

- **Eager** (no Program recording): plain Python over the tensors. Only
  the taken branch runs, and autograd records the ops that ran.
- **Recording** (inside ``program_guard``): each branch or loop body is
  traced into a sub-Program (``_subtrace``) and the call is recorded as
  ONE composite op, as the reference's ConditionalBlockOp / WhileOp hold
  a sub-block. At replay the composite reads its predicate on the host
  and runs the taken branch, or loops, over the fed values; autograd
  flows through the path taken. A loop is not run at record time (its
  outputs are zeros of the body's shapes), so a predicate that is true
  on the placeholders cannot spin there.

The reference lowers recorded control flow to ``lax.cond`` /
``lax.while_loop`` inside one compiled program; the port's replay is
eager, so every predicate costs a device-to-host read; the telemetry
counter ``static/pred_host_reads`` counts them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core import recording
from ..profiler.telemetry import get_telemetry
from .program import OpRecord, Program, _Out, _Var, run_ops

__all__ = ["cond", "case", "switch_case", "while_loop", "increment",
           "create_array", "array_write", "array_read", "array_length"]


def _read_pred(p) -> bool:
    """A recorded predicate's value, read on the host (counted)."""
    get_telemetry().counter("static/pred_host_reads")
    if isinstance(p, torch.Tensor):
        return bool(p.reshape(()))
    return bool(p)


def _eager_bool(p) -> bool:
    if isinstance(p, torch.Tensor):
        return bool(p.reshape(()))
    return bool(p)


def _recorder():
    rec = recording.active()
    return rec if rec is not None and not rec.quiet else None


# --------------------------------------------------------------------------
# tree helpers (tuples, lists and dicts of tensors)
# --------------------------------------------------------------------------
def _flatten(tree):
    """(leaves, structure): the structure rebuilds the tree from leaves."""
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for x in tree:
            lv, st = _flatten(x)
            leaves += lv
            subs.append((len(lv), st))
        return leaves, (type(tree), subs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, st = _flatten([tree[k] for k in keys])
        return leaves, (dict, keys, st)
    return [tree], None


def _unflatten(struct, leaves):
    if struct is None:
        return leaves[0]
    if struct[0] is dict:
        _, keys, st = struct
        return dict(zip(keys, _unflatten(st, leaves)))
    typ, subs = struct
    out, i = [], 0
    for n, st in subs:
        out.append(_unflatten(st, leaves[i:i + n]))
        i += n
    return typ(out)


# --------------------------------------------------------------------------
# recording: sub-traces and composite ops
# --------------------------------------------------------------------------
def _subtrace(rec, fn, args=(), bound=()):
    """Run ``fn(*args)`` eagerly while recording its ops into a fresh
    sub-Program; ``bound`` ids count as its inputs."""
    sub = Program()
    with rec.frame(sub, bound):
        out = fn(*args)
    return out, sub


def _body(rec, sub, out_leaves, bound_ids):
    """(external variable ids, out specs) of a traced body: the variables
    its ops read that neither it nor ``bound_ids`` produce, and per output
    leaf its variable id or the constant itself."""
    produced = set(bound_ids)
    ext: List[int] = []
    for op in sub.ops:
        for v in op.reads:
            if v not in produced and v not in ext:
                ext.append(v)
        produced.update(op.produces)
    specs = []
    for t in out_leaves:
        if isinstance(t, torch.Tensor) and (id(t) in produced
                                            or rec.is_var(t)):
            if id(t) not in produced and id(t) not in ext:
                ext.append(id(t))
            specs.append((id(t), None))
        else:
            specs.append((None, t))
    return ext, specs


def _replayer(sub, specs):
    ops = list(sub.ops)

    def replay(env):
        env = dict(env)
        run_ops(ops, env)
        return [env[uid] if uid is not None else c for uid, c in specs]

    return replay


def _var_tensors(rec, ids) -> list:
    """The tensor objects behind variable ids of the recording frames."""
    out = []
    for uid in ids:
        for f in rec.frames:
            t = f.program._var_refs.get(uid, f.bound.get(uid))
            if t is not None:
                out.append(t)
                break
        else:
            raise RuntimeError("control flow: a body reads a variable of "
                               "no enclosing program")
    return out


def _adopt_params(rec, *subs) -> None:
    for sub in subs:
        for p in sub.parameters.values():
            rec.program._add_param(p)


def _as_like(v, like):
    """``v`` as a tensor like ``like`` when the other branch (or the
    loop's carry) is a tensor there: a Python constant becomes a tensor,
    a converted function's unbound-name sentinel zeros (the reference's
    created-undefined-var)."""
    if like is None or isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float)):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return torch.zeros_like(like)


def _likes(*leaf_lists):
    """Per slot, the first tensor among the branches' leaves, or None."""
    return [next((x for x in xs if isinstance(x, torch.Tensor)), None)
            for xs in zip(*leaf_lists)]


def _record_cond(rec, pred, true_fn, false_fn):
    true_out, true_sub = _subtrace(rec, true_fn)
    false_out, false_sub = _subtrace(rec, false_fn)
    t_leaves, t_def = _flatten(true_out)
    f_leaves, f_def = _flatten(false_out)
    if t_def != f_def or len(t_leaves) != len(f_leaves):
        raise ValueError("cond branches must return the same structure "
                         f"under static mode; got {t_def} vs {f_def}")
    t_ext, t_specs = _body(rec, true_sub, t_leaves, ())
    f_ext, f_specs = _body(rec, false_sub, f_leaves, ())
    ext = t_ext + [v for v in f_ext if v not in t_ext]
    ext_t = _var_tensors(rec, ext)
    t_replay = _replayer(true_sub, t_specs)
    f_replay = _replayer(false_sub, f_specs)

    likes = _likes(t_leaves, f_leaves)

    def composite(p, *ext_vals):
        env = dict(zip(ext, ext_vals))
        res = t_replay(env) if _read_pred(p) else f_replay(env)
        return tuple(_as_like(v, like) for v, like in zip(res, likes))

    with rec.quieted():
        taken = t_leaves if _eager_bool(pred) else f_leaves
        outs = tuple(o.detach().clone() if isinstance(o, torch.Tensor)
                     else _as_like(o, like) for o, like in zip(taken, likes))
    if rec.tracked(pred) or ext:
        _adopt_params(rec, true_sub, false_sub)
        rec.record_op(composite, [pred] + ext_t, outs, "cond")
    return _unflatten(t_def, list(outs))


def _record_while(rec, cond_fn, body_fn, loop_vars):
    with rec.quieted():
        loop_vars = [v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                     for v in loop_vars]
    bound = [id(v) for v in loop_vars]
    pred0, cond_sub = _subtrace(rec, cond_fn, loop_vars, loop_vars)
    body_out, body_sub = _subtrace(rec, body_fn, loop_vars, loop_vars)
    body_out = list(body_out) if isinstance(body_out, (list, tuple)) \
        else [body_out]
    if len(body_out) != len(loop_vars):
        raise ValueError("body must return as many values as loop_vars")
    c_ext, c_specs = _body(rec, cond_sub, [pred0], bound)
    b_ext, b_specs = _body(rec, body_sub, body_out, bound)
    ext = [v for v in c_ext + b_ext if v not in bound]
    ext = list(dict.fromkeys(ext))
    ext_t = _var_tensors(rec, ext)
    c_replay = _replayer(cond_sub, c_specs)
    b_replay = _replayer(body_sub, b_specs)
    n = len(loop_vars)

    def composite(*vals):
        carry, base = list(vals[:n]), dict(zip(ext, vals[n:]))
        likes = list(carry)
        while True:
            env = dict(base)
            env.update(zip(bound, carry))
            if not _read_pred(c_replay(env)[0]):
                return tuple(carry)
            carry = [_as_like(v, like)
                     for v, like in zip(b_replay(env), likes)]

    if not ext and not any(rec.is_var(v) for v in loop_vars):
        # nothing fed reaches the loop: a constant, computed here
        with rec.quieted():
            return list(composite(*loop_vars))
    with rec.quieted():
        outs = tuple(torch.zeros_like(o) if isinstance(o, torch.Tensor)
                     else torch.as_tensor(o) for o in body_out)
    _adopt_params(rec, cond_sub, body_sub)
    rec.record_op(composite, list(loop_vars) + ext_t, outs, "while")
    return list(outs)


# --------------------------------------------------------------------------
# the API
# --------------------------------------------------------------------------
def cond(pred, true_fn: Callable = None, false_fn: Callable = None,
         name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``. Recorded, both
    branches must return the same structure."""
    rec = _recorder()
    if rec is not None:
        return _record_cond(rec, pred, true_fn, false_fn)
    fn = true_fn if _eager_bool(pred) else false_fn
    return fn() if fn is not None else None


def case(pred_fn_pairs: Sequence[Tuple], default: Callable = None,
         name=None):
    """The first pair whose predicate holds wins; ``default`` when none
    does (the last pair's function when ``default`` is None)."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    for pair in pred_fn_pairs:
        if len(pair) != 2 or not callable(pair[1]):
            raise TypeError("each pred_fn_pair must be (Tensor, callable)")
    if default is None:
        pred_fn_pairs, default = pred_fn_pairs[:-1], pred_fn_pairs[-1][1]
    result = default
    for pred, fn in reversed(list(pred_fn_pairs)):
        prev = result

        def make(pred=pred, fn=fn, prev=prev):
            return lambda: cond(pred, fn, prev)

        result = make()
    return result()


def switch_case(branch_index, branch_fns, default: Callable = None,
                name=None):
    """Dispatch on an integer index: ``branch_fns`` is a dict
    ``{int: fn}``, a list of ``(int, fn)`` or a list of functions; an
    index with no branch takes ``default`` (the largest key's when
    None)."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif branch_fns and callable(branch_fns[0]):
        pairs = list(enumerate(branch_fns))
    else:
        pairs = sorted(branch_fns)
    keys = [k for k, _ in pairs]
    fns = [f for _, f in pairs]
    if _recorder() is not None:
        idx = branch_index if isinstance(branch_index, torch.Tensor) \
            else torch.as_tensor(branch_index)
        result = default if default is not None else fns[-1]
        for k, fn in reversed(pairs):
            prev = result

            def make(k=k, fn=fn, prev=prev):
                return lambda: cond(idx == k, fn, prev)

            result = make()
        return result()
    i = int(branch_index.reshape(())) if isinstance(
        branch_index, torch.Tensor) else int(branch_index)
    if i in keys:
        return fns[keys.index(i)]()
    return default() if default is not None else fns[-1]()


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence,
               is_test=False, name=None):
    """Run ``body_fn`` while ``cond_fn`` holds; returns the loop vars.
    Eager: a Python loop (autograd records every iteration). Recorded: one
    composite op that loops at replay; the carries' shapes must not
    change."""
    if not callable(cond_fn) or not callable(body_fn):
        raise TypeError("cond and body must be callable")
    loop_vars = list(loop_vars)
    if not loop_vars:
        raise ValueError("loop_vars must be non-empty")
    rec = _recorder()
    if rec is not None:
        return _record_while(rec, cond_fn, body_fn, loop_vars)
    while _eager_bool(cond_fn(*loop_vars)):
        out = body_fn(*loop_vars)
        loop_vars = list(out) if isinstance(out, (list, tuple)) else [out]
    return loop_vars


def _identity(v):
    return v


def increment(x, value=1.0):
    """``x + value`` written into ``x``. Recorded, the program rebinds
    ``x``'s slot to the sum (the reference's in-place increment op) and
    the record-time value of ``x`` is left as it was."""
    rec = _recorder()
    if rec is not None and isinstance(x, torch.Tensor) and rec.is_var(x):
        rec.program.ops.append(_alias_op(x + value, x))
        return x
    if isinstance(x, torch.Tensor):
        with torch.no_grad():
            x.copy_(x + value)
        return x
    return x + value


def _alias_op(src, dst) -> OpRecord:
    """An op that binds ``dst``'s variable id to ``src``'s value."""
    return OpRecord(_identity, "assign", (_Var(id(src)),), {},
                    _Out(id(dst)), [id(src)], [id(dst)])


# --------------------------------------------------------------------------
# tensor arrays: Python lists (eager)
# --------------------------------------------------------------------------
def create_array(dtype="float32", initialized_list=None) -> list:
    return list(initialized_list or [])


def array_write(x, i, array: Optional[list] = None) -> list:
    if array is None:
        array = []
    idx = int(i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array: list, i):
    return array[int(i)]


def array_length(array: list) -> torch.Tensor:
    return torch.tensor(len(array), dtype=torch.int64)
