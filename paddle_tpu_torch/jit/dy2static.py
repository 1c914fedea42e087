"""dygraph-to-static conversion: AST rewriting of data-dependent Python
control flow into ``static`` control-flow calls — counterpart of
``paddle_tpu.jit.dy2static``, the pure-``ast`` part copied as it is.

The rewrite turns ``if`` / ``while`` / ``for i in range(...)`` / ``and`` /
``or`` / ``not`` over tensors into the ``convert_*`` helpers, and first
lowers ``return`` / ``break`` / ``continue`` inside them into value and
flag threading (``_EscapeRewriter``). The reference's helpers dispatch
three ways (eager Python, ``lax`` under a JAX tracer, a composite op while
a Program records); the port has no tracer, so a value is "dynamic" only
while a Program records (``_is_dynamic``):

- eager, the converted function keeps Python's semantics (a tensor test
  is read with ``bool``);
- inside ``program_guard``, ``if`` becomes ``static.cond`` and a loop
  ``static.while_loop`` — the composite ops of ``static.control_flow``,
  which branch on the fed values at every run.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import Callable, List

import torch

from ..core import recording

__all__ = [
    "convert_to_static",
    "convert_ifelse",
    "convert_while",
    "convert_logical_and",
    "convert_logical_or",
    "convert_logical_not",
    "convert_bool",
]


# ---------------------------------------------------------------------------
# runtime conversion helpers (reference: dygraph_to_static/convert_operators.py)
# ---------------------------------------------------------------------------
def _recording() -> bool:
    rec = recording.active()
    return rec is not None and not rec.quiet


def _is_dynamic(x) -> bool:
    """A tensor while a Program records: its value is the run's."""
    return isinstance(x, torch.Tensor) and _recording()


def _truth(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(x.all()) if x.dim() else bool(x)
    return bool(x)


class _Undefined:
    """Sentinel for names unbound before a converted block (the reference's
    UndefinedVar, dygraph_to_static/utils.py). Any USE raises the NameError
    python would have raised — only threading it through the branch plumbing
    untouched is allowed."""

    __slots__ = ()

    def __repr__(self):
        return "<undefined before converted control flow>"

    def _raise(self, *a, **k):
        raise NameError(
            "variable used before assignment: it was unbound before a "
            "converted if/while and the taken branch did not assign it")

    __getattr__ = _raise
    __bool__ = _raise
    __float__ = _raise
    __int__ = _raise
    __iter__ = _raise
    __call__ = _raise
    __add__ = __radd__ = __sub__ = __rsub__ = _raise
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _raise
    __getitem__ = __len__ = _raise


UNDEF = _Undefined()


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable, args=()):
    """Dispatch an ``if``: a recorded ``static.cond`` while a Program
    records, else the Python branch (ifelse_transformer.py semantics)."""
    if _recording():
        from ..static.control_flow import cond

        return cond(pred, lambda: true_fn(*args), lambda: false_fn(*args))
    return true_fn(*args) if _truth(pred) else false_fn(*args)


def convert_while(cond_fn: Callable, body_fn: Callable, loop_vars: tuple):
    """Dispatch a ``while`` (loop_transformer.py semantics).

    Loop vars first assigned INSIDE the body arrive as the UNDEF sentinel.
    Eagerly that is python-exact (zero-trip leaves them undefined; one trip
    overwrites them). Recorded, the loop's carries need shapes, so the body
    is run once on the inits — write-before-read slots produce real values
    — and the UNDEF inits are replaced by zeros of those (a zero-trip
    recorded loop then yields zeros: the documented deviation, matching
    the reference's created-undefined-var behavior)."""
    first = cond_fn(*loop_vars)
    if _is_dynamic(first) or any(_is_dynamic(v) for v in loop_vars
                                 if not isinstance(v, _Undefined)):
        from ..static.control_flow import while_loop

        if any(isinstance(v, _Undefined) for v in loop_vars):
            template = tuple(body_fn(*loop_vars))

            def zero_like(t):
                if isinstance(t, torch.Tensor):
                    return torch.zeros_like(t)
                return torch.zeros((), dtype=torch.as_tensor(t).dtype)

            loop_vars = tuple(
                zero_like(tp) if isinstance(v, _Undefined) else v
                for v, tp in zip(loop_vars, template))
        out = while_loop(cond_fn, lambda *vs: tuple(body_fn(*vs)),
                         list(loop_vars))
        return tuple(out)
    vars_ = tuple(loop_vars)
    cur = first
    while _truth(cur):
        vars_ = tuple(body_fn(*vars_))
        cur = cond_fn(*vars_)
    return vars_


def convert_logical_and(lhs, rhs_fn: Callable):
    """``a and b`` — short-circuits for python values and eager tensors,
    elementwise ``&`` for recorded tensors (logical_transformer.py)."""
    if _is_dynamic(lhs):
        return lhs & rhs_fn()
    if isinstance(lhs, torch.Tensor):
        return rhs_fn() if _truth(lhs) else lhs
    return lhs and rhs_fn()


def convert_logical_or(lhs, rhs_fn: Callable):
    if _is_dynamic(lhs):
        return lhs | rhs_fn()
    if isinstance(lhs, torch.Tensor):
        return lhs if _truth(lhs) else rhs_fn()
    return lhs or rhs_fn()


def convert_range_check(i, stop, step):
    """Loop-continue test for a converted ``for _ in range(...)`` —
    sign-aware so negative steps work, tensor-safe so it records. A
    concrete zero step raises like python's range()."""
    if not isinstance(step, torch.Tensor) and step == 0:
        raise ValueError("range() arg 3 must not be zero")
    if isinstance(step, torch.Tensor) or _is_dynamic(i) or _is_dynamic(stop):
        iv, sv, st = (torch.as_tensor(v) for v in (i, stop, step))
        return ((st > 0) & (iv < sv)) | ((st < 0) & (iv > sv))
    return (step > 0 and i < stop) or (step < 0 and i > stop)


def convert_logical_not(x):
    if isinstance(x, torch.Tensor):
        return torch.logical_not(x)
    return not x


def convert_bool(x):
    """bool(x) in a converted test position."""
    if _is_dynamic(x):
        return x
    if isinstance(x, torch.Tensor):
        return _truth(x)
    return x


# ---------------------------------------------------------------------------
# AST analysis
# ---------------------------------------------------------------------------
import re as _re

_GENERATED_NAME = _re.compile(
    r"^__(true_fn|false_fn|loop_cond|loop_body|range_it|range_stop|"
    r"range_step)_\d+$")


def _is_generated_name(name: str) -> bool:
    return bool(_GENERATED_NAME.match(name))


def _assigned_names(nodes: List[ast.stmt]) -> List[str]:
    out: List[str] = []

    class V(ast.NodeVisitor):
        def visit_Assign(self, n):
            for t in n.targets:
                self._target(t)
            self.generic_visit(n)

        def visit_AugAssign(self, n):
            self._target(n.target)
            self.generic_visit(n)

        def visit_AnnAssign(self, n):
            if n.value is not None:
                self._target(n.target)
            self.generic_visit(n)

        def visit_For(self, n):
            self._target(n.target)
            self.generic_visit(n)

        def _target(self, t):
            if isinstance(t, ast.Name):
                if t.id not in out and not _is_generated_name(t.id):
                    out.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._target(e)

        # do not descend into nested function defs; record USER def names
        # (they thread through branches eagerly like any assignment) but
        # never the converter's own generated helpers (__true_fn_N, …) —
        # those leaking into loop/branch vars breaks staging
        def visit_FunctionDef(self, n):
            if not _is_generated_name(n.name) and n.name not in out:
                out.append(n.name)

        visit_AsyncFunctionDef = visit_FunctionDef

    v = V()
    for n in nodes:
        v.visit(n)
    return out


def _read_value_names(node) -> set:
    """Names read as VALUES — excluding names whose only appearance is as
    the callee base of a Call (``paddle`` in ``paddle.sum(x)``): those are
    module/function bindings, and threading them through a
    recorded loop's carry would make a module a loop variable."""
    callee_bases = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            while isinstance(f, ast.Attribute):
                f = f.value
            if isinstance(f, ast.Name):
                callee_bases.add(id(f))
    names = set()
    for n in ast.walk(node):
        if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and id(n) not in callee_bases):
            names.add(n.id)
    return names


def _has_scope_decl(nodes: List[ast.stmt]) -> bool:
    """global/nonlocal in the block: declared names cannot also be branch-fn
    parameters, so such blocks keep their python form."""
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, (ast.Global, ast.Nonlocal)):
                return True
    return False


def _has_escape(nodes: List[ast.stmt]) -> bool:
    """return/break/continue/yield at this block's level (not in nested defs
    or nested loops for break/continue)."""

    class V(ast.NodeVisitor):
        found = False
        loop_depth = 0

        def visit_Return(self, n):
            self.found = True

        def visit_Yield(self, n):
            self.found = True

        def visit_YieldFrom(self, n):
            self.found = True

        def visit_Break(self, n):
            if self.loop_depth == 0:
                self.found = True

        visit_Continue = visit_Break

        def visit_While(self, n):
            self.loop_depth += 1
            self.generic_visit(n)
            self.loop_depth -= 1

        visit_For = visit_While

        def visit_FunctionDef(self, n):
            pass  # don't descend

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    v = V()
    for n in nodes:
        v.visit(n)
    return v.found


_HELPER = "_jst"


# ---------------------------------------------------------------------------
# escape rewriting (reference: return_transformer.py,
# break_continue_transformer.py)
# ---------------------------------------------------------------------------
def _has_return(nodes) -> bool:
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, n):
            self.found = True

        def visit_FunctionDef(self, n):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    v = V()
    for n in nodes:
        v.visit(n)
    return v.found


def _return_inside_loop(nodes) -> bool:
    """A Return whose nearest enclosing loop within this subtree is a loop
    (we cannot elseify those)."""
    class V(ast.NodeVisitor):
        found = False
        depth = 0

        def visit_Return(self, n):
            if self.depth > 0:
                self.found = True

        def visit_While(self, n):
            self.depth += 1
            self.generic_visit(n)
            self.depth -= 1

        visit_For = visit_While

        def visit_FunctionDef(self, n):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    v = V()
    for n in nodes:
        v.visit(n)
    return v.found


def _has_loop_escape(nodes, kinds) -> bool:
    """break/continue at THIS loop's level (not inside nested loops/defs)."""
    class V(ast.NodeVisitor):
        found = False

        def generic_visit(self, n):
            if isinstance(n, kinds):
                self.found = True
            if not isinstance(n, (ast.While, ast.For, ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                super().generic_visit(n)

    v = V()
    for n in nodes:
        v.visit(n)
    return v.found


def _assign(name, value_node):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=value_node)


class _EscapeRewriter(ast.NodeTransformer):
    """Rewrites ``return``/``break``/``continue`` inside convertible control
    flow into value/flag threading, so the staging transformers see
    escape-free blocks (the reference's return_transformer.py and
    break_continue_transformer.py).

    - ``return`` inside ``if``: the function is ELSE-IFIED — the statements
      after an early-return guard move into its other branch, so every path
      ends assigning one return slot and falls to a single tail ``return``.
      Exact python semantics (including types) and, recorded, both
      branches of the composite ``cond`` produce the path's own value. Returns inside
      loops keep python form (as in eager).
    - ``break``/``continue``: lowered to boolean flags — the loop test
      gains ``not <brk>``, the statements following the escape are guarded
      by ``if not <flag>:``, and the flags thread through the loop carry.
    """

    _n = 0

    @classmethod
    def _name(cls, base):
        _EscapeRewriter._n += 1
        return f"__dy2s_{base}{cls._n}"

    # -- return elseification ----------------------------------------------
    def visit_FunctionDef(self, node):
        self.generic_visit(node)  # nested defs / loops first
        if not _needs_elseify(node.body) or _return_inside_loop(node.body):
            return node
        ret = self._name("ret")
        ok, new_body = _elseify(list(node.body), ret)
        if not ok:
            return node
        node.body = new_body + [ast.Return(value=ast.Name(id=ret,
                                                          ctx=ast.Load()))]
        ast.fix_missing_locations(node)
        return node

    # -- break/continue flags ----------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        return self._rewrite_loop(node)

    def visit_For(self, node):
        self.generic_visit(node)
        return self._rewrite_loop(node)

    def _rewrite_loop(self, node):
        has_b = _has_loop_escape(node.body, ast.Break)
        has_c = _has_loop_escape(node.body, ast.Continue)
        if not (has_b or has_c):
            return node
        if node.orelse or _has_return(node.body):
            return node  # loop-else interplay / returns: keep python form
        if isinstance(node, ast.For):
            # only range() for-loops lower to convert_while and consume the
            # break flag; other iterables keep python form — rewriting their
            # break would silently disable it
            it = node.iter
            if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                    and it.func.id == "range" and not it.keywords
                    and 1 <= len(it.args) <= 3
                    and isinstance(node.target, ast.Name)):
                return node
        flags = []
        pre = []
        brk = cont = None
        if has_b:
            brk = self._name("brk")
            flags.append(brk)
            pre.append(_assign(brk, ast.Constant(value=False)))
        if has_c:
            cont = self._name("cont")
            flags.append(cont)
        body, _ = _rewrite_escapes(list(node.body), brk, cont, flags)
        if has_c:
            body = [_assign(cont, ast.Constant(value=False))] + body
        node.body = body
        if has_b:
            if isinstance(node, ast.While):
                node.test = ast.BoolOp(
                    op=ast.And(),
                    values=[ast.UnaryOp(op=ast.Not(),
                                        operand=ast.Name(id=brk,
                                                         ctx=ast.Load())),
                            node.test])
            else:
                node._dy2s_brk = brk  # for-range lowering ANDs it in
        ast.fix_missing_locations(node)
        if pre:
            for p in pre:
                ast.copy_location(p, node)
                ast.fix_missing_locations(p)
            return pre + [node]
        return node


_ELSEIFY_MAX_DEPTH = 5  # ≤ 2^5 tail copies; deeper keeps python form


def _needs_elseify(stmts) -> bool:
    """A Return that is NOT a top-level statement of the function body."""
    for st in stmts:
        if isinstance(st, ast.Return):
            continue
        if _has_return([st]):
            return True
    return False


def _elseify(stmts, ret, depth=0):
    """Rewrite so every path ends with ``<ret> = value``; returns (ok, new).
    Statements after a return-containing ``if`` are duplicated into the
    branch continuations (each staged branch then yields its own path's
    value — the only structure a recorded cond can type; a single return-done
    flag, the reference's approach, cannot type the first guard's branches
    when the early value and the unset slot differ). Duplication doubles
    per sequential guard, so conversion bails past ``_ELSEIFY_MAX_DEPTH``
    guards (the function keeps python form, as before)."""
    import copy

    if depth > _ELSEIFY_MAX_DEPTH:
        return False, stmts
    out = []
    for i, st in enumerate(stmts):
        if isinstance(st, ast.Return):
            out.append(_assign(ret, st.value if st.value is not None
                               else ast.Constant(value=None)))
            return True, out  # rest unreachable
        if isinstance(st, ast.If) and (_has_return(st.body)
                                       or _has_return(st.orelse)):
            if _return_inside_loop(st.body) or _return_inside_loop(st.orelse):
                return False, stmts
            cont = stmts[i + 1:]
            okb, nb = _elseify(list(st.body) + copy.deepcopy(cont), ret,
                               depth + 1)
            oke, ne = _elseify(list(st.orelse) + cont, ret, depth + 1)
            if not (okb and oke):
                return False, stmts
            new_if = ast.If(test=st.test, body=nb, orelse=ne)
            ast.copy_location(new_if, st)
            out.append(new_if)
            return True, out
        out.append(st)
    out.append(_assign(ret, ast.Constant(value=None)))
    return True, out


def _rewrite_escapes(stmts, brk, cont, flags):
    """Replace break/continue with flag sets; guard the statements that
    follow a potentially-escaping statement with ``if not <flags>:``.
    Returns (new_stmts, may_escape). Does not descend into nested loops or
    function defs (their escapes are their own)."""
    out = []
    for i, st in enumerate(stmts):
        if isinstance(st, ast.Break):
            out.append(_assign(brk, ast.Constant(value=True)))
            return out, True
        if isinstance(st, ast.Continue):
            out.append(_assign(cont, ast.Constant(value=True)))
            return out, True
        if isinstance(st, ast.If):
            nb, sb = _rewrite_escapes(list(st.body), brk, cont, flags)
            ne, se = _rewrite_escapes(list(st.orelse), brk, cont, flags)
            new_if = ast.If(test=st.test, body=nb or [ast.Pass()], orelse=ne)
            ast.copy_location(new_if, st)
            out.append(new_if)
            if sb or se:
                rest, _ = _rewrite_escapes(stmts[i + 1:], brk, cont, flags)
                if rest:
                    test = None
                    for f in flags:
                        notf = ast.UnaryOp(op=ast.Not(),
                                           operand=ast.Name(id=f,
                                                            ctx=ast.Load()))
                        test = notf if test is None else ast.BoolOp(
                            op=ast.And(), values=[test, notf])
                    guard = ast.If(test=test, body=rest, orelse=[])
                    ast.copy_location(guard, st)
                    out.append(guard)
                return out, True
            continue
        out.append(st)
    return out, False


def _undef_guards(names: List[str]) -> List[ast.stmt]:
    """Per name: ``try: <name>\nexcept NameError: <name> = _jst.UNDEF`` so a
    converted block can thread names that were unbound before it (the
    reference pre-assigns UndefinedVar the same way)."""
    out = []
    for n in names:
        out.append(ast.Try(
            body=[ast.Expr(value=ast.Name(id=n, ctx=ast.Load()))],
            handlers=[ast.ExceptHandler(
                type=ast.Name(id="NameError", ctx=ast.Load()),
                name=None,
                body=[ast.Assign(
                    targets=[ast.Name(id=n, ctx=ast.Store())],
                    value=ast.Attribute(
                        value=ast.Name(id=_HELPER, ctx=ast.Load()),
                        attr="UNDEF", ctx=ast.Load()))])],
            orelse=[], finalbody=[]))
    return out


class _LoopLowering:
    """Shared while/for lowering: builds the cond_fn/body_fn pair and the
    ``convert_while`` call over a loop-var tuple (one implementation so the
    two visitors cannot drift)."""

    def _lower_loop(self, node, loop_vars, cond_expr, body_stmts,
                    guard_vars=None):
        params = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in loop_vars],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        cond_name = self._name("loop_cond")
        body_name = self._name("loop_body")
        cond_fn = ast.FunctionDef(
            name=cond_name, args=params,
            body=[ast.Return(value=cond_expr)], decorator_list=[])
        body_fn = ast.FunctionDef(
            name=body_name, args=params,
            body=list(body_stmts) + [ast.Return(value=ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Load()) for n in loop_vars],
                ctx=ast.Load()))],
            decorator_list=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in loop_vars],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Attribute(value=ast.Name(id=_HELPER, ctx=ast.Load()),
                                   attr="convert_while", ctx=ast.Load()),
                args=[ast.Name(id=cond_name, ctx=ast.Load()),
                      ast.Name(id=body_name, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                      for n in loop_vars], ctx=ast.Load())],
                keywords=[]))
        out = _undef_guards(guard_vars if guard_vars is not None
                            else loop_vars) + [cond_fn, body_fn, call]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out


class _ForRangeTransformer(_LoopLowering):
    """Mixin for visit_For: ``for i in range(...)`` lowers to the while
    conversion (loop_transformer.py's for_range path); other iterables keep
    python form (they are host-side by construction).

    Design: a PRIVATE counter drives the iteration and assigns the user's
    loop variable at the top of each body — so body code reassigning ``i``
    cannot derail the iteration (python range semantics), and after the loop
    ``i`` holds the last yielded value, not last+step."""

    def visit_For(self, node):
        self.generic_visit(node)
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords
                and 1 <= len(it.args) <= 3
                and isinstance(node.target, ast.Name)):
            return node
        if _has_escape(node.body) or node.orelse or _has_scope_decl(node.body):
            return node
        args = it.args
        start = args[0] if len(args) >= 2 else ast.Constant(value=0)
        stop = args[0] if len(args) == 1 else args[1]
        step = args[2] if len(args) == 3 else ast.Constant(value=1)
        ivar = node.target.id
        counter = self._name("range_it")
        stop_name = self._name("range_stop")
        step_name = self._name("range_step")

        def name_l(n):
            return ast.Name(id=n, ctx=ast.Load())

        def assign(n, value):
            return ast.Assign(targets=[ast.Name(id=n, ctx=ast.Store())],
                              value=value)

        pre = [
            assign(stop_name, stop),
            assign(step_name, step),
            assign(counter, start),
        ]
        # the user var is NOT pre-assigned: python's zero-trip range leaves
        # a prior binding untouched (and an unbound name unbound) — the
        # UNDEF guard + convert_while's typed-zeros staging handle both
        body_assigned = [n for n in _assigned_names(node.body) if n != ivar]
        loop_vars = [counter, ivar] + body_assigned
        cond_expr = ast.Call(
            func=ast.Attribute(value=ast.Name(id=_HELPER, ctx=ast.Load()),
                               attr="convert_range_check", ctx=ast.Load()),
            args=[name_l(counter), name_l(stop_name), name_l(step_name)],
            keywords=[])
        brk = getattr(node, "_dy2s_brk", None)
        if brk is not None:
            # break-rewritten body (escape rewriter): stop iterating once
            # the flag is set — convert_logical_and stages over tensors
            cond_expr = ast.Call(
                func=ast.Attribute(value=ast.Name(id=_HELPER, ctx=ast.Load()),
                                   attr="convert_logical_and",
                                   ctx=ast.Load()),
                args=[ast.Call(
                    func=ast.Attribute(
                        value=ast.Name(id=_HELPER, ctx=ast.Load()),
                        attr="convert_logical_not", ctx=ast.Load()),
                    args=[name_l(brk)], keywords=[]),
                    ast.Lambda(
                        args=ast.arguments(posonlyargs=[], args=[],
                                           kwonlyargs=[], kw_defaults=[],
                                           defaults=[]),
                        body=cond_expr)],
                keywords=[])
            if brk not in loop_vars:
                loop_vars.append(brk)
        body_stmts = (
            [assign(ivar, name_l(counter))] + list(node.body) +
            [assign(counter, ast.BinOp(left=name_l(counter), op=ast.Add(),
                                       right=name_l(step_name)))]
        )
        lowered = self._lower_loop(node, loop_vars, cond_expr, body_stmts,
                                   guard_vars=[ivar] + body_assigned)
        for n in pre:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return pre + lowered



class _Dy2StaticTransformer(_ForRangeTransformer, ast.NodeTransformer):
    """Rewrites if/while/boolop into _jst.convert_* calls."""

    def __init__(self):
        self.counter = 0

    def _name(self, tag):
        self.counter += 1
        return f"__{tag}_{self.counter}"

    # -- boolean operators --------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = ("convert_logical_and" if isinstance(node.op, ast.And)
              else "convert_logical_or")
        expr = node.values[-1]
        for lhs in reversed(node.values[:-1]):
            expr = ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id=_HELPER, ctx=ast.Load()),
                    attr=fn, ctx=ast.Load()),
                args=[lhs,
                      ast.Lambda(
                          args=ast.arguments(posonlyargs=[], args=[],
                                             kwonlyargs=[], kw_defaults=[],
                                             defaults=[]),
                          body=expr)],
                keywords=[])
        return ast.copy_location(expr, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.copy_location(
                ast.Call(
                    func=ast.Attribute(
                        value=ast.Name(id=_HELPER, ctx=ast.Load()),
                        attr="convert_logical_not", ctx=ast.Load()),
                    args=[node.operand], keywords=[]),
                node)
        return node

    # -- if -----------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if (_has_escape(node.body) or _has_escape(node.orelse)
                or _has_scope_decl(node.body + node.orelse)):
            return node  # python semantics preserved (partial support)
        assigned = _assigned_names(node.body + node.orelse)
        if not assigned:
            # branches are pure side-effect python (e.g. appends): keep as-is
            return node

        true_name = self._name("true_fn")
        false_name = self._name("false_fn")
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in assigned],
            ctx=ast.Load()))
        # the assigned names are branch-fn PARAMETERS (reads see the outer
        # value, writes stay branch-local) — the reference's true_fn/false_fn
        # argument threading, ifelse_transformer.py
        params = ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=n) for n in assigned],
            kwonlyargs=[], kw_defaults=[], defaults=[])

        def mk_fn(name, body):
            body = list(body) if body else [ast.Pass()]
            return ast.FunctionDef(name=name, args=params,
                                   body=body + [ret], decorator_list=[])

        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in assigned],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Attribute(value=ast.Name(id=_HELPER, ctx=ast.Load()),
                                   attr="convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=true_name, ctx=ast.Load()),
                      ast.Name(id=false_name, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                      for n in assigned], ctx=ast.Load())],
                keywords=[]))
        out = _undef_guards(assigned) + [
            mk_fn(true_name, node.body), mk_fn(false_name, node.orelse), call]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out

    # -- while --------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if _has_escape(node.body) or node.orelse or _has_scope_decl(node.body):
            return node
        assigned = _assigned_names(node.body)
        loop_vars = [n for n in assigned] + [
            n for n in sorted(_read_value_names(node.test))
            if n not in assigned and n != _HELPER
        ]
        if not loop_vars:
            return node
        return self._lower_loop(node, loop_vars, node.test, node.body)


def convert_to_static(fn: Callable) -> Callable:
    """Rewrite ``fn``'s data-dependent control flow; returns the converted
    function (or ``fn`` unchanged when its source is unavailable — builtins,
    C extensions, REPL lambdas)."""
    if getattr(fn, "_not_to_static", False):
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return fn
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    fdef.decorator_list = []  # strip @to_static etc. — we call the raw result
    tree = _EscapeRewriter().visit(tree)
    ast.fix_missing_locations(tree)
    new_tree = _Dy2StaticTransformer().visit(tree)
    ast.fix_missing_locations(new_tree)
    try:
        code = compile(new_tree, filename=f"<dy2static {fn.__qualname__}>",
                       mode="exec")
    except SyntaxError:
        return fn  # converted form invalid for this function: keep python
    from . import dy2static as _self

    import types

    glob = dict(fn.__globals__)
    glob[_HELPER] = _self
    if fn.__closure__:
        # Rebuild inside a wrapper that redeclares the free variables, then
        # swap in the ORIGINAL cells so later nonlocal mutation stays visible
        # (copying cell contents would freeze them at conversion time).
        freevars = fn.__code__.co_freevars
        wrapper_src = "def __outer__({}):\n".format(", ".join(freevars))
        wrapper_src += textwrap.indent(ast.unparse(new_tree.body[0]), "    ")
        wrapper_src += f"\n    return {fdef.name}"
        wglob = dict(glob)
        try:
            exec(compile(wrapper_src, f"<dy2static {fn.__qualname__}>",
                         "exec"), wglob)
        except SyntaxError:
            return fn
        snapshot = wglob["__outer__"](
            *[c.cell_contents for c in fn.__closure__])
        cellmap = dict(zip(freevars, fn.__closure__))
        try:
            live_cells = tuple(cellmap[n]
                               for n in snapshot.__code__.co_freevars)
            converted = types.FunctionType(
                snapshot.__code__, glob, fn.__name__, fn.__defaults__,
                live_cells)
        except KeyError:
            converted = snapshot  # new freevar we can't map: snapshot mode
    else:
        exec(code, glob)
        converted = glob[fdef.name]
    converted = functools.wraps(fn)(converted)
    converted._dy2static_converted = True
    return converted
