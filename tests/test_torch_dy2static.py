"""The dygraph-to-static converter of the port (paddle_tpu_torch.jit.
dy2static, through ``jit.to_static`` / ``convert_to_static``) against the
reference's, on the CPU: each conversion of tests/test_dy2static.py run
through both packages' converters, eagerly (Python semantics, and the
same values as the unconverted function) and, where the reference stages
it under jax.jit, recorded inside ``program_guard`` and run by both
Executors on fed values (the port has no tracer: recording is where its
control flow stages). Each case is one function written once; ``P`` is
the package's namespace (``P.sum``, ``P.tensor``). Values are exact: the
cases are integer and small float arithmetic."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.jit.dy2static import convert_to_static as jconvert
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import static
from paddle_tpu_torch.jit.dy2static import convert_to_static as tconvert
import torch_threads  # noqa: F401  (one torch thread a worker)


class _Torch:
    sum = staticmethod(torch.sum)
    tensor = staticmethod(torch.tensor)
    static = static
    jit = tjit


class _Ref:
    sum = staticmethod(paddle.sum)
    tensor = staticmethod(paddle.to_tensor)
    static = jstatic
    jit = paddle.jit


@pytest.fixture(autouse=True)
def _reference_heartbeat_kept():
    """The reference's Executor beats its process-wide watchdog, and its
    ops server's /healthz reports a beat older than 60 s as stale: leave
    the last beat as the test found it, for the suites that run after
    this one in the same process."""
    from paddle_tpu.resilience import watchdog as jwatchdog

    saved = jwatchdog._last_beat
    yield
    jwatchdog._last_beat = saved


# -- the converted functions (tests/test_dy2static.py's) ----------------------
def f_if(x, P):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def f_elif(x, P):
    if x.sum() > 10:
        y = x * 10
    elif x.sum() > 0:
        y = x * 2
    else:
        y = x * 0
    return y


def f_augassign(x, P):
    y = x * 1.0
    if x.sum() > 0:
        y += 10.0
    else:
        y -= 10.0
    return y


def f_python_flag(x, P, flag=True):
    if flag:
        return x * 2
    return x


def f_early_return(x, P):
    if P.sum(x) > 0:
        return x * 2.0
    return x - 1.0


def f_code_after_if(x, P):
    if P.sum(x) > 4.0:
        return x * 10.0
    y = x + 1.0
    if P.sum(y) > 3.0:
        return y * 2.0
    return y - 1.0


def f_global_in_branch(x, P):
    if x.sum() > 0:
        global _d2s_counter
        _d2s_counter = 1
        y = x + 1
    else:
        y = x - 1
    return y


def f_and(x, P):
    if x.sum() > 0 and x.max() < 10:
        y = x + 1
    else:
        y = x - 1
    return y


def f_or_not(x, P):
    if not x.sum() > 0 or x.max() > 10:
        y = x + 1
    else:
        y = x - 1
    return y


def f_while(n, P):
    i = P.tensor(0)
    s = P.tensor(0)
    while i < n:
        s = s + i
        i = i + 1
    return s


def f_while_module_call(x, P):
    while P.sum(x) > 0:
        x = x - 1.0
    return x


def f_for_range(n, P):
    s = P.tensor(0)
    for i in range(n):
        s = s + i
    return s


def f_for_start_stop_step(n, P):
    s = P.tensor(0)
    for i in range(1, n, 2):
        s = s + i
    return s


def f_for_negative_step(n, P):
    s = P.tensor(0)
    for i in range(n, 0, -1):
        s = s + i
    return s


def f_for_list(x, P):
    s = x
    for v in [1.0, 2.0]:
        s = s + v
    return s


def f_loop_var_reassigned(n, P):
    s = P.tensor(0)
    for i in range(n):
        i = 0  # noqa: PLW2901 — python range still drives iteration
        s = s + 1
    return s


def f_loop_var_after(n, P):
    s = P.tensor(0)
    for i in range(n):
        s = s + i
    return s + i * 100


def f_nested_if_in_for(n, t, P):
    s = t * 0.0
    for i in range(n):
        if t > 0:
            s = s + 1.0
        else:
            s = s - 1.0
    return s


def f_body_temp(n, P):
    s = P.tensor(0)
    for i in range(n):
        t = i * 2
        s = s + t
    return s


def f_nested_for(n, P):
    s = P.tensor(0)
    for i in range(n):
        for j in range(n):
            s = s + i * j
    return s


def f_user_def_in_branch(t, P):
    if t.sum() > 0:
        y = t + 1

        def h():
            return 10
    else:
        y = t - 1

        def h():
            return 20
    return y + h()


def f_break_in_while(x, P):
    i = 0
    while i < 10:
        x = x + 1.0
        if P.sum(x) > 5.0:
            break
        i = i + 1
    return x


def f_continue_in_for(x, P):
    for i in range(6):
        if i % 2 == 0:
            continue
        x = x + i
    return x


def f_break_in_for(x, P):
    for i in range(100):
        x = x + 1.0
        if P.sum(x) > 6.0:
            break
    return x


def f_break_and_continue(x, P):
    i = 0
    while i < 10:
        i = i + 1
        if i % 2 == 0:
            continue
        if i > 5:
            break
        x = x + i
    return x


def f_return_in_loop(x, P):
    for i in range(3):
        if i == 1:
            return x * 2.0
    return x


def f_break_non_range_for(x, P):
    for item in [1.0, 2.0, 3.0]:
        x = x + item
        if P.sum(x) > 0:
            break
    return x


F32 = np.float32
# name -> (function, eager inputs (arrays become tensors, ints stay Python
# ints), recorded placeholders as (shape, dtype) per tensor input or None)
CASES = {
    "if": (f_if, [[np.array([1.0, 2.0], F32)], [np.array([-1.0, -2.0],
                                                         F32)]],
           [([2], "float32")]),
    "elif": (f_elif, [[np.array([20.0], F32)], [np.array([1.0], F32)],
                      [np.array([-5.0], F32)]], [([1], "float32")]),
    "augassign": (f_augassign, [[np.array([1.0], F32)],
                                [np.array([-1.0], F32)]],
                  [([1], "float32")]),
    "python_flag": (f_python_flag, [[np.array([3.0], F32)]], None),
    "early_return": (f_early_return, [[np.array([1.0, 2.0], F32)],
                                      [np.array([-1.0, -2.0], F32)]],
                     [([2], "float32")]),
    "code_after_if": (f_code_after_if, [[np.array([3.0, 3.0], F32)],
                                        [np.array([1.0, 1.0], F32)],
                                        [np.array([0.0, 0.0], F32)]],
                      [([2], "float32")]),
    "global_in_branch": (f_global_in_branch, [[np.array([1.0], F32)]],
                         None),
    "and": (f_and, [[np.array([1.0], F32)], [np.array([20.0], F32)],
                    [np.array([-1.0], F32)]], [([1], "float32")]),
    "or_not": (f_or_not, [[np.array([1.0], F32)], [np.array([20.0], F32)],
                          [np.array([-1.0], F32)]], [([1], "float32")]),
    "while": (f_while, [[np.array(5)], [np.array(6)]], [([], "int64")]),
    "while_module_call": (f_while_module_call,
                          [[np.array([2.0, 1.0], F32)]], [([2], "float32")]),
    "for_range": (f_for_range, [[np.array(5)], [5]], [([], "int64")]),
    "for_start_stop_step": (f_for_start_stop_step, [[np.array(8)]],
                            [([], "int64")]),
    "for_negative_step": (f_for_negative_step, [[np.array(4)]],
                          [([], "int64")]),
    "for_list": (f_for_list, [[np.array([1.0], F32)]], [([1], "float32")]),
    "loop_var_reassigned": (f_loop_var_reassigned, [[np.array(3)]],
                            [([], "int64")]),
    "loop_var_after": (f_loop_var_after, [[np.array(5)], [5]], None),
    "nested_if_in_for": (f_nested_if_in_for,
                         [[np.array(3), np.array(1.0, F32)],
                          [np.array(3), np.array(-1.0, F32)]],
                         [([], "int64"), ([], "float32")]),
    "body_temp": (f_body_temp, [[np.array(4)]], [([], "int64")]),
    "nested_for": (f_nested_for, [[np.array(3)]], [([], "int64")]),
    "user_def_in_branch": (f_user_def_in_branch,
                           [[np.array([1.0], F32)], [np.array([-1.0], F32)]],
                           None),
    "break_in_while": (f_break_in_while, [[np.array([0.0, 0.0], F32)]],
                       [([2], "float32")]),
    "continue_in_for": (f_continue_in_for, [[np.array([0.0], F32)]], None),
    "break_in_for": (f_break_in_for, [[np.array([0.0, 0.0], F32)]],
                     [([2], "float32")]),
    "break_and_continue": (f_break_and_continue, [[np.array([0.0], F32)]],
                           None),
    "return_in_loop": (f_return_in_loop, [[np.array([1.0], F32)]], None),
    "break_non_range_for": (f_break_non_range_for,
                            [[np.array([-2.5], F32)]], None),
}


def _args(P, inputs):
    return [P.tensor(v) if isinstance(v, np.ndarray) else v for v in inputs]


def _np(out):
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_conversion_eager_matches_python_and_the_reference(name):
    fn, inputs, _ = CASES[name]
    t_conv, j_conv = tconvert(fn), jconvert(fn)
    assert getattr(t_conv, "_dy2static_converted", False) == getattr(
        j_conv, "_dy2static_converted", False)
    for inp in inputs:
        got = _np(t_conv(*_args(_Torch, inp), _Torch))
        np.testing.assert_array_equal(got, _np(fn(*_args(_Torch, inp),
                                                  _Torch)))
        np.testing.assert_array_equal(got, _np(j_conv(*_args(_Ref, inp),
                                                      _Ref)))


RECORDED = sorted(n for n, c in CASES.items() if c[2] is not None)
# recorded cases the reference cannot record: its recorded while_loop
# reads every carry's ``_value`` (a converted for-range's Python int
# counter has none), and its recorded cond hands a branch's unbound-name
# sentinel to lax.cond; the port records them (an int carry becomes a
# tensor, an unbound name zeros) and is held to the Python values. One it
# records with another result: ``range(n, 0, -1)`` over a fed n gives the
# zero-trip value (0 for n = 4, where Python gives 10).
REF_RECORDS_ANOTHER_VALUE = {"for_negative_step"}
REF_CANNOT_RECORD = {
    "body_temp": AttributeError, "break_in_for": AttributeError,
    "break_in_while": AttributeError, "code_after_if": NameError,
    "for_range": AttributeError,
    "for_start_stop_step": AttributeError,
    "loop_var_reassigned": AttributeError, "nested_for": AttributeError,
    "nested_if_in_for": AttributeError}


@pytest.mark.parametrize("name", RECORDED)
def test_conversion_recorded_runs_on_fed_values_as_the_reference(name):
    fn, inputs, placeholders = CASES[name]

    def run(P, convert, executor, data_kw):
        prog = P.static.Program()
        with P.static.program_guard(prog, P.static.Program()):
            xs = [P.static.data(f"a{i}", shape, dtype, **data_kw)
                  for i, (shape, dtype) in enumerate(placeholders)]
            out = convert(fn)(*xs, P)
        exe = executor()
        return [exe.run(prog, feed={f"a{i}": np.asarray(v) for i, v in
                                    enumerate(inp)}, fetch_list=[out])[0]
                for inp in inputs]

    got = run(_Torch, tconvert, lambda: static.Executor(static.CPUPlace()),
              {"device": "cpu"})
    for inp, g in zip(inputs, got):
        np.testing.assert_array_equal(
            g, _np(fn(*_args(_Torch, inp), _Torch)))
    if name in REF_CANNOT_RECORD:
        with pytest.raises(REF_CANNOT_RECORD[name]):
            run(_Ref, jconvert, jstatic.Executor, {})
        return
    want = run(_Ref, jconvert, jstatic.Executor, {})
    for g, w in zip(got, want):
        if name in REF_RECORDS_ANOTHER_VALUE:
            assert not np.array_equal(g, w)
        else:
            np.testing.assert_array_equal(g, w)


def test_unbound_branch_variable_raises_on_use():
    def f(x, P):
        if x.sum() > 0:
            y = x + 1
        else:
            z = x - 1  # noqa: F841
        return y

    g = tconvert(f)
    with pytest.raises(NameError):
        g(torch.tensor([-1.0]), _Torch).numpy()
    np.testing.assert_array_equal(g(torch.tensor([1.0]), _Torch).numpy(),
                                  [2.0])


def test_closure_sees_later_mutation():
    def outer():
        scale = torch.tensor(1.0)

        def f(x):
            if x.sum() > 0:
                y = x * scale
            else:
                y = x
            return y

        def bump():
            nonlocal scale
            scale = torch.tensor(10.0)

        return f, bump

    f, bump = outer()
    g = tconvert(f)
    assert float(g(torch.tensor([2.0]))) == 2.0
    bump()
    assert float(g(torch.tensor([2.0]))) == 20.0


def test_python_bool_shortcircuit_kept_and_step_zero_raises():
    calls = []

    def side():
        calls.append(1)
        return True

    def f(x, flag=False):
        if flag and side():
            y = x * 2
        else:
            y = x
        return y

    tconvert(f)(torch.tensor([1.0]))
    assert calls == []

    def g(n):
        s = torch.tensor(0)
        for i in range(0, n, 0):
            s = s + 1
        return s

    with pytest.raises(ValueError, match="must not be zero"):
        tconvert(g)(torch.tensor(3))


def test_empty_range_keeps_prior_binding():
    def f(x, n):
        i = 100
        for i in range(n):
            x = x + i
        return x + i

    g = tconvert(f)
    assert int(g(torch.tensor(0), 0)) == 100
    assert int(g(torch.tensor(0), 3)) == 0 + 1 + 2 + 2


def test_to_static_decorator_converts_and_records():
    """``@jit.to_static`` on a function: eager values with no gradient;
    inside program_guard the converted control flow records as
    composites."""
    @tjit.to_static
    def f(x):
        while torch.sum(x) > 0:
            x = x - 1.0
        return x

    out = f(torch.tensor([2.0, 1.0], requires_grad=True))
    np.testing.assert_array_equal(out.numpy(), [0.0, -1.0])
    assert not out.requires_grad
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2], device="cpu")
        y = tconvert(f_while_module_call)(x, _Torch)
    # the test's first evaluation (convert_while's) is recorded too and
    # pruned from the replay plan, as in the reference
    assert [op.name for op in prog.ops] == ["sum", "gt", "while"]
    r = static.Executor(static.CPUPlace()).run(
        prog, feed={"x": np.array([3.0, 1.0], F32)}, fetch_list=[y])[0]
    np.testing.assert_array_equal(r, [1.0, -1.0])  # 3,1 -> 2,0 -> 1,-1
