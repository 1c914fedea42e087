"""Control flow of the port (paddle_tpu_torch.static: cond, case,
switch_case, while_loop, increment and the tensor arrays) against the
reference's, on the CPU: the cases of tests/test_control_flow.py, each
run eagerly in both packages, and recorded into a Program and run by both
Executors (the reference's jax-traced cases map to the recorded ones; the
port has no tracer). Recorded composites read their predicate on the host
at each run (the counter ``static/pred_host_reads``). Values are exact, except the
trained fc program's losses (f32, 1e-5 relative)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import static
from paddle_tpu_torch.nn.param_attr import ParamAttr
from paddle_tpu_torch.profiler.telemetry import get_telemetry

CPU = "cpu"
T = torch.tensor
J = paddle.to_tensor


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


def _jrun(build, feeds, n_out=1):
    """Record ``build(pkg)`` in the reference and run it on each feed."""
    prog = jstatic.Program()
    with jstatic.program_guard(prog, jstatic.Program()):
        outs = build(paddle, jstatic, lambda n, s, d: jstatic.data(n, s, d))
    exe = jstatic.Executor()
    return [exe.run(prog, feed=f, fetch_list=list(outs)) for f in feeds]


def _trun(build, feeds):
    prog = static.Program()
    with static.program_guard(prog, static.Program()):
        outs = build(torch, static,
                     lambda n, s, d: static.data(n, s, d, device=CPU))
    exe = static.Executor(static.CPUPlace())
    return [exe.run(prog, feed=f, fetch_list=list(outs)) for f in feeds]


def _both(build, feeds):
    got, want = _trun(build, feeds), _jrun(build, feeds)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got


# -- eager ---------------------------------------------------------------------
@pytest.mark.parametrize("x, want", [([3.0], [6.0]), ([1.0], [0.0])])
def test_cond_eager(x, want):
    out = static.cond(T(x).sum() > 2.0, lambda: T(x) * 2, lambda: T(x) - 1)
    jx = J(x)
    jout = jstatic.cond(jx.sum() > 2.0, lambda: jx * 2, lambda: jx - 1)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(jout.numpy(), want)


def test_cond_eager_grad_through_taken_branch():
    x = T([3.0], requires_grad=True)
    static.cond(T(True), lambda: x * x, lambda: x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_cond_nested_structures():
    x = T([2.0])
    out = static.cond(T(True), lambda: (x + 1, x + 2), lambda: (x - 1, x - 2))
    assert [float(o) for o in out] == [3.0, 4.0]


@pytest.mark.parametrize("v, default, want", [
    (0.3, True, 2.0), (0.9, True, 3.0), (0.9, False, 2.0)])
def test_case_eager(v, default, want):
    for pkg, mk in ((static, T), (jstatic, J)):
        x = mk(v)
        pairs = [(x < 0.1, lambda: mk(1.0)), (x < 0.5, lambda: mk(2.0))]
        out = pkg.case(pairs, default=(lambda: mk(3.0)) if default else None)
        assert float(out.numpy()) == want


@pytest.mark.parametrize("index, fns, default, want", [
    (2, "dict", True, 20.0), (7, "dict_one", True, -1.0),
    (1, "list", False, 1.0)])
def test_switch_case_eager(index, fns, default, want):
    for pkg, mk in ((static, T), (jstatic, J)):
        branches = {"dict": {1: lambda: mk(10.0), 2: lambda: mk(20.0)},
                    "dict_one": {1: lambda: mk(10.0)},
                    "list": [lambda: mk(0.0), lambda: mk(1.0)]}[fns]
        out = pkg.switch_case(mk(index), branches,
                              default=(lambda: mk(-1.0)) if default else None)
        assert float(out.numpy()) == want


def test_while_loop_eager_counts_and_multi_var():
    i, s = static.while_loop(lambda i, s: i < 5,
                             lambda i, s: (i + 1, s + 2.0), [T(0), T(0.0)])
    assert (int(i), float(s)) == (5, 10.0)
    i, x = static.while_loop(lambda i, x: i < 4, lambda i, x: (i + 1, x + 1.0),
                             [T(0), torch.ones(2, 2)])
    np.testing.assert_array_equal(x.numpy(), np.full((2, 2), 5.0))
    ji, js = jstatic.while_loop(lambda i, s: i < 5,
                                lambda i, s: (i + 1, s + 2.0), [J(0), J(0.0)])
    assert (int(ji.numpy()), float(js.numpy())) == (5, 10.0)


def test_while_loop_eager_autograd_through_every_iteration():
    x = T(2.0, requires_grad=True)
    _, acc = static.while_loop(lambda i, a: i < 3, lambda i, a: (i + 1, a * x),
                               [T(0), x * 1.0])
    acc.backward()  # acc = x^4
    np.testing.assert_allclose(x.grad.numpy(), 32.0, rtol=1e-6)


def test_tensor_array_and_increment_eager():
    for pkg, mk in ((static, T), (jstatic, J)):
        arr = pkg.create_array("float32")
        x = mk([1.0])
        pkg.array_write(x, 0, arr)
        pkg.array_write(x * 2, 1, arr)
        assert int(pkg.array_length(arr).numpy()) == 2
        np.testing.assert_array_equal(pkg.array_read(arr, 1).numpy(), [2.0])
        y = mk(1.0)
        pkg.increment(y, 2.0)
        assert float(y.numpy()) == 3.0


# -- recorded into a Program ---------------------------------------------------
def test_cond_replays_on_fed_value():
    def build(pkg, st, data):
        x = data("x", [1], "float32")
        return [st.cond(x.sum() > 2.0, lambda: x * 2, lambda: x - 1)]

    tel = get_telemetry()
    reads = tel.counter_value("static/pred_host_reads")
    got = _both(build, [{"x": np.asarray([3.0], np.float32)},
                        {"x": np.asarray([1.0], np.float32)}])
    assert [g[0].item() for g in got] == [6.0, 0.0]
    assert tel.counter_value("static/pred_host_reads") - reads == 2


def test_while_loop_replays_on_fed_value():
    def build(pkg, st, data):
        n = data("n", [], "int64")
        mk = pkg.tensor if pkg is torch else pkg.to_tensor
        i, s = st.while_loop(lambda i, s: i < n, lambda i, s: (i + 1, s + i),
                             [mk(0), mk(0)])
        return [s]

    got = _both(build, [{"n": np.asarray(5, np.int64)},
                        {"n": np.asarray(3, np.int64)}])
    assert [int(g[0]) for g in got] == [10, 3]


def test_switch_case_replays_on_fed_value():
    def build(pkg, st, data):
        idx = data("idx", [], "int64")
        mk = pkg.tensor if pkg is torch else pkg.to_tensor
        return [st.switch_case(idx, {0: lambda: mk(5.0) * 1,
                                     2: lambda: mk(7.0) * 1},
                               default=lambda: mk(-1.0) * 1)]

    got = _both(build, [{"idx": np.asarray(2, np.int64)},
                        {"idx": np.asarray(9, np.int64)},
                        {"idx": np.asarray(0, np.int64)}])
    assert [g[0].item() for g in got] == [7.0, -1.0, 5.0]


def test_cond_passthrough_branch():
    def build(pkg, st, data):
        x = data("x", [1], "float32")
        y = x * 2
        return [st.cond(x.sum() > 2.0, lambda: x, lambda: y)]

    got = _both(build, [{"x": np.asarray([3.0], np.float32)},
                        {"x": np.asarray([1.0], np.float32)}])
    assert [g[0].item() for g in got] == [3.0, 2.0]


def test_while_passthrough_external_in_body():
    def build(pkg, st, data):
        n = data("n", [], "int64")
        mk = pkg.tensor if pkg is torch else pkg.to_tensor
        c = mk(2)
        (i,) = st.while_loop(lambda i: i < n, lambda i: [i + c], [mk(0)])
        return [i]

    assert int(_both(build, [{"n": np.asarray(5, np.int64)}])[0][0]) == 6


def test_increment_is_inplace_in_program():
    def build(pkg, st, data):
        x = data("x", [1], "float32")
        return [st.increment(x, 1.0) * 2]

    got = _both(build, [{"x": np.asarray([3.0], np.float32)}])
    assert got[0][0].item() == 8.0


def test_increment_inside_static_while_body():
    def build(pkg, st, data):
        n = data("n", [], "int64")
        mk = pkg.tensor if pkg is torch else pkg.to_tensor

        def body(i, s):
            i = st.increment(i, 1)
            return [i, s + i]

        return st.while_loop(lambda i, s: i < n, body, [mk(0), mk(0)])

    got = _both(build, [{"n": np.asarray(3, np.int64)}])
    assert [int(v) for v in got[0]] == [3, 6]


def test_predicate_true_on_placeholder_does_not_spin():
    def build(pkg, st, data):
        x, d, lim = (data(n, [], "float32") for n in ("x", "d", "lim"))
        (x,) = st.while_loop(lambda x: x >= lim, lambda x: [x - d], [x])
        return [x]

    got = _both(build, [{"x": np.asarray(5.0, np.float32),
                         "d": np.asarray(2.0, np.float32),
                         "lim": np.asarray(0.0, np.float32)}])
    assert got[0][0].item() == -1.0


def test_cond_with_parameters_and_grad():
    """minimize differentiates through the branch each run takes; the
    reference's weights carried by name."""
    xv = np.abs(np.random.RandomState(0).randn(4, 2)).astype(np.float32)
    paddle.seed(0)
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog, jstatic.Program()):
        x = jstatic.data("x", [4, 2], "float32")
        h = jstatic.nn.fc(x, 3, weight_attr=paddle.ParamAttr(name="w"),
                          bias_attr=paddle.ParamAttr(name="b"))
        jloss = jstatic.cond(x.sum() > 0, lambda: (h * h).mean(),
                             lambda: h.mean())
        paddle.optimizer.SGD(learning_rate=0.1).minimize(jloss)
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [4, 2], "float32", device=CPU)
        h = static.nn.fc(x, 3, weight_attr=ParamAttr(name="w"),
                         bias_attr=ParamAttr(name="b"))
        loss = static.cond(x.sum() > 0, lambda: (h * h).mean(),
                           lambda: h.mean())
        toptim.SGD(learning_rate=0.1).minimize(loss)
    static.set_program_state(prog, {p.name: np.asarray(p._value)
                                    for p in jprog.all_parameters()})
    exe, jexe = static.Executor(static.CPUPlace()), jstatic.Executor()
    losses = []
    for feed in [xv, -xv] * 3:
        tl = exe.run(prog, feed={"x": feed}, fetch_list=[loss])[0]
        jl = jexe.run(jprog, feed={"x": feed}, fetch_list=[jloss])[0]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        losses.append(float(tl))
    assert losses[4] < losses[0]
    assert len(prog.all_parameters()) == 2
