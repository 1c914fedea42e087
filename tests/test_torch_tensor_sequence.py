"""Sequence (LoD) functions on the CPU: ``tensor.sequence_*`` against the
reference's on the same padded batches and lengths (``torch_tensor_cases``'s
sequence group), the reference suite's golden checks on ragged rows, and
``static.nn.sequence_*`` recorded into a Program and run through the
``Executor`` against the reference's static graph (f32: 1e-5)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
import torch_tensor_cases as tc
from paddle_tpu import static as jstatic
from paddle_tpu_torch import static
from paddle_tpu_torch import tensor as T
from torch_tensor_parity import check_case, on_cpu  # noqa: F401
import torch_threads  # noqa: F401  (one torch thread a worker)

CASES = tc.sequence_cases()
CPU = "cpu"


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_function_matches_the_reference(name, on_cpu):  # noqa: F811
    check_case(name, CASES[name])


def _ragged(rng, b=4, tmax=6, tail=()):
    lens = rng.randint(1, tmax + 1, size=b)
    rows = [rng.randn(n, *tail).astype(np.float32) for n in lens]
    padded = np.zeros((b, tmax) + tail, np.float32)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    return rows, padded, lens.astype(np.int64)


@pytest.mark.parametrize("ptype,npfn", [
    ("sum", np.sum), ("average", np.mean),
    ("sqrt", lambda r, axis: r.sum(axis) / np.sqrt(len(r))),
    ("max", np.max), ("min", np.min), ("first", lambda r, axis: r[0]),
    ("last", lambda r, axis: r[-1])])
def test_sequence_pool_golden_over_ragged_rows(ptype, npfn):
    rows, padded, lens = _ragged(np.random.RandomState(0), tail=(3,))
    out = T.sequence_pool(torch.from_numpy(padded), ptype,
                          torch.from_numpy(lens)).numpy()
    want = np.stack([npfn(r, axis=0) for r in rows])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_sequence_round_trips_and_empty_rows(on_cpu):  # noqa: F811
    rows, padded, lens = _ragged(np.random.RandomState(1))
    out, n = T.sequence_pad([torch.from_numpy(r) for r in rows], maxlen=6)
    np.testing.assert_allclose(out.numpy(), padded)
    np.testing.assert_array_equal(n.numpy(), lens)
    for r, back in zip(rows, T.sequence_unpad(out, n)):
        np.testing.assert_allclose(back.numpy(), r)
    # reverse twice is the identity, padding stays in place
    x, n = torch.from_numpy(padded), torch.from_numpy(lens)
    np.testing.assert_allclose(
        T.sequence_reverse(T.sequence_reverse(x, n), n).numpy(), padded)
    # a row of length 0 pools to pad_value, and its softmax is all zeros
    z = torch.ones(2, 3)
    np.testing.assert_allclose(T.sequence_pool(
        z, "max", torch.tensor([0, 2]), pad_value=-7.0).numpy(), [-7.0, 1.0])
    np.testing.assert_allclose(
        T.sequence_softmax(z, torch.tensor([0, 3])).sum(1).numpy(),
        [0.0, 1.0])


def _static_cases():
    """name -> (build(st, data) -> outputs, feeds)."""
    r = np.random.RandomState(0)
    lens = np.array([3, 1, 0, 4], np.int64)
    x = r.randn(4, 5, 2).astype(np.float32)
    cases = {
        "sequence_conv": (lambda st, d: [st.nn.sequence_conv(
            d("x", [None, 5, 2], "float32"), 3, filter_size=3,
            padding_start=-2, act="relu")], {"x": x}),
        "sequence_reshape": (lambda st, d: [st.nn.sequence_reshape(
            d("x", [None, 5, 2], "float32"), 5)], {"x": x}),
        "sequence_scatter": (lambda st, d: [st.nn.sequence_scatter(
            d("x", [None, 5, 2], "float32"), d("i", [None, 2], "int64"),
            d("u", [None, 2, 2], "float32"))],
            {"x": x, "i": np.array([[0, 4], [1, 1], [2, 3], [4, 0]],
                                   np.int64),
             "u": r.randn(4, 2, 2).astype(np.float32)}),
        # no empty row: the reference's f32 program flushes its 1e-38
        # floor to 0 and gives NaN there (the port gives zeros, as
        # test_sequence_round_trips_and_empty_rows holds)
        "sequence_softmax": (lambda st, d: [st.nn.sequence_softmax(
            d("x", [None, 5, 2], "float32"), d("n", [None], "int64"))],
            {"x": x, "n": lens + 1}),
        "sequence_reverse": (lambda st, d: [st.nn.sequence_reverse(
            d("x", [None, 5, 2], "float32"), d("n", [None], "int64"))],
            {"x": x, "n": lens}),
        "sequence_enumerate": (lambda st, d: [st.nn.sequence_enumerate(
            d("x", [None, 5], "float32"), 2, pad_value=0.5,
            lengths=d("n", [None], "int64"))], {"x": x[..., 0], "n": lens}),
        "sequence_first_step": (lambda st, d: [st.nn.sequence_first_step(
            d("x", [None, 5, 2], "float32"), d("n", [None], "int64"))],
            {"x": x, "n": lens}),
        "sequence_last_step": (lambda st, d: [st.nn.sequence_last_step(
            d("x", [None, 5, 2], "float32"), d("n", [None], "int64"))],
            {"x": x, "n": lens}),
    }
    for pt in ("sum", "average", "sqrt", "max", "min"):
        cases["sequence_pool@" + pt] = (
            lambda st, d, pt=pt: [st.nn.sequence_pool(
                d("x", [None, 5, 2], "float32"), pt,
                d("n", [None], "int64"), pad_value=-1.0)],
            {"x": x, "n": lens})
    return cases


@pytest.mark.parametrize("name", sorted(_static_cases()))
def test_static_sequence_function_runs_as_the_reference(name):
    """Recorded in both packages (the reference's parameters carried
    over), replayed by each Executor on a feed other than the record
    time's, twice."""
    build, feed = _static_cases()[name]
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jouts = build(jstatic, jstatic.data)
    main = static.Program()
    with static.program_guard(main):
        outs = build(static, lambda n, s, d: static.data(n, s, d,
                                                         device=CPU))
    with torch.no_grad():
        for tp_, jp in zip(main.all_parameters(), jmain.all_parameters()):
            tp_.copy_(torch.from_numpy(np.array(jp._value)))
    exe, jexe = static.Executor(static.CPUPlace()), jstatic.Executor()
    for scale in (1.0, -2.0):
        fd = {k: v * scale if v.dtype == np.float32 else v
              for k, v in feed.items()}
        got = exe.run(main, feed=fd, fetch_list=outs)
        want = jexe.run(jmain, feed=fd, fetch_list=jouts)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


def test_static_nn_has_every_sequence_function():
    """No static.nn name is refused any more: the reference's sequence_*
    names and every name of its ``__all__`` resolve in the port, and the
    refusal table is gone."""
    from paddle_tpu.static import nn as jnn
    from paddle_tpu_torch.static import nn as snn

    names = [n for n in dir(jnn) if n.startswith("sequence_")]
    assert len(names) == 15
    for n in names + list(jnn.__all__):
        assert callable(getattr(snn, n)), n
    assert not hasattr(snn, "_NOT_PORTED")


def test_every_reference_name_has_a_parity_case():
    """The reference's tensor ``__all__`` lists (the checklist) against
    the port's namespace and the cases: each name is exported, and each
    has a parity case here (or, for ``set_printoptions``, its own test in
    test_torch_core_api.py)."""
    import importlib

    ref = {"Tensor", "to_tensor", "array_length", "array_read",
           "array_write", "create_array"}
    for m in ("attribute", "creation", "linalg", "logic", "manipulation",
              "math", "random", "search", "sequence", "stat", "to_string"):
        ref |= set(importlib.import_module("paddle_tpu.tensor." + m).__all__)
    assert len(ref) == 292
    assert ref <= set(ptt.tensor.__all__)
    assert ref <= set(dir(ptt))
    covered = {tc.base_name(n) for n in tc.all_cases()}
    assert ref - covered == {"set_printoptions"}
    assert paddle is not None
