"""``core/{enforce,dtype,place,rng,monitor,tensor}`` and the top-level
exports of ``paddle_tpu_torch`` against the reference's on the CPU:
the error classes, dtype names and aliases, ``to_tensor``'s dtype rules,
the current device, seeds and random state, the monitor's counters, print
options, and the names the top level exports."""
import importlib
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.core import dtype as jdtype
from paddle_tpu.core import monitor as jmonitor
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core import monitor, place, rng
from torch_tensor_parity import on_cpu  # noqa: F401
import torch_threads  # noqa: F401  (one torch thread a worker)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules themselves: each package's ``core`` star-imports the function
# ``enforce`` over the module's name
jenforce = importlib.import_module("paddle_tpu.core.enforce")
tenforce = importlib.import_module("paddle_tpu_torch.core.enforce")


# -- enforce ------------------------------------------------------------------
def test_error_classes_keep_their_names_and_bases():
    ref = {n: c for n, c in vars(jenforce).items()
           if isinstance(c, type) and issubclass(c, Exception)}
    assert len(ref) == 13
    for name, cls in ref.items():
        port = getattr(tenforce, name)
        assert [b.__name__ for b in port.__mro__] == [
            b.__name__ for b in cls.__mro__]
    with pytest.raises(tenforce.InvalidArgumentError, match="bad"):
        tenforce.enforce(False, "bad")
    with pytest.raises(ValueError, match="expected 1 == 2"):
        tenforce.enforce_eq(1, 2)
    with pytest.raises(tenforce.NotFoundError):
        tenforce.enforce_not_none(None)
    tenforce.enforce_gt(2, 1)
    tenforce.enforce_ge(1, 1)


# -- dtype ----------------------------------------------------------------------
def test_dtype_names_and_aliases_map_as_the_reference_maps_them():
    for name in list(jdtype._NAME_TO_DTYPE) + list(jdtype._ALIASES):
        ref = jdtype.dtype_name(jdtype.convert_dtype(name))
        assert tdtype.dtype_name(name) == ref, name
        assert tdtype.convert_dtype(name) == getattr(torch, ref), name
    assert tdtype.convert_dtype("float8_e4m3fn") == torch.float8_e4m3fn
    assert tdtype.convert_dtype("float8_e5m2") == torch.float8_e5m2
    for spec in (np.float16, np.dtype("int16"), torch.bfloat16, bool,
                 float, int):
        assert tdtype.dtype_name(spec) == jdtype.dtype_name(
            jdtype.convert_dtype(spec) if spec is not torch.bfloat16
            else "bfloat16"), spec
    with pytest.raises(ValueError, match="unknown dtype"):
        tdtype.convert_dtype("float7")
    assert tdtype.convert_dtype(None) is None
    for name in ("float32", "bfloat16", "int8", "bool", "complex64"):
        for fn in ("is_floating_point", "is_integer", "is_complex"):
            assert getattr(tdtype, fn)(name) == bool(
                getattr(jdtype, fn)(name)), (fn, name)


def test_static_program_keeps_its_convert_dtype():
    from paddle_tpu_torch.static.program import convert_dtype

    assert convert_dtype(None) == torch.float32
    assert convert_dtype("fp16") == torch.float16
    assert convert_dtype(np.dtype("int64")) == torch.int64
    with pytest.raises(ValueError):
        convert_dtype("no_such_dtype")


def test_default_dtype_drives_creation(on_cpu):  # noqa: F811
    ptt.set_default_dtype("float64")
    try:
        assert ptt.get_default_dtype() == torch.float64
        assert ptt.ones([1]).dtype == torch.float64
        assert ptt.to_tensor(1.5).dtype == torch.float64
        assert ptt.rand([2]).dtype == torch.float64
    finally:
        ptt.set_default_dtype("float32")
    with pytest.raises(TypeError):
        ptt.set_default_dtype("int32")
    # torch's own default is left as it was
    assert torch.get_default_dtype() == torch.float32


# -- to_tensor and grad mode ------------------------------------------------
def test_to_tensor_follows_the_reference_dtype_rules(on_cpu):  # noqa: F811
    cases = [3, 3.5, True, [1, 2], [1.0, 2], [[1, 2], [3, 4]],
             np.arange(6, dtype=np.float64).reshape(2, 3),
             np.arange(3, dtype=np.int32), np.float32(2.0), 1 + 2j]
    for data in cases:
        ref = paddle.to_tensor(data)
        got = ptt.to_tensor(data)
        assert str(got.dtype).replace("torch.", "") == str(
            np.asarray(ref.numpy()).dtype), data
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert ptt.to_tensor([1, 2], dtype="float16").dtype == torch.float16
    t = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.requires_grad and t.is_leaf
    src = torch.ones(2)
    copy = ptt.to_tensor(src)
    copy.add_(1)
    assert float(src[0]) == 1.0  # a copy, never a view
    assert not ptt.to_tensor([1], stop_gradient=False).requires_grad
    assert ptt.Tensor is torch.Tensor and ptt.VarBase is torch.Tensor
    assert ptt.Parameter is torch.nn.Parameter


def test_tensor_surface_of_the_reference_as_torch_tensors(on_cpu):  # noqa
    """test_tensor_core's tensor cases: shapes, casts, indexing, scalars
    keeping the dtype, clone and detach."""
    t = ptt.ones([2, 3, 4])
    assert list(t.shape) == [2, 3, 4] and t.ndim == 3 and t.numel() == 24
    assert ptt.cast(ptt.ones([2], "float32"), "int32").dtype == torch.int32
    t = ptt.to_tensor(np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(t[1].numpy(), np.arange(4) + 4)
    z = ptt.zeros([3, 3])
    z[1] = 5.0
    assert z.numpy()[1].tolist() == [5.0, 5.0, 5.0]
    assert ptt.add(ptt.ones([2], "float32"), 2).dtype == torch.float32
    assert ptt.multiply(ptt.ones([2], "float32"), 2.5).dtype == torch.float32
    t = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.clone().requires_grad and not t.detach().requires_grad


def test_grad_mode_switches_are_torchs():
    assert ptt.is_grad_enabled()
    with ptt.no_grad():
        assert not ptt.is_grad_enabled()
        with ptt.enable_grad():
            assert torch.is_grad_enabled()
    ptt.set_grad_enabled(False)
    try:
        assert not torch.is_grad_enabled()
    finally:
        ptt.set_grad_enabled(True)


# -- the current device -----------------------------------------------------------
def test_current_device_defaults_to_the_card_and_switches():
    prev = place._current_device
    try:
        place._current_device = "gpu:0"
        assert ptt.get_device() == "gpu:0"
        if not torch.cuda.is_available():
            for make in (lambda: ptt.zeros([2]), lambda: ptt.randn([2]),
                         lambda: ptt.to_tensor([1.0]),
                         lambda: ptt.arange(3)):
                with pytest.raises(RuntimeError, match="CUDA is not "
                                   "available"):
                    make()
            with pytest.raises(RuntimeError, match="CUDA"):
                ptt.set_device("gpu:0")
        assert ptt.set_device("cpu") == "cpu"
        assert ptt.get_device() == "cpu"
        assert ptt.zeros([2]).device.type == "cpu"
        assert ptt.to_tensor([1.0], place=ptt.CPUPlace()).device.type == "cpu"
        assert ptt.to_tensor([1.0], place="cpu").device.type == "cpu"
        with pytest.raises(ValueError, match="runs on no xpu"):
            ptt.to_tensor([1.0], place=ptt.XPUPlace(0))
        with pytest.raises(ValueError, match="runs on no npu"):
            ptt.set_device("npu:0")
    finally:
        place._current_device = prev
    assert ptt.is_compiled_with_cuda()
    assert not ptt.is_compiled_with_npu() and not ptt.is_compiled_with_xpu()
    assert ptt.CUDAPlace(1) == ptt.CUDAPlace(1) != ptt.CUDAPlace(0)
    assert ptt.CUDAPlace(2).get_device_id() == 2
    assert repr(ptt.CUDAPinnedPlace()) == "CUDAPinnedPlace"


# -- random state -------------------------------------------------------------------
def test_seed_gives_the_same_draws_and_state_round_trips(on_cpu):  # noqa
    ptt.seed(7)
    a = [ptt.rand([5]), ptt.randn([5]), ptt.randint(0, 9, [5]),
         ptt.randperm(6), ptt.uniform([3], min=-2.0, max=2.0)]
    ptt.seed(7)
    b = [ptt.rand([5]), ptt.randn([5]), ptt.randint(0, 9, [5]),
         ptt.randperm(6), ptt.uniform([3], min=-2.0, max=2.0)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    state = ptt.get_rng_state()
    first = ptt.randn([4])
    ptt.set_rng_state(state)
    assert torch.equal(ptt.randn([4]), first)
    assert not torch.equal(ptt.randn([4]), first)
    assert ptt.get_cuda_rng_state() == [] or torch.cuda.is_available()
    ptt.set_cuda_rng_state(ptt.get_cuda_rng_state())


def test_uniform_seed_is_per_call(on_cpu):  # noqa: F811
    ptt.seed(1)
    a = ptt.uniform([4], seed=3)
    ptt.seed(2)
    b = ptt.uniform([4], seed=3)
    assert torch.equal(a, b)
    assert not torch.equal(ptt.uniform([4]), ptt.uniform([4]))


def test_seed_also_seeds_the_initializers(on_cpu):  # noqa: F811
    ptt.seed(11)
    w1 = ptt.nn.Linear(4, 3, device="cpu").weight.detach().clone()
    ptt.seed(11)
    w2 = ptt.nn.Linear(4, 3, device="cpu").weight.detach().clone()
    assert torch.equal(w1, w2)


def test_rng_tracker_and_model_parallel_seed(on_cpu):  # noqa: F811
    rng.model_parallel_random_seed(5, mp_rank=1)
    tracker = rng.get_rng_state_tracker()
    assert set(tracker.get_states_tracker()) == {"model_parallel_rng",
                                                 "global_seed"}
    with tracker.rng_state("model_parallel_rng"):
        a = ptt.rand([3])
    rng.model_parallel_random_seed(5, mp_rank=1)
    with tracker.rng_state("model_parallel_rng"):
        b = ptt.rand([3])
    c = ptt.rand([3])
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="already exists"):
        tracker.add("global_seed", 1)
    with pytest.raises(ValueError, match="was not added"):
        with tracker.rng_state("nope"):
            pass
    assert rng.default_generator().initial_seed() == 105


# -- monitor -------------------------------------------------------------------------
def test_monitor_counters_as_the_reference():
    for mod in (jmonitor, monitor):
        mod.stat_reset("t_steps")
        assert mod.stat_get("t_steps") == 0
        mod.stat_add("t_steps", 5)
        mod.stat_add("t_steps")
        assert mod.stat_get("t_steps") == 6
        mod.stat_sub("t_steps", 2)
        assert mod.stat_get("t_steps") == 4
        assert mod.all_stats()["t_steps"] == 4
        mod.stat_reset("t_steps")
        assert mod.stat_get("t_steps") == 0
    monitor.stat_reset("t_conc")

    def bump():
        for _ in range(1000):
            monitor.stat_add("t_conc")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert monitor.stat_get("t_conc") == 8000


def test_telemetry_counters_layer_on_the_monitor():
    from paddle_tpu_torch.profiler.telemetry import get_telemetry

    tel = get_telemetry()
    monitor.stat_reset("t_tel_counter")
    tel.counter("t_tel_counter", 7)
    assert monitor.stat_get("t_tel_counter") == 7
    assert tel.counter_value("t_tel_counter") >= 7


# -- print options -------------------------------------------------------------------
def test_set_printoptions(on_cpu):  # noqa: F811
    from paddle_tpu_torch.tensor import to_string

    assert to_string.get_printoptions()["precision"] == 8
    before = torch._tensor_str.PRINT_OPTS.precision
    try:
        ptt.set_printoptions(precision=2)
        s = repr(ptt.to_tensor(np.array([1.23456789], np.float32)))
        assert "1.23" in s and "1.2345" not in s
        ptt.set_printoptions(precision=8)
        s = repr(ptt.to_tensor(np.array([1.23456789], np.float32)))
        assert "1.2345" in s
    finally:
        torch.set_printoptions(precision=before, sci_mode=None)


def test_inverse_alias_and_in_place_variants(on_cpu):  # noqa: F811
    """test_api_tail's cases: ``inverse``, and each in-place variant
    returns its argument, which every alias sees."""
    m = np.array([[2.0, 1.0], [0.0, 4.0]], np.float32)
    np.testing.assert_allclose(ptt.inverse(ptt.to_tensor(m)).numpy(),
                               np.linalg.inv(m), rtol=1e-5)
    for name, base, args in [
            ("exp_", [0.0, 1.0], ()), ("sqrt_", [4.0, 9.0], ()),
            ("rsqrt_", [4.0, 16.0], ()), ("ceil_", [1.2, -1.2], ()),
            ("floor_", [1.8, -1.2], ()), ("round_", [1.4, 2.6], ()),
            ("reciprocal_", [2.0, 4.0], ()), ("tanh_", [0.0, 1.0], ()),
            ("clip_", [-2.0, 2.0], (-1.0, 1.0)), ("scale_", [1.0, 2.0],
                                                   (3.0,)),
            ("add_", [1.0, 2.0], (ptt.to_tensor([10.0, 20.0]),)),
            ("subtract_", [1.0, 2.0], (ptt.to_tensor([10.0, 20.0]),))]:
        x = ptt.to_tensor(np.asarray(base, np.float32))
        alias = x
        want = getattr(ptt, name[:-1])(ptt.to_tensor(np.asarray(
            base, np.float32)), *args)
        assert getattr(ptt, name)(x, *args) is x, name
        np.testing.assert_allclose(alias.numpy(), want.numpy(), rtol=1e-6)
    x = ptt.zeros([2, 3, 4])
    assert ptt.flatten_(x, 1, 2) is x and list(x.shape) == [2, 12]
    assert list(ptt.reshape_(x, [0, 3, -1]).shape) == [2, 3, 4]
    assert list(ptt.unsqueeze_(x, [0]).shape) == [1, 2, 3, 4]
    assert list(ptt.squeeze_(x).shape) == [2, 3, 4]
    # torch's rule: a leaf that requires grad is not written in place
    with pytest.raises(RuntimeError, match="leaf Variable"):
        ptt.exp_(ptt.to_tensor([1.0], stop_gradient=False))


def test_diag_embed_matches_the_reference():
    """test_api_tail's offsets and axis pairs (f32, exact)."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    for off, d1, d2 in [(0, -2, -1), (-1, 0, 2), (1, 0, 2), (0, 1, 0),
                        (2, -2, -1)]:
        want = JF.diag_embed(paddle.to_tensor(a), offset=off, dim1=d1,
                             dim2=d2).numpy()
        got = TF.diag_embed(torch.from_numpy(a), offset=off, dim1=d1,
                            dim2=d2).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((off, d1, d2)))


def test_reshape_zero_copies_the_dimension(on_cpu):  # noqa: F811
    """Paddle's rule, which the reference's jnp.reshape does not keep: a 0
    in the new shape copies the input's dimension there."""
    x = ptt.zeros([2, 3, 4])
    assert list(ptt.reshape(x, [0, -1]).shape) == [2, 12]
    assert list(ptt.reshape(x, [0, 0, 2, 2]).shape) == [2, 3, 2, 2]


def test_integer_division_and_promotion_rules(on_cpu):  # noqa: F811
    """divide of integers gives the default float dtype (the reference
    gives float64 under its x64 setting: the same values); floor_divide
    and mod floor toward -inf; matmul of mixed dtypes promotes as jnp
    does."""
    a, b = ptt.to_tensor([7, -7, 7, -7]), ptt.to_tensor([2, 2, -2, -2])
    assert ptt.divide(a, b).dtype == torch.float32
    assert str(paddle.divide(paddle.to_tensor([7]), paddle.to_tensor(
        [2])).dtype) == "float64"
    assert ptt.floor_divide(a, b).tolist() == [3, -4, -4, 3]
    assert ptt.mod(a, b).tolist() == [1, 1, -1, -1]
    out = ptt.matmul(ptt.ones([2, 3], "float16"), ptt.ones([3, 2]))
    assert out.dtype == torch.float32


# -- the top level ------------------------------------------------------------------
# the reference's top-level names whose module the port has not ported yet,
# with their ROADMAP item
NOT_EXPORTED = {"DataParallel": "6", "batch": "9", "reader": "9",
                "dataset": "9", "utils": "9", "device": "9", "onnx": "9",
                "sysconfig": "9", "distribution": "9", "analysis": "8"}


def test_top_level_exports_the_references_names():
    # the reference's names as its import makes them, in a fresh process
    # (a test that imports a submodule adds it to the package);
    # ``annotations`` is its ``from __future__`` import
    out = subprocess.run(
        [sys.executable, "-c", "import paddle_tpu; print(' '.join("
         "n for n in dir(paddle_tpu) if not n.startswith('_')))"],
        capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": _REPO, "JAX_PLATFORMS": "cpu"})
    ref = set(out.stdout.split()) - {"annotations"}
    port = set(dir(ptt))
    missing = ref - port
    assert missing == set(NOT_EXPORTED), sorted(missing - set(NOT_EXPORTED))
    for name in ("to_tensor", "seed", "grad", "get_cuda_rng_state",
                 "set_cuda_rng_state", "Layer", "ParamAttr", "VarBase",
                 "in_dygraph_mode", "floor_mod", "crop_tensor",
                 "check_shape", "is_compiled_with_npu", "autograd",
                 "tensor", "nn", "optimizer", "static", "vision", "text",
                 "Model", "summary", "save", "load"):
        assert name in ptt.__all__, name
    assert ptt.Layer is torch.nn.Module
    assert ptt.dtype("float16") == torch.float16
    assert ptt.get_cudnn_version() == torch.backends.cudnn.version()
    assert ptt.check_shape([2, None, -1]) == [2, None, -1]
    with pytest.raises(TypeError):
        ptt.check_shape(None)


def test_import_adds_nothing_to_torch_tensor_and_stays_fast():
    """The reference's method surface is not copied onto torch.Tensor;
    importing the package costs little beyond importing torch (measured
    in a fresh process)."""
    code = textwrap.dedent("""
        import time, torch
        before = set(dir(torch.Tensor))
        t0 = time.perf_counter()
        import paddle_tpu_torch
        took = time.perf_counter() - t0
        assert set(dir(torch.Tensor)) == before
        print(took)
    """)
    env = {**os.environ, "PYTHONPATH": _REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert float(out.stdout.strip()) < 2.0


def test_subpackages_import_without_cycles():
    """Each new module imported first, in a fresh process of its own (the
    processes run side by side)."""
    env = {**os.environ, "PYTHONPATH": _REPO}
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import paddle_tpu_torch.{mod}"], env=env,
                              stderr=subprocess.PIPE)
             for mod in ("tensor", "autograd", "core.rng", "core.dtype",
                         "core.tensor", "core.monitor", "core.enforce",
                         "tensor.sequence")]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    assert importlib.import_module("paddle_tpu_torch.tensor") is ptt.tensor
