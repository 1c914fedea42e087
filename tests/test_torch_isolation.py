"""The port stands alone: importing every module of paddle_tpu_torch
leaves jax and paddle_tpu out of sys.modules and builds no kernel, no
source file imports either, and entry points asked for the default
device on a machine without CUDA raise instead of running on the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import bench
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.inference.serving import (KVCacheConfig, KVCachePool,
                                                TokenServeConfig,
                                                TokenServingEngine)
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.experiments import dkv_packed
from paddle_tpu_torch.text.models import bert as tbert
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "paddle_tpu_torch")


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch."))


def test_package_has_the_slice_modules():
    names = set(_module_names())
    for mod in ("core.place", "profiler.telemetry", "ops._build",
                "ops.fused", "ops.flash_tpu", "ops.attention",
                "text.models.gpt", "jit.functionalize",
                "inference.serving.request", "inference.serving.admission",
                "inference.serving.engine", "inference.serving.kv_cache",
                "inference.serving.decode", "inference.serving.loadgen",
                "nn.functional.loss", "optimizer.optimizer",
                "distributed.fleet.engine", "bench", "text.models.bert",
                "nn.layer.common", "nn.layer.norm",
                "experiments.dkv_packed", "regularizer", "optimizer.lr",
                "nn.clip", "nn.layer.loss", "ops.remat_policy",
                "jit.train_step", "amp.auto_cast",
                "nn.functional.activation", "nn.functional.conv",
                "nn.functional.pooling", "nn.functional.norm",
                "nn.layer.activation", "nn.layer.container",
                "nn.layer.conv", "nn.layer.pooling", "vision.models.lenet",
                "vision.models.resnet", "vision.datasets", "io.dataset",
                "io.sampler", "io.collate", "io.dataloader",
                "metric.metrics", "profiler.spans", "profiler.goodput",
                "resilience.retry", "resilience.preemption",
                "framework.io", "nn.layer_base", "amp.grad_scaler",
                "io.prefetch", "hapi.callbacks", "callbacks", "hapi.model",
                "hapi.summary", "vision.transforms", "vision.models.vgg",
                "vision.models.mobilenet", "core.flags", "core.sanitizer",
                "core.tree", "ops.tree_reduce", "resilience.watchdog",
                "resilience.inject", "resilience.guard",
                "resilience.integrity", "incubate.checkpoint",
                "distributed.communication", "ops.tier_policy",
                "profiler.xla_cost", "core.recording", "static",
                "static.program", "static.executor", "static.control_flow",
                "static.nn", "nn.param_attr", "nn.initializer",
                "jit.dy2static", "inference", "inference._export",
                "inference.serving.scheduler", "quant",
                "core.selected_rows", "nn.functional.common",
                "nn.functional.vision", "nn.layer.rnn",
                "nn.layer.transformer", "nn.layer.decode",
                "nn.layer.distance", "nn.utils", "core.dtype",
                "core.enforce", "core.rng", "core.monitor", "core.tensor",
                "tensor", "tensor.attribute", "tensor.creation",
                "tensor.logic", "tensor.math", "tensor.stat",
                "tensor.manipulation", "tensor.search", "tensor.linalg",
                "tensor.random", "tensor.to_string", "tensor.sequence",
                "autograd", "autograd.functional", "autograd.py_layer"):
        assert "paddle_tpu_torch." + mod in names


def test_importing_every_module_pulls_in_no_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {_REPO!r})
        for name in {_module_names()!r}:
            importlib.import_module(name)
        from paddle_tpu_torch.ops import _build
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "paddle_tpu" or m.startswith("paddle_tpu."))
        print("BAD", bad, "BUILT", _build._lib is not None)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=_REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD [] BUILT False" in out.stdout, out.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(_PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(_REPO, "chip_smoke.py")]))
def test_no_source_imports_jax_or_the_reference(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "paddle_tpu"), (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_without_device_raise_on_a_cuda_less_machine(no_cuda):
    with pytest.raises(RuntimeError):
        tgpt.GPTForCausalLM(tgpt.gpt2_tiny())
    with pytest.raises(RuntimeError):
        KVCachePool(KVCacheConfig(1, 1, 8, num_blocks=2, block_size=4))
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    with pytest.raises(RuntimeError):
        TokenServingEngine(model, TokenServeConfig(kv_blocks=32))
    with pytest.raises(RuntimeError):
        ParallelTrainStep(model, lambda out, lbl: out,
                          Adam(parameters=model.parameters()))
    with pytest.raises(RuntimeError):
        TrainStep(model, lambda out, lbl: out,
                  Adam(parameters=model.parameters()))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["bert"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["pipeline"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["longctx"])
    from paddle_tpu_torch.resilience import golden_step_digest
    with pytest.raises(RuntimeError, match="CUDA"):
        golden_step_digest()
    with pytest.raises(RuntimeError):
        tbert.BertForPretraining(tbert.bert_tiny())
    with pytest.raises(RuntimeError):
        dkv_packed.main()


def test_vision_entry_points_without_device_raise_on_a_cuda_less_machine(
        no_cuda):
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData
    from paddle_tpu_torch.vision.models import LeNet, resnet18

    with pytest.raises(RuntimeError, match="CUDA"):
        LeNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet18(num_classes=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataLoader(FakeData(4), batch_size=2)
    model = LeNet(device="cpu")
    with pytest.raises(RuntimeError):
        TrainStep(model, lambda out, lbl: out,
                  Adam(parameters=model.parameters()))


def test_tensor_api_without_device_raises_and_leaves_torch_tensor_alone(
        no_cuda):
    """The tensor API's creation functions make their tensors on the
    current device, the card by default: without CUDA they raise. The
    package adds no attribute to torch.Tensor (checked in a fresh process
    that imports every module)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import place

    prev = place._current_device
    place._current_device = "gpu:0"
    try:
        for make in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]),
                     lambda: pt.randn([2]), lambda: pt.eye(2),
                     lambda: pt.get_rng_state()):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    finally:
        place._current_device = prev
    code = textwrap.dedent(f"""
        import importlib, sys, torch
        sys.path.insert(0, {_REPO!r})
        before = set(dir(torch.Tensor))
        for name in {_module_names()!r}:
            importlib.import_module(name)
        print("ADDED", sorted(set(dir(torch.Tensor)) - before))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=_REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert "ADDED []" in out.stdout, out.stdout


def test_static_entry_points_without_device_raise_on_a_cuda_less_machine(
        no_cuda):
    from paddle_tpu_torch import static

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        static.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        static.Executor(static.CUDAPlace(0))
    prog = static.Program()
    with static.program_guard(prog):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            static.data("x", [None, 4])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            static.create_parameter([4])
    assert not prog.feed_vars
    assert static.Executor(static.CPUPlace()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["resnet50"])


def test_fit_prefetch_and_load_run_without_jax(tmp_path):
    """The slice's user path in a fresh process: Model.fit through the
    DevicePrefetcher, save and framework.io.load, with jax and the
    reference absent from sys.modules at the end."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {_REPO!r})
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.io import Subset
        from paddle_tpu_torch.nn import CrossEntropyLoss
        from paddle_tpu_torch.optimizer import Adam
        from paddle_tpu_torch.vision.datasets import MNIST
        from paddle_tpu_torch.vision.models import LeNet
        net = LeNet(device="cpu")
        model = pt.Model(net).prepare(Adam(parameters=net.parameters()),
                                      CrossEntropyLoss())
        model.fit(Subset(MNIST(mode="train"), list(range(128))),
                  batch_size=64, verbose=0, prefetch_depth=2)
        model.save({str(tmp_path / "ck")!r})
        state = pt.load({str(tmp_path / "ck.pdparams")!r})
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "paddle_tpu" or m.startswith("paddle_tpu."))
        print("BAD", bad, "KEYS", len(state))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=_REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD [] KEYS 10" in out.stdout, out.stdout


def test_slice_entry_points_without_device_raise_on_a_cuda_less_machine(
        no_cuda):
    from paddle_tpu_torch.io import DevicePrefetcher
    from paddle_tpu_torch.vision.models import (mobilenet_v1, mobilenet_v2,
                                                vgg16)

    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrefetcher([])
    with pytest.raises(RuntimeError, match="CUDA"):
        vgg16()
    with pytest.raises(RuntimeError, match="CUDA"):
        mobilenet_v2()
    with pytest.raises(RuntimeError, match="CUDA"):
        mobilenet_v1(scale=0.25)


def test_serving_entry_points_without_device_raise_on_a_cuda_less_machine(
        no_cuda, tmp_path):
    """The Predictor (from a layer or a .pdexport), and through it the
    one-shot ServingEngine, and the serving benches ask for the card
    unless told otherwise."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import (Config, create_predictor,
                                            create_predictor_from_path)
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.nn import Linear

    net = Linear(4, 3, device="cpu", generator=torch.Generator().manual_seed(0))
    spec = [jit.InputSpec([None, 4], "float32")]
    cfg = Config()
    cfg.set_layer(net, spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_predictor(cfg)
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_predictor(Config(prefix))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_predictor_from_path(prefix)
    cfg.disable_gpu()
    engine = ServingEngine(create_predictor(cfg))  # the CPU, asked for
    assert engine.shutdown()["submitted"] == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["serving"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["decode"])


def test_nn_layers_without_device_raise_on_a_cuda_less_machine(no_cuda):
    """The layers of the rest of nn/ that hold parameters make them on the
    card unless told otherwise."""
    from paddle_tpu_torch import nn

    for make in (lambda: nn.Transformer(32, 4, 1, 1, 64),
                 lambda: nn.MultiHeadAttention(32, 4),
                 lambda: nn.TransformerEncoderLayer(32, 4, 64),
                 lambda: nn.TransformerDecoderLayer(32, 4, 64),
                 lambda: nn.LSTM(4, 8), lambda: nn.GRU(4, 8),
                 lambda: nn.SimpleRNN(4, 8), lambda: nn.LSTMCell(4, 8),
                 lambda: nn.GRUCell(4, 8), lambda: nn.SimpleRNNCell(4, 8),
                 lambda: nn.GroupNorm(2, 4), lambda: nn.InstanceNorm2D(4),
                 lambda: nn.SpectralNorm([4, 3]),
                 lambda: nn.SyncBatchNorm(4),
                 lambda: nn.HSigmoidLoss(4, 6)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert nn.LSTM(4, 8, device="cpu").weight_ih_l0.device.type == "cpu"
