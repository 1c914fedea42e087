"""Port inference (paddle_tpu_torch.inference: Config, Predictor and the
torch.export `.pdexport` of jit.save and static.save_inference_model)
against the reference's Predictor on the same weights and inputs: the
handle API and `run(inputs)`, the live layer and the artifact, a dynamic
batch served at sizes other than the trace's, threaded runs, precision
baked into an artifact and refused when the Config asks for another,
the serving hooks, and `save_inference_model` pruning the training
subgraph. A 2-layer GPT exported with the flash tier forced keeps both
registered kernel ops (LayerNorm 2L+1, flash L) in its graph, and its
loaded program gives the reference GPT's logits. f32 outputs agree to
1e-5 relative (the GPT's logits to 1e-4: its LayerNorm is two-pass, the
reference's one-pass). Small shapes only; everything runs on the CPU."""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import jit, static
from paddle_tpu_torch.inference import (Config, PrecisionType,
                                        create_predictor)
from paddle_tpu_torch.inference import _export
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn.param_attr import ParamAttr
from paddle_tpu_torch.ops import flash_tpu, fused
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.text.models import gpt as tgpt

_THREADS = ("ServingScheduler", "DecodeScheduler", "ServingDrain")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_thread_outlives_the_test():
    """This file starts no engine; the check holds it to that."""
    get_telemetry().reset()
    yield
    alive = [t.name for t in threading.enumerate() if t.name in _THREADS]
    assert not alive, f"serving threads outlived the test: {alive}"


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16, "cpu")
        self.fc2 = Linear(16, 4, "cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _pair(seed=0):
    paddle.seed(seed)
    jnet = JNet()
    jnet.eval()
    tnet = TNet().eval()
    load_jax_params(tnet, {k: np.asarray(v)
                           for k, v in jget_params(jnet).items()})
    return jnet, tnet


def _x(seed, b=2):
    return np.random.RandomState(seed).randn(b, 8).astype(np.float32)


def _ref(jnet, x):
    return jnet(paddle.to_tensor(x)).numpy()


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _cpu(config):
    config.disable_gpu()
    return config


def _spec(shape, name=None, dtype="float32"):
    return jit.InputSpec(shape, dtype, name)


# -- jit.save -> .pdexport -> Predictor -------------------------------------
def test_export_and_predict_matches_the_reference(tmp_path):
    jnet, tnet = _pair()
    prefix = str(tmp_path / "small")
    jit.save(tnet, prefix, input_spec=[_spec([2, 8], "x")])
    jprefix = str(tmp_path / "ref")
    paddle.jit.save(jnet, jprefix,
                    input_spec=[paddle.jit.InputSpec([2, 8], "float32", "x")])
    x = _x(0)
    pred = create_predictor(_cpu(Config(prefix)))
    jpred = jinf.create_predictor(jinf.Config(jprefix))
    assert pred.get_input_names() == jpred.get_input_names() == ["x"]
    assert pred.get_output_names() == jpred.get_output_names()
    for p in (pred, jpred):
        p.get_input_handle("x").copy_from_cpu(x)
        assert p.run() is True
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    want = jpred.get_output_handle(
        jpred.get_output_names()[0]).copy_to_cpu()
    _close(out, want)
    _close(out, _ref(jnet, x))
    assert os.path.exists(prefix + ".pdiparams")
    assert jit.load(prefix).meta["in_specs"] == [([2, 8], "float32")]
    # the reference's artifact is a jax.export program: not this format
    with pytest.raises(ValueError, match="torch.export"):
        create_predictor(_cpu(Config(jprefix)))


def test_run_with_inputs_and_the_live_layer(tmp_path):
    jnet, tnet = _pair(1)
    prefix = str(tmp_path / "small2")
    jit.save(tnet, prefix, input_spec=[_spec([3, 8])])
    x = _x(1, 3)
    (out,) = create_predictor(_cpu(Config(prefix))).run([x])
    _close(out, _ref(jnet, x))
    cfg = _cpu(Config())
    cfg.set_layer(tnet, [_spec([3, 8], "inp")])
    pred = create_predictor(cfg)
    assert pred.get_input_names() == ["inp"]
    (out2,) = pred.run([x])
    np.testing.assert_array_equal(out2, out)
    assert pred.exported is None and pred.serving_dtype_bits == 32


def test_missing_export_and_misplaced_layer_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        create_predictor(_cpu(Config(str(tmp_path / "nope"))))
    with pytest.raises(ValueError, match="set_model"):
        create_predictor(_cpu(Config()))
    # nothing moves silently: a layer elsewhere than the Config's device
    cfg = _cpu(Config())
    cfg.set_layer(_pair()[1].to("meta"), [_spec([None, 8])])
    with pytest.raises(ValueError, match="move the layer"):
        create_predictor(cfg)


def test_dynamic_batch_export_serves_other_batches(tmp_path):
    """InputSpec([None, 8]) is traced at batch 2 and serves 1, 5 and 32
    (torch.export specializes only the sizes it traced at 0 and 1)."""
    jnet, tnet = _pair(2)
    prefix = str(tmp_path / "dyn")
    jit.save(tnet, prefix, input_spec=[_spec([None, 8])])
    pred = create_predictor(_cpu(Config(prefix)))
    for b in (1, 5, 32):
        x = _x(b, b)
        (out,) = pred.run([x])
        assert out.shape == (b, 4)
        _close(out, _ref(jnet, x))


def test_kernel_ops_stand_in_only_while_an_export_traces(monkeypatch):
    """Eager LayerNorm and causal flash calls go straight to their
    wrappers; an export traces the registered ops into its graph, and the
    exported program gives the eager outputs. An export that reaches a
    wrapper instead of its op raises."""
    _, tnet = _pair()

    class WithKernels(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = tnet
            self.w = torch.nn.Parameter(torch.ones(4))
            self.b = torch.nn.Parameter(torch.zeros(4))

        def forward(self, x):
            y = fused.fused_layer_norm(self.net(x), self.w, self.b)
            q = y.view(y.shape[0], 1, 1, 4).expand(-1, 2, -1, -1)
            out, _ = flash_tpu.flash_attention_blhd(q, q, q)
            return out.reshape(y.shape[0], 8)

    calls = {"layer_norm_fwd": 0, "flash_attn_fwd": 0}

    def count(key, op):
        def wrapped(*a):
            calls[key] += 1
            return op(*a)
        return wrapped

    monkeypatch.setattr(fused, "_ln_fwd_op",
                        count("layer_norm_fwd", fused._ln_fwd_op))
    monkeypatch.setattr(flash_tpu, "_flash_fwd_op",
                        count("flash_attn_fwd", flash_tpu._flash_fwd_op))
    module = WithKernels().eval()
    x = torch.from_numpy(_x(4, 3))
    with torch.no_grad():
        eager = module(x)
    assert calls == {"layer_norm_fwd": 0, "flash_attn_fwd": 0}
    ep = _export.export_module(module, [([None, 8], torch.float32)], "cpu")
    assert calls == {"layer_norm_fwd": 1, "flash_attn_fwd": 1}
    assert _export.kernel_nodes(ep) == {"layer_norm_fwd": 1,
                                        "flash_attn_fwd": 1}
    with torch.no_grad():
        got = ep.module()(x)
    torch.testing.assert_close(got, eager, rtol=RTOL, atol=RTOL)
    # an export that reaches a wrapper in place of its op raises rather
    # than tracing the plain version into the program
    for name, wrapper in (("_ln_fwd_op", fused._ln_fwd),
                          ("_flash_fwd_op", flash_tpu._fwd)):
        with monkeypatch.context() as m:
            m.setattr(fused if name == "_ln_fwd_op" else flash_tpu, name,
                      wrapper)
            with pytest.raises(RuntimeError, match="registered op"):
                _export.export_module(module, [([None, 8], torch.float32)],
                                      "cpu")


# -- a GPT through the export keeps the kernels' ops ---------------------------
_GPT = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=2,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)


def test_gpt_export_holds_the_kernel_ops_and_the_reference_logits(
        tmp_path, monkeypatch):
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**_GPT))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_GPT), device="cpu").eval()
    load_jax_params(tm, {k: np.asarray(v)
                         for k, v in jget_params(jm).items()})
    # on the CPU the dense dispatch takes the plain tier; forcing the flash
    # tier puts the flash op on the path, as the card's dispatch does
    monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "flash_tpu")
    prefix = str(tmp_path / "gpt")
    jit.save(tm, prefix, input_spec=[_spec([None, 16], "ids", "int64")])
    pred = create_predictor(_cpu(Config(prefix)))
    L = _GPT["num_layers"]
    assert pred.kernel_ops == {"layer_norm_fwd": 2 * L + 1,
                               "flash_attn_fwd": L}
    assert _export.kernel_nodes(pred.exported) == pred.kernel_ops
    calls = {"ln": 0, "flash": 0}
    ln_fwd, flash_fwd = fused._ln_fwd, flash_tpu._fwd

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fused, "_ln_fwd", count("ln", ln_fwd))
    monkeypatch.setattr(flash_tpu, "_fwd", count("flash", flash_fwd))
    ids = np.random.RandomState(3).randint(0, 96, (3, 16)).astype(np.int64)
    (logits,) = pred.run([ids])
    # the loaded program called the registered ops (the kernel on the card)
    assert calls == {"ln": 2 * L + 1, "flash": L}
    want = jm(paddle.Tensor(ids)).numpy()
    _close(logits, want, rtol=1e-4)
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    _close(logits, eager)


# -- static.save_inference_model -------------------------------------------------
def _fc_pair(with_loss=False):
    """fc(relu(fc(x))) in both packages with the reference's weights."""
    paddle.seed(0)
    attrs = lambda i: dict(weight_attr=paddle.ParamAttr(name=f"w{i}"),
                           bias_attr=paddle.ParamAttr(name=f"b{i}"))
    tattrs = lambda i: dict(weight_attr=ParamAttr(name=f"w{i}"),
                            bias_attr=ParamAttr(name=f"b{i}"))
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [4, 6], "float32")
        jout = jstatic.nn.fc(jstatic.nn.fc(jx, 10, activation="relu",
                                           **attrs(0)), 3, **attrs(1))
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [4, 6], "float32", device="cpu")
        out = static.nn.fc(static.nn.fc(x, 10, activation="relu",
                                        **tattrs(0)), 3, **tattrs(1))
        label = loss = None
        if with_loss:
            label = static.data("label", [4, 3], "float32", device="cpu")
            loss = ((out - label) ** 2).mean()
    static.set_program_state(main, {p.name: np.asarray(p._value)
                                    for p in jmain.all_parameters()})
    return (jmain, jx, jout), (main, x, out, label, loss)


def test_save_load_inference_model_matches_the_reference(tmp_path):
    (jmain, jx, jout), (main, x, out, _, _) = _fc_pair()
    xv = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    (want,) = jstatic.Executor().run(jmain, feed={"x": xv},
                                     fetch_list=[jout])
    prefix = str(tmp_path / "static_model")
    exe = static.Executor(static.CPUPlace())
    static.save_inference_model(prefix, [x], [out], exe, program=main)
    pred, feeds, fetches = static.load_inference_model(prefix, exe)
    assert feeds == ["x"] and fetches == ["output0"]
    (got,) = pred.run([xv])
    _close(got, want)
    # serialize/deserialize: the same program as bytes
    blob = static.serialize_program([x], [out], program=main)
    pred2, feeds2, _ = static.deserialize_program(blob)
    assert feeds2 == ["x"]
    np.testing.assert_array_equal(pred2.run([xv])[0], got)


def test_prunes_training_subgraph(tmp_path):
    """Exporting [x] → [pred] from a program that also has the label and
    loss ops prunes them: the artifact takes no label feed."""
    (jmain, _, jout), (main, x, out, label, loss) = _fc_pair(True)
    xv = np.random.RandomState(4).randn(4, 6).astype(np.float32)
    lv = np.zeros((4, 3), np.float32)
    want, _ = static.Executor(static.CPUPlace()).run(
        main, feed={"x": xv, "label": lv}, fetch_list=[out, loss])
    prefix = str(tmp_path / "pruned")
    static.save_inference_model(prefix, [x], [out], program=main)
    pred, feeds, _ = static.load_inference_model(prefix)
    assert feeds == ["x"] and pred.get_input_names() == ["x"]
    (got,) = pred.run([xv])
    _close(got, want)
    _close(got, jstatic.Executor().run(jmain, feed={"x": xv},
                                       fetch_list=[jout])[0])
    with pytest.raises(ValueError, match="label"):
        static.save_inference_model(str(tmp_path / "bad"), [x], [loss],
                                    program=main)


def test_dynamic_batch_placeholder_stays_dynamic(tmp_path):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 6], "float32", device="cpu")
        out = static.nn.fc(x, 3)
    prefix = str(tmp_path / "dynstatic")
    static.save_inference_model(prefix, [x], [out], program=main)
    pred, _, _ = static.load_inference_model(prefix)
    exe = static.Executor(static.CPUPlace())
    for b in (1, 7):
        xv = np.random.RandomState(b).randn(b, 6).astype(np.float32)
        (want,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        (got,) = pred.run([xv])
        assert got.shape == (b, 3)
        _close(got, want)


# -- threads -----------------------------------------------------------------
def test_threaded_run_with_inputs_is_correct():
    """Each caller of run(inputs) gets its own batch's outputs."""
    jnet, tnet = _pair()
    cfg = _cpu(Config())
    cfg.set_layer(tnet, [_spec([2, 8], "x")])
    pred = create_predictor(cfg)
    xs = [_x(s) for s in range(8)]
    want = [_ref(jnet, x) for x in xs]
    errors, start = [], threading.Barrier(len(xs))

    def worker(i):
        try:
            start.wait()
            for _ in range(10):
                (out,) = pred.run([xs[i]])
                _close(out, want[i])
        except Exception as e:  # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors


def test_threaded_canonical_handle_sequence(tmp_path):
    """copy_from_cpu → run() → copy_to_cpu as three calls from many
    threads on the exported program: each reads back its own outputs."""
    jnet, tnet = _pair()
    prefix = str(tmp_path / "seq")
    jit.save(tnet, prefix, input_spec=[_spec([2, 8], "x")])
    pred = create_predictor(_cpu(Config(prefix)))
    errors, start = [], threading.Barrier(6)

    def worker(seed):
        try:
            x = _x(seed)
            want = _ref(jnet, x)
            inp = pred.get_input_handle("x")
            outh = pred.get_output_handle(pred.get_output_names()[0])
            start.wait()
            for _ in range(10):
                inp.copy_from_cpu(x)
                pred.run()
                _close(outh.copy_to_cpu(), want)
        except Exception as e:
            errors.append((seed, e))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors


# -- precision -------------------------------------------------------------------
def test_set_layer_bfloat16_casts_weights_and_answers_in_float32():
    jnet, tnet = _pair()
    x = _x(0, 4)
    cfg = _cpu(Config())
    cfg.set_precision(PrecisionType.Bfloat16)
    cfg.set_layer(tnet, [_spec([None, 8])])
    pred = create_predictor(cfg)
    assert pred.serving_dtype == "bfloat16" and pred.serving_dtype_bits == 16
    assert get_telemetry().scalars()["gauge/serve/dtype_bits"] == 16
    (out,) = pred.run([x])
    assert out.dtype == np.float32
    jcfg = jinf.Config()
    jcfg.set_precision(jinf.PrecisionType.Bfloat16)
    jcfg.set_layer(jnet, [paddle.jit.InputSpec([None, 8], "float32")])
    (jout,) = jinf.create_predictor(jcfg).run([x])
    np.testing.assert_allclose(out, jout, atol=0.05, rtol=0.02)
    np.testing.assert_allclose(out, _ref(jnet, x), atol=0.15, rtol=0.05)
    assert next(tnet.parameters()).dtype == torch.float32  # a cast copy


def test_export_precision_bakes_and_loads_and_mismatches_raise(tmp_path):
    jnet, tnet = _pair()
    x = _x(0, 4)
    prefix = str(tmp_path / "bf16")
    jit.save(tnet, prefix, precision="bfloat16",
             input_spec=[_spec([None, 8])])
    assert next(tnet.parameters()).dtype == torch.float32
    cfg = _cpu(Config(prefix))
    cfg.set_precision(PrecisionType.Bfloat16)
    pred = create_predictor(cfg)
    assert pred.serving_dtype == "bfloat16" and pred.serving_dtype_bits == 16
    (out,) = pred.run([x])
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, _ref(jnet, x), atol=0.15, rtol=0.05)
    explicit = _cpu(Config(prefix))
    explicit.set_precision(PrecisionType.Float32)
    with pytest.raises(ValueError, match="float32"):
        create_predictor(explicit)
    assert create_predictor(_cpu(Config(prefix))).serving_dtype == "bfloat16"
    f32 = str(tmp_path / "f32")
    jit.save(tnet, f32, input_spec=[_spec([None, 8])])
    asks16 = _cpu(Config(f32))
    asks16.set_precision(PrecisionType.Bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        create_predictor(asks16)
    with pytest.raises(ValueError, match="precision"):
        jit.save(tnet, str(tmp_path / "bad"), precision="int4",
                 input_spec=[_spec([None, 8])])


# -- serving hooks -------------------------------------------------------------
def test_serving_hooks_of_the_layer_and_the_artifact(tmp_path):
    jnet, tnet = _pair()
    cfg = _cpu(Config())
    cfg.set_layer(tnet, [_spec([None, 8])])
    live = create_predictor(cfg)
    prefix = str(tmp_path / "hooks")
    jit.save(tnet, prefix, input_spec=[_spec([None, 8])])
    art = create_predictor(_cpu(Config(prefix)))
    x = _x(5, 3)
    for pred in (live, art):
        assert pred.sample_specs() == [((8,), np.dtype("float32"))]
        out = pred.serving_fn()(x)
        assert isinstance(out, tuple) and isinstance(out[0], torch.Tensor)
        _close(out[0].numpy(), _ref(jnet, x))
    cfg = _cpu(Config())
    cfg.set_layer(tnet)
    with pytest.raises(RuntimeError, match="per-sample"):
        create_predictor(cfg).sample_specs()
