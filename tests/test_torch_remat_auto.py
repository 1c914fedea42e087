"""``remat='auto'`` and ``'offload'`` of the port (paddle_tpu_torch.ops.
remat_policy, the engines' ``lower_cost``) against the reference's:

- ``resolve`` fed the same ``lower_cost`` tables as the reference's
  ``resolve`` gives the same policy, the same candidates tried in the same
  order and the same gauges (the reference's TestRematPolicy cases, and
  the ladder's other rungs);
- the budget and the card's capacity and peaks (``profiler.xla_cost``);
- ``step_cost`` on the CPU: the peak of live bytes, FLOPs and bytes;
- the engines end to end (the reference's TestRematEndToEnd): 'auto'
  under a pinned budget engages the ladder and trains, the gauges land
  under ``jit.train_step`` and ``fleet.train_step``, ``lower_cost`` probes
  any policy;
- ``lower_cost`` leaves the engine as it was: every state bit, and the
  next step's loss, against a twin engine that was never probed;
- the longctx model (``bench.longctx_config``'s smoke size) under
  ``remat='auto'``, 3 steps through both engines.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.ops import remat_policy as jremat
from paddle_tpu.profiler import xla_cost as jcost
from paddle_tpu.profiler.telemetry import get_telemetry as jtelemetry
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import bench
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.ops import remat_policy as tremat
from paddle_tpu_torch.optimizer import Adam, lr
from paddle_tpu_torch.profiler import xla_cost as tcost
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# longctx smoke model, f32: 3 Adam steps on the same weights, the port's
# two-pass LayerNorm against the reference's one-pass
LOSS_TOL = 1e-4

_ENV = ("PADDLE_TPU_DEVICE_HBM_BYTES", "PADDLE_TPU_REMAT_BUDGET_FRAC",
        "PADDLE_TPU_COST_ANALYSIS", "PADDLE_TPU_PEAK_FLOPS",
        "PADDLE_TPU_HBM_GBPS", "PADDLE_TPU_ATTN_POLICY")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    jcost.reset()
    yield
    jcost.reset()


# ---------------------------------------------------------------------------
# resolve: the reference's ladder
# ---------------------------------------------------------------------------
# (name, HBM bytes, budget fraction, {policy: (peak, flops, bytes) | None},
#  the policy chosen)
LADDERS = [
    ("fits", "1000", "0.9", {"off": (500, 1.0, 100.0)}, "off"),
    # intensity 1 FLOP/byte, under the CPU's balance point of 10: memory
    # bound, so 'dots' is never tried
    ("mem", "1000", "0.9", {"off": (2000, 2000.0, 2000.0),
                            "nothing": (800, 2000.0, 2000.0)}, "nothing"),
    ("comp", "1000", "0.9", {"off": (2000, 1e12, 1.0),
                             "dots": (850, 1e12, 1.0),
                             "nothing": (400, 1e12, 1.0)}, "dots"),
    ("none", "100", None, {"off": (2000, 1.0, 100.0),
                           "nothing": (1500, 1.0, 100.0)}, "nothing"),
    ("offload", "1000", "1.0", {"off": (2000, 1.0, 100.0),
                                "nothing": (1200, 1.0, 100.0),
                                "offload": (700, 1.0, 100.0)}, "offload"),
    ("skip", "1000", "0.9", {"off": (2000, 1e12, 1.0), "dots": None,
                             "nothing": (800, 1e12, 1.0)}, "nothing"),
]


def _table(costs, calls):
    def lower_cost(policy):
        calls.append(policy)
        c = costs.get(policy)
        if c is None:
            return None
        peak, flops, by = c
        return {"peak_hbm_bytes": peak, "flops": flops,
                "bytes_accessed": by}

    return lower_cost


@pytest.mark.parametrize("name,hbm,frac,costs,want", LADDERS,
                         ids=[c[0] for c in LADDERS])
def test_resolve_matches_the_reference(monkeypatch, name, hbm, frac, costs,
                                       want):
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES", hbm)
    if frac is not None:
        monkeypatch.setenv("PADDLE_TPU_REMAT_BUDGET_FRAC", frac)
    entry = f"t.{name}"
    ref_calls, calls = [], []
    ref = jremat.resolve(entry, _table(costs, ref_calls))
    got = tremat.resolve(entry, _table(costs, calls), device="cpu")
    assert got == ref == want
    assert calls == ref_calls
    for gauge in (f"gauge/remat/{entry}", f"gauge/remat/peak_hbm/{entry}"):
        assert get_telemetry().scalars()[gauge] == \
            jtelemetry().scalars()[gauge]
    assert get_telemetry().scalars()[f"gauge/remat/{entry}"] == \
        tremat.POLICY_IDS[want]


def test_cost_analysis_off_resolves_off(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COST_ANALYSIS", "0")

    def boom(policy):
        raise AssertionError("must not measure with cost analysis off")

    assert tremat.resolve("t.off", boom) == jremat.resolve("t.off", boom) \
        == "off"
    assert "gauge/remat/peak_hbm/t.off" not in get_telemetry().scalars()


def test_hbm_capacity_env_override_and_cpu_fallback(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES", "123456")
    assert tcost.hbm_capacity_bytes("cpu") == 123456
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES", "not-a-number")
    assert tcost.hbm_capacity_bytes("cpu") == 32e9  # the reference's fallback
    monkeypatch.setenv("PADDLE_TPU_REMAT_BUDGET_FRAC", "0.5")
    assert tremat.budget_bytes("cpu") == 16e9


def test_chip_peaks_of_an_h100_and_the_overrides(monkeypatch):
    assert tcost.chip_peaks("cpu")["flops"] == 1e12  # the fallback
    monkeypatch.setattr(tcost, "_cuda_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    peaks = tcost.chip_peaks()
    assert (peaks["flops"], peaks["bytes_per_s"]) == (989e12, 3.35e12)
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "5e14")
    monkeypatch.setenv("PADDLE_TPU_HBM_GBPS", "0")  # non-positive: ignored
    peaks = tcost.chip_peaks()
    assert (peaks["flops"], peaks["bytes_per_s"]) == (5e14, 3.35e12)


def test_step_cost_on_the_cpu_counts_live_bytes_flops_and_bytes():
    x = torch.ones(64, 64)

    def run():
        a = torch.empty(1 << 20)        # 4 MiB
        b = a.view(-1)                  # a view: no new storage
        c = x @ x                       # 16 KiB, 2·64³ FLOPs
        del a, b
        d = torch.empty(1 << 21)        # 8 MiB while c lives
        del c, d

    cost = tremat.step_cost(run, "cpu", resident_bytes=100)
    assert cost["peak_hbm_bytes"] == 100 + (8 << 20) + 64 * 64 * 4
    assert cost["flops"] == 2 * 64 ** 3
    assert cost["bytes_accessed"] >= 3 * 64 * 64 * 4 + (12 << 20)


# ---------------------------------------------------------------------------
# the engines end to end
# ---------------------------------------------------------------------------
def _gpt(dropout=0.0, seed=7):
    cfg = tgpt.gpt2_tiny(num_layers=2, hidden_dropout=dropout)
    return tgpt.GPTForCausalLM(cfg, device="cpu", seed=seed)


def _batch(b=2, L=64):
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (b, L))).long()
    return ids, torch.roll(ids, -1, dims=1)


def test_train_step_auto_resolves_and_trains(monkeypatch):
    ids, labels = _batch(L=128)
    model = _gpt()
    probe = TrainStep(model, lambda out, lbl: out,
                      Adam(1e-3, parameters=model.parameters()),
                      device="cpu")
    off = probe.lower_cost("off", (ids, labels), (labels,))
    assert off is not None and off["peak_hbm_bytes"] > 0
    assert off["flops"] > 0 and off["bytes_accessed"] > 0
    # the budget below the no-remat peak: the ladder must engage
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES",
                       str(max(int(off["peak_hbm_bytes"] * 0.6), 1)))
    monkeypatch.setenv("PADDLE_TPU_REMAT_BUDGET_FRAC", "1.0")
    model = _gpt()
    step = TrainStep(model, lambda out, lbl: out,
                     Adam(1e-3, parameters=model.parameters()),
                     device="cpu", remat="auto")
    losses = [float(step((ids, labels), (labels,))) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert step.remat_policy_chosen in ("nothing", "offload", "dots")
    scal = get_telemetry().scalars()
    assert scal["gauge/remat/jit.train_step"] == \
        tremat.POLICY_IDS[step.remat_policy_chosen]
    assert 0 < scal["gauge/remat/peak_hbm/jit.train_step"] \
        <= off["peak_hbm_bytes"]


def test_recompute_lowers_the_measured_peak():
    ids, labels = _batch(L=128)
    model = _gpt()
    step = ParallelTrainStep(model, lambda out, lbl: out,
                             Adam(1e-3, parameters=model.parameters()),
                             device="cpu")
    peaks = {p: step.lower_cost(p, (ids, labels), (labels,))
             ["peak_hbm_bytes"] for p in ("off", "dots_no_batch", "nothing")}
    assert peaks["nothing"] < peaks["dots_no_batch"] < peaks["off"]


def test_fleet_legacy_recompute_maps_and_lower_cost_probes():
    model = _gpt()
    eng = ParallelTrainStep(model, lambda out, lbl: out,
                            Adam(1e-3, parameters=model.parameters()),
                            device="cpu", recompute="dots")
    assert eng._remat == "dots"
    ids, labels = _batch()
    cost = eng.lower_cost("nothing", (ids, labels), (labels,))
    assert cost is not None and cost["peak_hbm_bytes"] > 0
    assert np.isfinite(float(eng((ids, labels), (labels,))))


def test_fleet_remat_auto_publishes_gauges():
    model = _gpt()
    eng = ParallelTrainStep(model, lambda out, lbl: out,
                            Adam(1e-3, parameters=model.parameters()),
                            device="cpu", remat="auto")
    ids, labels = _batch()
    assert np.isfinite(float(eng((ids, labels), (labels,))))
    assert np.isfinite(float(eng((ids, labels), (labels,))))
    scal = get_telemetry().scalars()
    assert scal["gauge/remat/fleet.train_step"] == tremat.POLICY_IDS["off"]
    assert scal["gauge/remat/peak_hbm/fleet.train_step"] > 0


def _guarded_engine():
    model = _gpt(dropout=0.1, seed=11)
    sched = lr.StepDecay(1e-3, step_size=1, gamma=0.5)
    opt = Adam(sched, parameters=model.parameters())
    return ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                             guard_updates=True, fingerprint_every=1,
                             remat="dots"), sched


def _state(step, sched):
    tel = get_telemetry()
    snap = step.snapshot_state()
    return {
        "params": snap["params"], "opt_state": snap["opt_state"],
        "buffers": snap["buffers"],
        "grads": [p.grad for p in step._layer.parameters()],
        "dropout": step._layer.gpt.dropout_gen.get_state(),
        "rng": torch.get_rng_state(),
        "global_step": step._optimizer._global_step,
        "sched": (sched.last_epoch, sched.last_lr),
        "fingerprints": [(s, {k: v.clone() for k, v in fp.items()})
                         for s, fp in step.fingerprint_history()],
        "flags": step._last_flags.clone(),
        "steps": tel.counter_value("engine/steps"),
        "step_ms": (tel.hist_summary("engine/step_ms") or {}).get("count"),
    }


def _same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_lower_cost_leaves_the_engine_exactly_as_it_was():
    ids, labels = _batch()
    probed, sched_p = _guarded_engine()
    twin, sched_t = _guarded_engine()
    for step, sched in ((probed, sched_p), (twin, sched_t)):
        step((ids, labels), (labels,))
        sched.step()
    torch.manual_seed(5)
    before = _state(probed, sched_p)
    for policy in ("off", "dots", "nothing", "offload", "full"):
        assert probed.lower_cost(policy, (ids, labels), (labels,))
    _same(_state(probed, sched_p), before)
    twin_state = _state(twin, sched_t)
    for key in ("params", "opt_state", "buffers", "grads", "dropout",
                "global_step", "sched", "flags"):
        _same(before[key], twin_state[key], key)
    # the next step: the same loss, flags and state bits
    a = probed((ids, labels), (labels,))
    b = twin((ids, labels), (labels,))
    assert torch.equal(a, b)
    _same(probed.snapshot_state(), twin.snapshot_state())
    assert torch.equal(probed._last_flags, twin._last_flags)


# ---------------------------------------------------------------------------
# the longctx model under remat='auto' through both engines
# ---------------------------------------------------------------------------
def test_longctx_smoke_model_under_auto_trains_as_the_reference():
    cfg, b, L, _ = bench.longctx_config(smoke=True)
    paddle.seed(0)
    ref_model = jgpt.GPTForCausalLM(jgpt.GPTConfig(**vars(cfg)))
    p0 = {k: np.asarray(v, np.float32)
          for k, v in jfunc.get_params(ref_model).items()}
    ref_step = JStep(ref_model, loss_fn=ref_model.loss_fn,
                     optimizer=paddle.optimizer.Adam(
                         learning_rate=1e-4,
                         parameters=ref_model.parameters()),
                     mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                     remat="auto")
    ids, labels = bench.longctx_batch(cfg, b, L, "cpu")
    ref = [float(np.asarray(ref_step((ids.int().numpy(),),
                                     (labels.int().numpy(),)).numpy()))
           for _ in range(3)]
    engine = bench.longctx_engine(cfg, smoke=True, remat="auto",
                                  device="cpu")
    load_jax_params(engine._layer, p0)
    got = [float(engine((ids,), (labels,))) for _ in range(3)]
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    assert got[2] < got[0]
    # both fit their device's budget: no recompute
    assert engine.remat_policy_chosen == "off"
    assert get_telemetry().scalars()["gauge/remat/fleet.train_step"] == \
        jtelemetry().scalars()["gauge/remat/fleet.train_step"] == 0
