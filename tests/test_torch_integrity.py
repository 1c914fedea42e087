"""The port's state fingerprints and silent-corruption defense
(paddle_tpu_torch.resilience.integrity, the engines' `fingerprint_every`,
`snapshot_state` / `restore_state`, distributed.communication.
all_gather_object) on the CPU.

Against the reference: the reference engine's `snapshot_state()`, as
numpy, goes through the port's `restore_state`, and the port's own
`snapshot_state()` then folds to the reference's XOR word (f32 mode, and
bf16 master mode on a small GPT); the engines' fingerprints of the same
bf16 run carry the reference's step labels and its abs-sum within 1e-3
(two engines round bf16 differently). Then the reference's own
`tests/test_integrity.py` scenarios, minus the cluster checkpoint (not
ported: asking for its rung raises), the static graph and the schema
gates: the interval history, identical runs' digests, a window's label,
a silent bit flip, the logical fingerprint, the majority vote, the
golden-step self-test, the filesystem all-gather (threads, a bounded
timeout) and detect-and-repair between two threads."""
import importlib
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import sanitizer as jsan
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.sanitizer import tree_fingerprint
from paddle_tpu_torch.distributed.communication import (CollectiveTimeout,
                                                        all_gather_object)
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.resilience import (FaultInjector, IntegrityError,
                                         IntegrityMonitor, IntegrityPolicy,
                                         RecoveryPolicy, StepGuard,
                                         corrupt_param_bit,
                                         fingerprint_digest,
                                         golden_step_digest,
                                         host_state_fingerprint,
                                         pick_healthy, selftest)
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _ref_weights(seed=0):
    paddle.seed(seed)
    net = jnn.Linear(8, 4)
    return {k: np.asarray(v) for k, v in jfunc.get_params(net).items()}


def _fp_step(every=2, engine=TrainStep, **kw):
    net = load_jax_params(tnn.Linear(8, 4, device="cpu"), _ref_weights())
    opt = Adam(learning_rate=1e-2, parameters=net.parameters())
    return engine(net, _mse, opt, device="cpu", guard_updates=True,
                  fingerprint_every=every, **kw)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return ([rng.randn(16, 8).astype("float32") for _ in range(n)],
            [rng.randn(16, 4).astype("float32") for _ in range(n)])


def _digest_now(step):
    return fingerprint_digest(step.state_fingerprint())


# ---------------------------------------------------------------------------
# engine state against the reference's
# ---------------------------------------------------------------------------
def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_xor(snap):
    fp = jax.jit(lambda s: jsan.tree_fingerprint(
        s["params"], s["opt_state"], s["buffers"]))(snap)
    return int(np.asarray(fp["xor"]))


def test_restored_reference_mlp_state_folds_to_the_reference_word():
    paddle.seed(0)
    net = jnn.Linear(8, 4)
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters())
    ref = JTrainStep(net, _mse, opt, guard_updates=True)
    xs, ys = _batches(3)
    for i in range(3):
        ref((xs[i],), (ys[i],))
    snap = ref.snapshot_state()
    step = _fp_step()
    step.restore_state(_host(snap))
    assert step.state_fingerprint()["xor"].item() == _ref_xor(snap)
    mine = step.snapshot_state()
    assert sorted(mine["opt_state"]["weight"]) == sorted(
        snap["opt_state"]["weight"])
    assert tree_fingerprint(mine["params"], mine["opt_state"],
                            mine["buffers"])["xor"].item() == _ref_xor(snap)


@pytest.fixture(scope="module")
def gpt_master_runs():
    """Two bf16 master-mode steps of a small GPT through the reference's
    engine, fingerprinting each step; its snapshot as numpy."""
    paddle.seed(7)
    # the reference's gpt2_tiny() passes its own num_layers
    jmodel = jgpt.GPTForCausalLM(jgpt.GPTConfig(
        vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
        max_position_embeddings=256, hidden_dropout=0.0,
        attention_dropout=0.0))
    cfg = tgpt.gpt2_tiny(num_layers=2)
    p0 = {k: np.asarray(v, np.float32)
          for k, v in jfunc.get_params(jmodel).items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    jopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jmodel.parameters(),
                                 multi_precision=True)
    jstep = JStep(jmodel, lambda out, lbl: out, jopt,
                  mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                  compute_dtype=jnp.bfloat16, fingerprint_every=1)
    for _ in range(2):
        jstep((ids, labels), (labels,))
    return cfg, p0, _host(jstep.snapshot_state()), jstep.last_fingerprint()


def _port_gpt(cfg, p0, **kw):
    model = load_jax_params(tgpt.GPTForCausalLM(cfg, device="cpu"), p0)
    opt = Adam(1e-3, parameters=model.parameters(), multi_precision=True)
    return ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                             compute_dtype=torch.bfloat16, **kw)


def test_restored_reference_gpt_master_state_folds_to_the_reference_word(
        gpt_master_runs):
    cfg, p0, snap, _ = gpt_master_runs
    step = _port_gpt(cfg, p0)
    step.restore_state(snap)
    mine = step.snapshot_state()
    name = sorted(mine["params"])[0]
    assert mine["params"][name].dtype == torch.bfloat16
    assert sorted(mine["opt_state"][name]) == ["beta1_pow", "beta2_pow",
                                               "master", "moment1",
                                               "moment2"]
    assert step.state_fingerprint()["xor"].item() == _ref_xor(snap)


def test_gpt_master_fingerprint_step_label_and_sums_follow_reference(
        gpt_master_runs):
    cfg, p0, _, (ref_step, ref_fp) = gpt_master_runs
    step = _port_gpt(cfg, p0, fingerprint_every=1)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 32))).long()
    labels = torch.roll(ids, -1, dims=1)
    for _ in range(2):
        step((ids, labels), (labels,))
    s, fp = step.last_fingerprint()
    assert s == ref_step == 1
    # bf16 compute in two engines: the states differ by roundings, so the
    # sums agree to their rounding and the words are each a run's own
    np.testing.assert_allclose(float(fp["abs_sum"]),
                               float(ref_fp["abs_sum"]), rtol=1e-3)
    assert fp["xor"].dtype == np.uint32 and fp["sum"].dtype == np.float32


# ---------------------------------------------------------------------------
# engine fingerprints (the reference's TestEngineFingerprints)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", [TrainStep, ParallelTrainStep])
def test_interval_history_and_gauges(engine):
    get_telemetry().reset()
    step = _fp_step(every=2, engine=engine)
    xs, ys = _batches(5)
    for i in range(5):
        step((xs[i],), (ys[i],))
    assert [s for s, _ in step.fingerprint_history()] == [0, 2, 4]
    s, fp = step.last_fingerprint()
    assert s == 4 and set(fp) == {"sum", "abs_sum", "xor"}
    assert step.fingerprint_every == 2
    gauges = get_telemetry().snapshot()["gauges"]
    assert gauges["integrity/fingerprint_every"] == 2
    assert gauges["integrity/fingerprint.xor"] == float(fp["xor"])
    # the published fingerprint is the state the step kept
    assert fingerprint_digest(fp) == _digest_now(step)


def test_fingerprint_every_from_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FINGERPRINT_EVERY", "3")
    monkeypatch.setenv("PADDLE_TPU_FP_HISTORY", "2")
    step = _fp_step(every=None)
    assert step.fingerprint_every == 3
    xs, ys = _batches(7)
    for i in range(7):
        step((xs[i],), (ys[i],))
    assert [s for s, _ in step.fingerprint_history()] == [3, 6]


def test_identical_runs_produce_identical_digests():
    xs, ys = _batches(4)
    digests = []
    for _ in range(2):
        step = _fp_step(every=2)
        for i in range(4):
            step((xs[i],), (ys[i],))
        digests.append(fingerprint_digest(step.last_fingerprint()[1]))
    assert digests[0] == digests[1]


def test_window_fingerprints_its_final_state_with_its_last_step():
    step = _fp_step(every=2, engine=ParallelTrainStep)
    xs, ys = _batches(5)
    for i in range(5):
        step((xs[i],), (ys[i],))
    rng = np.random.RandomState(1)
    w_x = np.stack([rng.randn(16, 8).astype("float32") for _ in range(4)])
    w_y = np.stack([rng.randn(16, 4).astype("float32") for _ in range(4)])
    step.run_steps((w_x,), (w_y,))
    s, fp = step.last_fingerprint()
    assert s == 8  # global step 5, a window of 4: the last is step 8
    assert fingerprint_digest(fp) == _digest_now(step)
    assert [h for h, _ in step.fingerprint_history()] == [0, 2, 4, 8]


def test_bitflip_is_silent_but_changes_the_digest():
    step = _fp_step(every=1)
    xs, ys = _batches(3)
    step((xs[0],), (ys[0],))
    before = fingerprint_digest(step.last_fingerprint()[1])
    at_flip = _digest_now(step)
    name = corrupt_param_bit(step)
    assert name == "bias" and _digest_now(step) != at_flip
    step((xs[1],), (ys[1],))
    ok, bad = step.last_step_finite()
    assert ok and not bad
    assert fingerprint_digest(step.last_fingerprint()[1]) != before


def test_corrupt_param_bit_flips_exactly_one_bit():
    step = _fp_step(every=1)
    w = step.snapshot_state()["params"]["weight"]
    corrupt_param_bit(step, "weight", index=5, bit=31)
    got = step.snapshot_state()["params"]["weight"]
    diff = (w.view(torch.int32) ^ got.view(torch.int32)).reshape(-1)
    assert int((diff != 0).sum()) == 1
    assert int(diff[5]) & 0xFFFFFFFF == 1 << 31


# ---------------------------------------------------------------------------
# host fingerprint, vote, self-test
# ---------------------------------------------------------------------------
def test_host_state_fingerprint_is_value_identity():
    state = {"w": torch.arange(12, dtype=torch.float32),
             "b": {"x": np.ones((3,), np.int32)},
             "h": torch.ones(4, dtype=torch.bfloat16)}
    a = host_state_fingerprint(state)
    b = host_state_fingerprint({"w": state["w"].clone(),
                                "b": {"x": state["b"]["x"].copy()},
                                "h": state["h"].clone()})
    assert a == b and a["leaves"] == 3
    mutated = {**state, "w": state["w"].clone()}
    mutated["w"].view(torch.int32)[3] ^= 1
    assert host_state_fingerprint(mutated)["crc32"] != a["crc32"]
    shapes = [host_state_fingerprint({"w": t}) for t in (
        torch.zeros(4), torch.zeros(2, 2), torch.zeros(4, dtype=torch.int32))]
    assert len({s["crc32"] for s in shapes}) == 3


@pytest.mark.parametrize("entries,healthy,minority", [
    ([(0, "aa"), (1, "aa"), (2, "bb")], [0, 1], [2]),
    ([(0, "aa"), (1, "bb")], [0], [1]),
    ([(0, "aa"), (1, "bb"), (2, "aa"), (3, "cc")], [0, 2], [1, 3])])
def test_pick_healthy(entries, healthy, minority):
    assert pick_healthy(entries) == (healthy, minority)


def test_fingerprint_digest_is_the_reference_wire_form():
    fp = {"sum": np.float32(1.5), "abs_sum": np.float32(2.5),
          "xor": np.uint32(0xDEADBEEF)}
    from paddle_tpu.resilience.integrity import fingerprint_digest as jdig

    assert fingerprint_digest(fp) == jdig(fp)
    dev = {"sum": torch.tensor(1.5), "abs_sum": torch.tensor(2.5),
           "xor": torch.tensor(0xDEADBEEF, dtype=torch.int64)}
    assert fingerprint_digest(dev) == jdig(fp)


def test_selftest_records_verifies_and_catches_tampering(tmp_path):
    p = str(tmp_path / "golden.json")
    tel = get_telemetry()
    runs = tel.counter_value("resilience/selftest_runs")
    fails = tel.counter_value("resilience/selftest_failures")
    r1 = selftest(p, device="cpu")
    assert r1["ok"] and r1["recorded"] and r1["key"].startswith("torch-")
    r2 = selftest(p, device="cpu")
    assert r2["ok"] and not r2["recorded"] and r2["golden"] == r2["digest"]
    assert golden_step_digest("cpu") == r2["digest"]
    goldens = json.load(open(p))
    goldens[r2["key"]] = "0" * 64
    json.dump(goldens, open(p, "w"))
    with pytest.raises(IntegrityError, match="wrong numbers"):
        selftest(p, device="cpu")
    assert not selftest(p, raise_on_mismatch=False, device="cpu")["ok"]
    assert tel.counter_value("resilience/selftest_runs") == runs + 4
    assert tel.counter_value("resilience/selftest_failures") == fails + 2


# ---------------------------------------------------------------------------
# all_gather_object (the reference's TestAllGatherObject)
# ---------------------------------------------------------------------------
def _in_threads(fn, ranks=(0, 1), timeout=30):
    out, errs = {}, {}

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in ranks]
    [t.start() for t in ts]
    [t.join(timeout) for t in ts]
    assert not any(t.is_alive() for t in ts), "a rank did not finish"
    assert not errs, errs
    return out


def test_fs_rendezvous_gathers_in_rank_order(tmp_path):
    out = _in_threads(lambda r: all_gather_object(
        {"rank": r, "v": r * 10}, key="k0", rendezvous_dir=str(tmp_path),
        timeout_s=20, rank=r, world_size=2))
    assert out[0] == out[1] and [g["rank"] for g in out[0]] == [0, 1]


def test_cleanup_prev_unlinks_only_the_older_key(tmp_path):
    for key in ("s0", "s1"):
        _in_threads(lambda r, key=key: all_gather_object(
            {"r": r}, key=key, rendezvous_dir=str(tmp_path), timeout_s=20,
            rank=r, world_size=2, cleanup_prev=True))
    names = sorted(os.listdir(str(tmp_path)))
    assert names and all(n.startswith("s1.") for n in names), names


def test_missing_peer_times_out(tmp_path):
    with pytest.raises(CollectiveTimeout, match=r"rank\(s\) \[1\]"):
        all_gather_object({"r": 0}, key="k1", rendezvous_dir=str(tmp_path),
                          timeout_s=0.3, poll_s=0.02, rank=0, world_size=2)


def test_no_transport_is_an_error_not_a_hang(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_INTEGRITY_DIR", raising=False)
    with pytest.raises(RuntimeError, match="no transport"):
        all_gather_object({"r": 0}, key="k2", rank=0, world_size=2)
    assert all_gather_object({"r": 0}, key="k3", world_size=1) == [{"r": 0}]


# ---------------------------------------------------------------------------
# the monitor (the reference's TestIntegrityMonitor)
# ---------------------------------------------------------------------------
def _pair(tmp_path, every=2, **pol):
    rigs = []
    for r in (0, 1):
        step = _fp_step(every=every)
        mon = IntegrityMonitor(step, rank=r, world_size=2,
                               policy=IntegrityPolicy(
                                   rendezvous_dir=str(tmp_path),
                                   timeout_s=30, hang_exit=False, **pol))
        guard = StepGuard(step, RecoveryPolicy(quarantine_dir=None),
                          integrity=mon)
        rigs.append((step, mon, guard))
    return rigs


def _run_lockstep(rigs, steps, corrupt=None):
    xs, ys = _batches(steps)

    def run(r):
        step, _, guard = rigs[r]
        for i in range(steps):
            if corrupt == (r, i):
                corrupt_param_bit(step)
            guard((xs[i],), (ys[i],))

    _in_threads(run, timeout=60)


def test_clean_replicas_raise_no_false_positive(tmp_path):
    rigs = _pair(tmp_path)
    _run_lockstep(rigs, 6)
    assert rigs[0][1].last_event is None and rigs[1][1].last_event is None
    assert fingerprint_digest(rigs[0][0].last_fingerprint()[1]) == \
        fingerprint_digest(rigs[1][0].last_fingerprint()[1])


def test_bitflip_detected_within_one_interval_and_repaired(tmp_path):
    tel = get_telemetry()
    det = tel.counter_value("resilience/sdc_detected")
    rep1 = tel.counter_value("resilience/sdc_repaired.rank1")
    rigs = _pair(tmp_path, every=2)
    _run_lockstep(rigs, 8, corrupt=(1, 3))
    ev = rigs[0][1].last_event
    assert ev is not None and ev["minority"] == [1]
    assert ev["repaired"] and ev["via"] == "healthy_replica"
    assert ev["step"] - 3 <= 2
    assert _digest_now(rigs[0][0]) == _digest_now(rigs[1][0])
    assert tel.counter_value("resilience/sdc_detected") >= det + 2
    assert tel.counter_value("resilience/sdc_repaired.rank1") >= rep1 + 2


def test_repair_falls_back_to_the_guard_snapshot(tmp_path, monkeypatch):
    step = _fp_step(every=1)
    guard = StepGuard(step, RecoveryPolicy(quarantine_dir=None))
    xs, ys = _batches(2)
    guard((xs[0],), (ys[0],))  # seeds the rolling snapshot
    mon = IntegrityMonitor(step, rank=1, world_size=2,
                           policy=IntegrityPolicy(
                               rendezvous_dir=str(tmp_path), timeout_s=5,
                               hang_exit=False),
                           snapshot_restore=guard._restore_snapshot)
    snap = guard._snap
    want = fingerprint_digest(tree_fingerprint(
        snap["params"], snap["opt_state"], snap["buffers"]))
    corrupt_param_bit(step)

    def boom(*a, **k):
        raise OSError("publish path down")

    monkeypatch.setattr(mon, "_repair_from_source", boom)
    event = {"repaired": False, "via": None}
    mon._repair(1, source=0, minority=[1], event=event)
    assert event["repaired"] and event["via"] == "snapshot"
    assert _digest_now(step) == want


def test_cluster_checkpoint_rung_is_not_ported_and_says_so():
    with pytest.raises(NotImplementedError, match="resilience/cluster.py"):
        IntegrityMonitor(_fp_step(every=1), rank=0, world_size=2,
                         checkpoint=object())


def test_every_rung_failing_is_integrity_error(tmp_path, monkeypatch):
    mon = IntegrityMonitor(_fp_step(every=1), rank=1, world_size=2,
                           policy=IntegrityPolicy(
                               rendezvous_dir=str(tmp_path), timeout_s=5,
                               hang_exit=False))

    def boom(*a, **k):
        raise OSError("publish path down")

    monkeypatch.setattr(mon, "_repair_from_source", boom)
    with pytest.raises(IntegrityError, match="no repair source"):
        mon._repair(1, source=0, minority=[1],
                    event={"repaired": False, "via": None})


def test_persistent_repairs_give_up(tmp_path, monkeypatch):
    import paddle_tpu_torch.distributed.communication as comm

    step = _fp_step(every=1)
    mon = IntegrityMonitor(step, rank=0, world_size=2,
                           policy=IntegrityPolicy(
                               rendezvous_dir=str(tmp_path), timeout_s=5,
                               hang_exit=False, max_repairs=0))
    monkeypatch.setattr(mon, "_repair_from_source", lambda *a, **k: None)
    monkeypatch.setattr(comm, "all_gather_object", lambda *a, **k: [
        {"rank": 0, "step": 0, "fp": "aa"},
        {"rank": 1, "step": 0, "fp": "bb"}])
    xs, ys = _batches(1)
    step((xs[0],), (ys[0],))
    with pytest.raises(IntegrityError, match="persistently"):
        mon.after_step(1)


def test_dead_peer_times_out_not_hangs(tmp_path):
    step = _fp_step(every=1)
    mon = IntegrityMonitor(step, rank=0, world_size=2,
                           policy=IntegrityPolicy(
                               rendezvous_dir=str(tmp_path), timeout_s=0.3,
                               poll_s=0.02, hang_exit=False))
    xs, ys = _batches(1)
    step((xs[0],), (ys[0],))
    with pytest.raises(CollectiveTimeout):
        mon.after_step(1)


def test_monitor_requires_a_fingerprinting_engine():
    with pytest.raises(ValueError, match="fingerprint_every"):
        IntegrityMonitor(_fp_step(every=0), rank=0, world_size=2)


def test_single_rank_world_is_a_noop():
    step = _fp_step(every=1)
    mon = IntegrityMonitor(step, rank=0, world_size=1)
    xs, ys = _batches(2)
    step((xs[0],), (ys[0],))
    assert mon.after_step(1) is False and mon.last_event is None


def test_injected_flip_fires_once_on_the_matching_rank(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    tel = get_telemetry()
    before = tel.counter_value("resilience/injected_bitflip_param")
    step = _fp_step(every=1)
    guard = StepGuard(step, RecoveryPolicy(quarantine_dir=None),
                      injector=FaultInjector(bitflip_param_steps={1: 0}))
    xs, ys = _batches(3)
    guard((xs[0],), (ys[0],))
    guard((xs[1],), (ys[1],))  # the flip fires at this boundary
    assert step.last_step_finite()[0]  # silent
    assert tel.counter_value("resilience/injected_bitflip_param") == \
        before + 1
    wrong = FaultInjector(bitflip_param_steps={3: 1})
    assert wrong.bitflip_param_due(3) is False and wrong._fired == set()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_engine_fingerprint_is_the_plain_fold_of_its_state(
        cuda_device):
    from paddle_tpu_torch.core.tree import leaves

    net = load_jax_params(tnn.Linear(8, 4, device="cpu"),
                          _ref_weights()).to(cuda_device)
    opt = Adam(learning_rate=1e-2, parameters=net.parameters())
    step = TrainStep(net, _mse, opt, fingerprint_every=1)
    xs, ys = _batches(3)
    for i in range(3):
        step((xs[i],), (ys[i],))
    _, fp = step.last_fingerprint()
    state = [t.detach().cpu() for t in leaves(step._state_tree())]
    ref = tree_fingerprint(state)
    assert int(fp["xor"]) == ref["xor"].item()
    np.testing.assert_allclose(float(fp["abs_sum"]), ref["abs_sum"].item(),
                               rtol=1e-6)


def test_bert_bench_engine_fingerprints_every_step_on_the_cpu():
    """`bench bert`'s fingerprinting leg at bert_tiny's size: the engine
    it builds publishes a fingerprint a step, each the fold of the state
    it keeps."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.text.models.bert import bert_tiny

    cfg = bert_tiny()
    step = bench.bert_engine(cfg, fingerprint_every=1, device="cpu")
    ids, mlm, nsp = bench.bert_batch(cfg, 2, 16, device="cpu")
    for _ in range(2):
        step((ids,), (mlm, nsp))
    assert [s for s, _ in step.fingerprint_history()] == [0, 1]
    assert fingerprint_digest(step.last_fingerprint()[1]) == \
        _digest_now(step)
