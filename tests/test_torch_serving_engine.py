"""Port one-shot serving (paddle_tpu_torch.inference.serving: ServingEngine,
BatchScheduler, the loadgen's run_streams / run_load / summarize)
against the reference's engine on the same weights: results equal the
reference engine's and its predictor's, padding rows are sliced off,
submissions are validated, capacity and deadlines shed explicitly, the
injected faults (`drop_req`, `slow_req`, `deadline_storm`) end every
request exactly once, a drain finishes or DRAINs queued work, a
scheduler crash latches the drain, and SIGTERM drains and exits 77.

No test may take its pytest worker down: a real SIGTERM reaches an
engine only in a child process (`subprocess.run`), or in-process with
the preemption handler installed and no engine thread left that could
fire another; every engine is shut down and its threads joined by the
autouse fixture, which fails the test if a serving thread outlives it.
Small shapes only (a 4 → 3 Linear)."""
import ast
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate_predictor
from paddle_tpu.inference import serving as jserving
from paddle_tpu.jit.functionalize import get_params as jget_params
from paddle_tpu.resilience.inject import clear_injector as jclear_injector
from paddle_tpu_torch import bench
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.inference.serving import (Request, RequestStatus,
                                                ServeConfig, ServingEngine,
                                                run_load, run_streams,
                                                summarize)
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.profiler.telemetry import get_telemetry
from paddle_tpu_torch.resilience.inject import (FaultInjector,
                                                clear_injector,
                                                install_injector)
from paddle_tpu_torch.resilience.preemption import (
    clear_preemption_request, install_preemption_handler,
    preemption_requested, uninstall_preemption_handler)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THREADS = ("ServingScheduler", "DecodeScheduler", "ServingDrain")
_ENGINES = []


@pytest.fixture(autouse=True)
def _engines_shut_down_and_joined():
    """Each engine a test starts is shut down here (its scheduler joined
    with a timeout), the injectors cleared, and the test fails if a
    serving thread is still alive: a leftover thread that fires
    ``sigterm@n`` after its handler is gone would kill the worker."""
    clear_injector()
    jclear_injector()
    get_telemetry().reset()
    yield
    try:
        for eng in _ENGINES:
            eng.shutdown()
            if eng._started:  # a never-started thread cannot be joined
                eng._scheduler.join(10.0)
    finally:
        _ENGINES.clear()
        clear_injector()
        jclear_injector()
    deadline = time.monotonic() + 10.0
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.name in _THREADS]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not alive, f"serving threads outlived the test: {alive}"


def _nets(in_dim=4, out_dim=3):
    paddle.seed(0)
    jnet = jnn.Linear(in_dim, out_dim)
    jnet.eval()
    tnet = Linear(in_dim, out_dim, "cpu").eval()
    load_jax_params(tnet, {k: np.asarray(v)
                           for k, v in jget_params(jnet).items()})
    return jnet, tnet


def make_engine(capacity=8, buckets=(1, 2, 4), in_dim=4, out_dim=3, **kw):
    jnet, tnet = _nets(in_dim, out_dim)
    cfg = Config()
    cfg.disable_gpu()
    cfg.set_layer(tnet, [InputSpec([None, in_dim], "float32", "x")])
    eng = ServingEngine(create_predictor(cfg),
                        ServeConfig(capacity=capacity, buckets=buckets, **kw))
    _ENGINES.append(eng)
    return eng, jnet


def ref_engine(jnet, capacity=8, buckets=(1, 2, 4), in_dim=4, **kw):
    cfg = JConfig()
    cfg.set_layer(jnet, [paddle.jit.InputSpec([None, in_dim], "float32",
                                              "x")])
    eng = jserving.ServingEngine(jcreate_predictor(cfg),
                                 jserving.ServeConfig(capacity=capacity,
                                                      buckets=buckets, **kw))
    _ENGINES.append(eng)
    return eng


def sample(seed=0, in_dim=4):
    return [np.random.RandomState(seed).randn(in_dim).astype("float32")]


def _ref(jnet, xs):
    return jnet(paddle.to_tensor(np.stack(xs))).numpy()


# -- results against the reference engine --------------------------------------
def test_results_match_the_reference_engine_and_predictor():
    eng, jnet = make_engine()
    jeng = ref_engine(jnet)
    eng.start()
    jeng.start()
    xs = [sample(seed=s)[0] for s in range(6)]
    reqs = [eng.submit([x], deadline_s=30.0) for x in xs]
    jreqs = [jeng.submit([x], deadline_s=30.0) for x in xs]
    want = _ref(jnet, xs)
    for r, jr, w in zip(reqs, jreqs, want):
        assert r.wait(30.0) and jr.wait(30.0)
        assert r.status == jr.status == RequestStatus.OK
        np.testing.assert_allclose(r.outputs[0], jr.outputs[0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r.outputs[0], w, rtol=1e-5, atol=1e-6)
    assert set(eng.warmup_ms) == {1, 2, 4}
    assert eng.accounting() == {"submitted": 6, "by_status": {"ok": 6},
                                "unaccounted": [], "double_terminal": 0}


def test_padding_rows_sliced_off():
    eng, jnet = make_engine(buckets=(4,))
    eng.start()
    x = sample(seed=3)[0]
    r = eng.submit([x], deadline_s=30.0)
    assert r.wait(30.0) and r.status == RequestStatus.OK
    assert r.outputs[0].shape == (3,)
    np.testing.assert_allclose(r.outputs[0], _ref(jnet, [x])[0], rtol=1e-5,
                               atol=1e-6)
    tel = get_telemetry()
    assert tel.hist_summary("serve/batch_ms.b4")["count"] == 1
    assert tel.hist_summary("serve/batch_occupancy")["p50"] == 0.25


def test_submit_validation_leaves_the_ledger():
    eng, _ = make_engine()
    with pytest.raises(RuntimeError, match="start"):
        eng.submit(sample())
    eng.start()
    with pytest.raises(ValueError, match="inputs"):
        eng.submit(sample() + sample())
    with pytest.raises(ValueError, match="batch axis"):
        eng.submit([np.zeros((2, 4), np.float32)])
    assert eng.accounting()["submitted"] == 0


def test_capacity_rejects_are_explicit():
    eng, _ = make_engine(capacity=2, buckets=(1,))
    install_injector(FaultInjector(slow_req_ids={0: 0.5}))
    eng.start()
    first = eng.submit(sample(), deadline_s=30.0)
    time.sleep(0.05)  # the scheduler holds request 0 in its slow batch
    reqs = [eng.submit(sample(seed=k), deadline_s=30.0) for k in range(1, 6)]
    rejected = [r for r in reqs if r.status == RequestStatus.REJECTED]
    assert rejected and all("capacity" in r.detail for r in rejected)
    for r in [first] + reqs:
        assert r.wait(30.0)
    acct = eng.accounting()
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    assert sum(acct["by_status"].values()) == 6
    assert get_telemetry().counter_value("serve/admission_rejects") \
        == len(rejected)


def test_deadlines_shed_at_enqueue_in_queue_and_at_completion():
    eng, _ = make_engine(capacity=16, buckets=(1,), default_deadline_s=30.0)
    install_injector(FaultInjector(slow_req_ids={0: 0.8}))
    eng.start()
    stale = eng.submit(sample(), deadline_s=0.3)  # its batch takes 0.8 s
    time.sleep(0.02)
    queued = eng.submit(sample(1), deadline_s=0.05)  # expires in the queue
    late = eng.submit(sample(2))  # the default deadline applies
    at_enqueue = eng.submit(sample(3), deadline_s=0.0)
    for r in (stale, queued, late, at_enqueue):
        assert r.wait(30.0)
    assert at_enqueue.status == RequestStatus.DEADLINE_EXCEEDED
    assert "before enqueue" in at_enqueue.detail
    assert stale.status == RequestStatus.DEADLINE_EXCEEDED
    assert "past deadline" in stale.detail and stale.outputs is None
    assert queued.status == RequestStatus.DEADLINE_EXCEEDED
    assert "in queue" in queued.detail
    assert late.status == RequestStatus.OK
    assert late.deadline - late.submitted_at == pytest.approx(30.0)


def test_drop_req_terminates_as_error():
    eng, _ = make_engine(buckets=(1,))
    install_injector(FaultInjector(drop_req_ids=[0]))
    eng.start()
    r = eng.submit(sample(), deadline_s=30.0)
    assert r.wait(30.0) and r.status == RequestStatus.ERROR
    assert "dropped" in r.detail
    ok = eng.submit(sample(seed=1), deadline_s=30.0)
    assert ok.wait(30.0) and ok.status == RequestStatus.OK


def test_deadline_storm_sheds_without_stalling_live_traffic():
    eng, _ = make_engine(capacity=16)
    install_injector(FaultInjector(deadline_storms={0: 4},
                                   storm_deadline_s=1e-6))
    eng.start()
    stormed = [eng.submit(sample(seed=k)) for k in range(4)]
    live = eng.submit(sample(seed=9), deadline_s=30.0)
    for r in stormed:
        assert r.wait(30.0)
        assert r.status == RequestStatus.DEADLINE_EXCEEDED
    assert live.wait(30.0) and live.status == RequestStatus.OK


# -- drain, crash, preemption -------------------------------------------------
def test_drain_finishes_queued_work():
    eng, _ = make_engine()
    eng.start()
    reqs = [eng.submit(sample(seed=k), deadline_s=30.0) for k in range(5)]
    acct = eng.drain(wait=True)
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    assert all(r.status == RequestStatus.OK for r in reqs)
    late = eng.submit(sample(seed=9), deadline_s=30.0)
    assert late.status == RequestStatus.REJECTED and "draining" in late.detail


def test_drain_grace_expiry_marks_drained():
    eng, _ = make_engine(capacity=16, buckets=(1,), drain_grace_s=0.15)
    install_injector(FaultInjector(slow_req_ids={0: 0.8}))
    eng.start()
    eng.submit(sample(), deadline_s=30.0)  # stalls the scheduler
    time.sleep(0.05)
    backlog = [eng.submit(sample(seed=k), deadline_s=30.0)
               for k in range(1, 5)]
    rows = eng.debug_requests()
    assert [row["id"] for row in rows] == list(range(5))
    assert all(row["phase"] == "inflight" for row in rows)
    acct = eng.drain(wait=True)
    assert acct["unaccounted"] == []
    assert any(r.status == RequestStatus.DRAINED for r in backlog)
    assert eng.debug_requests() == []


def test_shutdown_without_start():
    eng, _ = make_engine()
    assert eng.shutdown()["submitted"] == 0


def test_sigterm_racing_shutdown_still_exits_77():
    """A SIGTERM landing after a normal shutdown drain latched never set
    the drain reason; the relaunch exit must still fire off the flag.
    The handler is installed before the signal and the engine's threads
    are gone (the drain joined them) before it is sent."""
    eng, _ = make_engine(drain_grace_s=0.5)
    eng.start()
    install_preemption_handler()
    try:
        eng.drain(wait=True, reason="shutdown")
        eng._scheduler.join(10.0)
        assert not eng._scheduler.alive
        assert eng.drain_reason == "shutdown"
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not preemption_requested():
            assert time.monotonic() < deadline, "flag never set"
            time.sleep(0.01)
        with pytest.raises(SystemExit) as ei:
            eng.exit_if_preempted(timeout=5.0)
        assert ei.value.code == 77
    finally:
        clear_preemption_request()
        uninstall_preemption_handler()
    assert eng.exit_if_preempted() is False  # no preemption now


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scheduler_crash_latches_drain_and_sheds(monkeypatch):
    import paddle_tpu_torch.inference.serving.scheduler as sched_mod

    eng, _ = make_engine(default_deadline_s=10.0, drain_grace_s=0.2)
    eng.start()
    ok = eng.submit(sample())
    assert ok.wait(10.0) and ok.status == RequestStatus.OK

    def boom():
        raise RuntimeError("injected scheduler crash")

    monkeypatch.setattr(sched_mod, "heartbeat", boom)
    eng._scheduler.join(10.0)
    assert not eng._scheduler.alive
    assert eng.draining and eng.drain_reason == "scheduler crashed"
    req = eng.submit(sample(1))
    assert req.done() and req.status == RequestStatus.REJECTED
    assert eng.wait_drained(10.0)
    acct = eng.accounting()
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0


_SIGTERM_WORKER = textwrap.dedent("""
    import json, os, signal, sys, threading, time
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.nn import Linear

    net = Linear(4, 3, "cpu", generator=torch.Generator().manual_seed(0))
    net.eval()
    cfg = Config()
    cfg.disable_gpu()
    cfg.set_layer(net, [InputSpec([None, 4], "float32", "x")])
    eng = ServingEngine(create_predictor(cfg), ServeConfig(
        capacity=16, buckets=(1, 2, 4), default_deadline_s=5.0,
        drain_grace_s=3.0))
    drained = []
    eng.install_preemption(on_drain=lambda: drained.append(1)).start()
    rng = np.random.RandomState(0)
    reqs = []
    # SIGTERM this process mid-load from a side thread (a real signal,
    # the real handler) while submissions continue
    threading.Timer(0.15, lambda: os.kill(os.getpid(),
                                          signal.SIGTERM)).start()
    for k in range(400):
        reqs.append(eng.submit([rng.randn(4).astype("float32")]))
        time.sleep(0.001)
    eng.wait_drained(20.0)
    statuses = {}
    for r in reqs:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    with open(os.environ["OUT"], "w") as f:
        json.dump({"acct": eng.accounting(), "statuses": statuses,
                   "drain_reason": eng.drain_reason,
                   "on_drain": len(drained)}, f)
    eng.exit_if_preempted()
    sys.exit(3)  # no preemption drain happened
""")


def test_sigterm_drains_and_exits_77_in_a_child(tmp_path):
    """Mid-load SIGTERM, in a child process: admission stops, accepted
    work finishes or is DRAINED, every request is terminal exactly once,
    and the process leaves with exit code 77."""
    out_path = str(tmp_path / "out.json")
    worker = tmp_path / "worker.py"
    worker.write_text(_SIGTERM_WORKER)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OUT": out_path,
           "PYTHONPATH": _REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("PADDLE_TPU_INJECT", None)
    r = subprocess.run([sys.executable, str(worker)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 77, (r.returncode, r.stderr[-2000:])
    with open(out_path) as f:
        out = json.load(f)
    acct, statuses = out["acct"], out["statuses"]
    assert out["drain_reason"] == "preempted" and out["on_drain"] == 1
    assert acct["submitted"] == 400
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
    assert statuses.get("ok", 0) >= 1 and statuses.get("rejected", 0) >= 1
    assert set(statuses) <= RequestStatus.TERMINAL


def test_injected_sigterm_at_a_batch_boundary_in_a_child(tmp_path):
    """``sigterm@2`` fires from the scheduler thread at batch boundary 2
    of a live engine — only ever in a child process."""
    code = textwrap.dedent("""
        import sys, time
        import numpy as np
        import torch
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.inference.serving import (ServeConfig,
                                                        ServingEngine)
        from paddle_tpu_torch.jit import InputSpec
        from paddle_tpu_torch.nn import Linear
        from paddle_tpu_torch.resilience.inject import (FaultInjector,
                                                        install_injector)

        cfg = Config()
        cfg.disable_gpu()
        cfg.set_layer(Linear(4, 3, "cpu", generator=torch.Generator()
                             .manual_seed(0)).eval(),
                      [InputSpec([None, 4], "float32")])
        eng = ServingEngine(create_predictor(cfg), ServeConfig(
            buckets=(1,), drain_grace_s=2.0))
        install_injector(FaultInjector(sigterm_steps=[2]))
        eng.install_preemption().start()
        reqs = [eng.submit([np.ones(4, np.float32)]) for _ in range(6)]
        eng.wait_drained(20.0)
        acct = eng.accounting()
        assert acct["unaccounted"] == [] and acct["double_terminal"] == 0
        assert eng.drain_reason == "preempted", eng.drain_reason
        eng.exit_if_preempted()
        sys.exit(3)
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": _REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("PADDLE_TPU_INJECT", None)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 77, (r.returncode, r.stderr[-2000:])



def test_sigterm_taken_by_another_thread_still_drains_in_a_child():
    """A SIGTERM that another thread takes (the main thread blocks it) runs
    its Python handler only when the main thread next runs bytecode:
    ``wait_drained`` must wake up for it, not sleep out its timeout."""
    code = textwrap.dedent("""
        import os, signal, sys, time
        import torch
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.inference.serving import (ServeConfig,
                                                        ServingEngine)
        from paddle_tpu_torch.jit import InputSpec
        from paddle_tpu_torch.nn import Linear

        cfg = Config()
        cfg.disable_gpu()
        cfg.set_layer(Linear(4, 3, "cpu", generator=torch.Generator()
                             .manual_seed(0)).eval(),
                      [InputSpec([None, 4], "float32")])
        eng = ServingEngine(create_predictor(cfg), ServeConfig(
            buckets=(1,), drain_grace_s=2.0))
        eng.install_preemption().start()
        # the scheduler thread, started before the mask, takes the signal
        signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGTERM])
        os.kill(os.getpid(), signal.SIGTERM)
        t0 = time.monotonic()
        drained = eng.wait_drained(30.0)
        took = time.monotonic() - t0
        assert drained and took < 10.0, (drained, took)
        assert eng.drain_reason == "preempted", eng.drain_reason
        eng.exit_if_preempted()
        sys.exit(3)
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": _REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("PADDLE_TPU_INJECT", None)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 77, (r.returncode, r.stderr[-2000:])

# -- load generators -----------------------------------------------------------
def test_summarize_counts_and_percentiles():
    reqs = []
    for k in range(10):
        r = Request(k, sample())
        r.finish(RequestStatus.OK if k < 8 else RequestStatus.REJECTED)
        reqs.append(r)
    s = summarize(reqs)
    js = jserving.summarize(reqs)
    assert s == js
    assert s["by_status"] == {"ok": 8, "rejected": 2}
    assert 0 <= s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]


def test_run_streams_closed_loop_matches_the_reference():
    eng, jnet = make_engine(capacity=16)
    jeng = ref_engine(jnet, capacity=16)
    out = {}
    for name, e in (("port", eng), ("ref", jeng)):
        e.start()
        out[name] = (run_streams if name == "port" else jserving.run_streams)(
            e, n_streams=3, requests_per_stream=4,
            input_fn=lambda k: sample(seed=k), deadline_s=30.0)
    for res in out.values():
        assert res["submitted"] == 12 and res["by_status"] == {"ok": 12}
        assert res["ok_per_s"] > 0 and res["streams"] == 3
    assert set(out["port"]) == set(out["ref"])


def test_run_load_open_loop_overload_sheds_and_accounts():
    eng, _ = make_engine(capacity=2, buckets=(1,))
    install_injector(FaultInjector(slow_req_ids={0: 0.3, 10: 0.3}))
    eng.start()
    out, reqs = run_load(eng, n_requests=60, rate_per_s=400.0,
                         input_fn=lambda k: sample(seed=k), deadline_s=0.2,
                         wait_timeout_s=30.0, return_requests=True)
    assert out["submitted"] == 60 and len(reqs) == 60
    shed = (out["by_status"].get("rejected", 0)
            + out["by_status"].get("deadline_exceeded", 0))
    assert shed > 0 and sum(out["by_status"].values()) == 60
    assert out["offered_rate_per_s"] == 400.0
    eng.shutdown()
    acct = eng.accounting()
    assert acct["unaccounted"] == [] and acct["double_terminal"] == 0


# -- bench serving / decode --------------------------------------------------------
def _bench_all_keys(fn_name):
    """The keys of the dict ``bench_all.<fn_name>`` returns."""
    tree = ast.parse(open(os.path.join(_REPO, "bench_all.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def test_bench_serving_and_decode_smoke_print_the_reference_keys(capsys):
    for which, fn_name in (("serving", "bench_serving"),
                           ("decode", "bench_decode")):
        res = bench.main([which, "--smoke"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-2] == "device: cpu"
        assert json.loads(lines[-1]) == res
        assert set(res) == _bench_all_keys(fn_name), which
        assert res["value"] > 0
    assert res["spec_accept_rate"] >= 0 and res["kv_evictions"] >= 0
