"""The port's spans, goodput ledger, telemetry sink and resilience helpers
(paddle_tpu_torch.profiler.{spans,goodput,telemetry},
paddle_tpu_torch.resilience.{retry,preemption}) against the reference's
on the CPU:

- the same sequence of spans (fit → epoch → step → compute, a mark, a
  checkpoint) gives the same chrome events in both packages: names,
  categories, phases, threads, the parent structure and the steps,
  leaving out the times and the process-wide span ids; the flight
  recorder's B/E sequence too; `in_category` and `current_span`;
- the goodput ledger books the same categories for the same claims, its
  categories sum to the wall, and claims from a second thread are
  no-ops; `Telemetry.to_jsonl` writes the reference's record layout;
- `backoff_delays` and `retry_call` retry on the same schedule and
  re-raise the last error; the preemption flag, its clearing and
  `exit_for_relaunch` (the save callback, then exit 77).

Everything here is host code: exact comparisons.
"""
import importlib
import json
import os
import signal
import threading
import time

import pytest

import paddle_tpu  # noqa: F401  (the reference's package)
from paddle_tpu_torch.profiler import goodput as tgoodput
from paddle_tpu_torch.profiler import spans as tspans
from paddle_tpu_torch.profiler.telemetry import Telemetry
from paddle_tpu_torch.resilience import preemption as tpreempt
from paddle_tpu_torch.resilience import retry as tretry
import torch_threads  # noqa: F401  (one torch thread a worker)

jspans = importlib.import_module("paddle_tpu.profiler.spans")
jgoodput = importlib.import_module("paddle_tpu.profiler.goodput")
jtelemetry = importlib.import_module("paddle_tpu.profiler.telemetry")
jretry = importlib.import_module("paddle_tpu.resilience.retry")
jpreempt = importlib.import_module("paddle_tpu.resilience.preemption")


def _drive_spans(mod):
    mod.flight_recorder().clear()
    mod.open_window()
    seen = {}
    with mod.span("fit", cat="fit"):
        with mod.span("epoch", cat="epoch"):
            with mod.span("step", cat="step", step=3):
                seen["in_step"] = mod.in_category("step")
                with mod.span("compute", cat="compute") as s:
                    seen["current"] = mod.current_span() is s
                    seen["inherited"] = s.step
                mod.mark("boundary", cat="marker")
            with mod.span("checkpoint", cat="checkpoint"):
                pass
    seen["after"] = (mod.current_span(), mod.in_category("step"))
    mod.close_window()
    events = mod.chrome_events()
    flight = [(e["phase"], e["name"], e["cat"], e["step"])
              for e in mod.flight_recorder().dump()]
    return events, flight, seen


def _structure(events):
    """The events without times and with span ids renumbered in order."""
    order = {}
    for e in sorted(events, key=lambda e: e["args"]["span_id"]):
        order[e["args"]["span_id"]] = len(order) + 1
    return [(e["name"], e["ph"], e["cat"], e["pid"], e["tid"],
             order[e["args"]["span_id"]],
             order.get(e["args"]["parent_id"], 0), e["args"].get("step"))
            for e in events]


def test_span_sequence_gives_the_reference_chrome_events():
    r_events, r_flight, r_seen = _drive_spans(jspans)
    t_events, t_flight, t_seen = _drive_spans(tspans)
    assert _structure(t_events) == _structure(r_events)
    assert len(t_events) == 6
    assert t_flight == r_flight
    assert t_seen == r_seen == {"in_step": True, "current": True,
                                "inherited": 3, "after": (None, False)}
    for e in t_events:
        assert e["dur"] >= 0 and e["ts"] > 0
    # each export drains its window
    assert tspans.chrome_events() == jspans.chrome_events() == []


def test_request_traces_match_the_reference():
    out = []
    for mod in (jspans, tspans):
        tr = mod.ReqTrace(7, trace_id="t-7")
        tr.event("submit")
        tr.event("queue", 0.0)
        mod.trace_store().add(tr)
        ev = mod.trace_chrome_events(pid=1)
        out.append([(e["name"], e["ph"], e["tid"], e["cat"], e["args"])
                    for e in ev])
        assert [mod.should_trace(i, 0.25) for i in range(8)] == \
            [i % 4 == 0 for i in range(8)]
    assert out[0] == out[1]


def _drive_ledger(mod):
    led = mod.GoodputLedger()
    with led.activity("compile"):
        time.sleep(0.01)
    with led.activity("productive_step"):
        time.sleep(0.01)
        with led.activity("input_wait"):
            time.sleep(0.01)
    other = threading.Thread(target=lambda: led.activity(
        "checkpoint_save").__enter__())
    other.start()
    other.join(timeout=10)
    snap = led.snapshot()
    with pytest.raises(ValueError):
        led.activity("unattributed")
    return led, snap


def test_goodput_ledger_books_as_the_reference():
    _, rsnap = _drive_ledger(jgoodput)
    led, tsnap = _drive_ledger(tgoodput)
    assert set(tsnap) == set(rsnap)
    booked = lambda s: {c for c, v in s["categories"].items() if v > 0}
    assert booked(tsnap) == booked(rsnap) >= {"startup", "compile",
                                              "productive_step",
                                              "input_wait"}
    assert "checkpoint_save" not in booked(tsnap)  # another thread's
    total = sum(tsnap["categories"].values())
    assert abs(total - tsnap["wall_s"]) < 1e-6
    assert tsnap["current"] == rsnap["current"] == "unattributed"
    assert tgoodput.CATEGORIES == jgoodput.CATEGORIES


def test_to_jsonl_writes_the_reference_record(tmp_path):
    recs = []
    for tel in (jtelemetry.Telemetry(), Telemetry()):
        tel.counter("a/b", 2)
        tel.gauge("g", 1.5)
        with tel.timer("t_ms"):
            pass
        path = str(tmp_path / f"{type(tel).__module__}.jsonl")
        tel.to_jsonl(path, step=4, tag="train", extra={"loss": 0.25,
                                                       "bad": "x"})
        recs.append(json.loads(open(path).read()))
    ref, got = recs
    assert set(got) == set(ref) >= {"ts", "step", "tag", "scalars",
                                    "goodput"}
    assert (got["step"], got["tag"]) == (ref["step"], ref["tag"]) == \
        (4, "train")
    for key in ("counter/a/b", "gauge/g", "loss", "hist/t_ms/count",
                "gauge/goodput/wall_s"):
        assert key in got["scalars"] and key in ref["scalars"], key
    assert got["scalars"]["counter/a/b"] == 2 and \
        got["scalars"]["loss"] == 0.25 and "bad" not in got["scalars"]
    assert set(got["goodput"]) == set(ref["goodput"])


@pytest.mark.parametrize("failures,retries", [(0, 3), (2, 3), (4, 3)])
def test_retry_call_follows_the_reference_schedule(failures, retries):
    assert tretry.backoff_delays(5, base=0.1, factor=3.0, max_delay=2.0) \
        == jretry.backoff_delays(5, base=0.1, factor=3.0, max_delay=2.0)
    logs = []
    for mod in (jretry, tretry):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) <= failures:
                raise OSError(f"blip {len(calls)}")
            return "ok"

        try:
            got = mod.retry_call(flaky, retries=retries, base=0.05,
                                 sleep=slept.append, counter=None)
        except OSError as e:
            got = str(e)
        logs.append((got, slept, len(calls)))
    assert logs[0] == logs[1]
    assert logs[1][0] == ("ok" if failures <= retries
                          else f"blip {retries + 1}")


def test_preemption_flag_and_exit_for_relaunch():
    assert tpreempt.EXIT_PREEMPTED == jpreempt.EXIT_PREEMPTED == 77
    assert not tpreempt.preemption_requested()
    handler = tpreempt.install_preemption_handler(signals=(signal.SIGUSR1,))
    try:
        assert tpreempt.install_preemption_handler() is handler
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(100):
            if tpreempt.preemption_requested():
                break
            time.sleep(0.01)
        assert tpreempt.preemption_requested()
        assert handler.received_signum == signal.SIGUSR1
        tpreempt.clear_preemption_request()
        assert not tpreempt.preemption_requested()
        saved = []
        with pytest.raises(SystemExit) as exc:
            tpreempt.exit_for_relaunch(lambda: saved.append(1))
        assert exc.value.code == 77 and saved == [1]
    finally:
        tpreempt.uninstall_preemption_handler()
    assert not tpreempt.preemption_requested()
