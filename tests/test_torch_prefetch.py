"""The port's device prefetcher (paddle_tpu_torch.io.prefetch) on the
CPU: the reference's own `tests/test_prefetch.py` cases that need no
mesh, staged with `device="cpu"` — order, re-iteration after exhaustion,
close mid-epoch, the context manager, a source exception re-raised in
order, running ahead of the consumer, the telemetry counters and
histograms, bucketing of ragged batches — and `ShapeBuckets` against the
reference's on the same arrays, bit for bit (pads, hits and misses).
The default device is the card: without one the prefetcher raises, and
`sharding` waits for the multi-GPU port. The engines' `prefetch`
(`ParallelTrainStep`, `TrainStep`, `EvalStep`, as the reference's
`test_engine_prefetch_end_to_end` / `test_jit_train_step_prefetch` use
them) gives the losses and outputs of the loop without it."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.io.prefetch import ShapeBuckets as JShapeBuckets
from paddle_tpu_torch.io import DevicePrefetcher, ShapeBuckets
from paddle_tpu_torch.profiler import goodput
from paddle_tpu_torch.profiler.telemetry import get_telemetry
import torch_threads  # noqa: F401  (one torch thread a worker)


def _gen_batches(n, shape=(4, 8), fail_at=None, delay=0.0):
    rng = np.random.RandomState(0)
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise ValueError(f"boom at {i}")
        if delay:
            time.sleep(delay)
        yield {"x": rng.randn(*shape).astype(np.float32),
               "i": np.full((shape[0],), i, np.int64)}


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "DevicePrefetcher" and t.is_alive()]


def _cpu(source, **kw):
    return DevicePrefetcher(source, device="cpu", **kw)


def test_yields_all_batches_in_order_as_tensors():
    out = list(_cpu(_gen_batches(7), depth=2))
    assert len(out) == 7
    want = list(_gen_batches(7))
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        assert int(b["i"][0]) == i
        np.testing.assert_array_equal(b["x"].numpy(), want[i]["x"])
    assert not _prefetch_threads()


def test_reiterating_after_exhaustion_is_empty():
    pf = _cpu(_gen_batches(2))
    assert len(list(pf)) == 2
    assert list(pf) == []


def test_clean_shutdown_mid_epoch():
    pf = _cpu(_gen_batches(1000), depth=2)
    got = [next(pf) for _ in range(3)]
    assert len(got) == 3
    pf.close()
    for _ in range(50):  # the worker sees the close within ~100 ms
        if not _prefetch_threads():
            break
        time.sleep(0.02)
    assert not _prefetch_threads()
    with pytest.raises(StopIteration):
        next(pf)


def test_context_manager_closes():
    with _cpu(_gen_batches(100), depth=2) as pf:
        next(pf)
    assert not _prefetch_threads()


def test_worker_exception_propagates_in_order():
    got = []
    with pytest.raises(ValueError, match="boom at 3"):
        for b in _cpu(_gen_batches(10, fail_at=3), depth=2):
            got.append(b)
    assert len(got) == 3  # every batch before the failure, none after
    assert not _prefetch_threads()


def test_prefetch_runs_ahead_of_consumer():
    produced = []

    def src():
        for i in range(6):
            produced.append(i)
            yield np.full((2,), i, np.float32)

    pf = _cpu(src(), depth=3)
    next(pf)
    time.sleep(0.3)  # the worker fills the queue meanwhile
    assert len(produced) >= 3
    pf.close()


def test_telemetry_counters_histograms_and_input_wait():
    tel = get_telemetry()
    before = tel.counter_value("prefetch/batches")
    h_before = tel.histogram("prefetch/h2d_bytes").count
    wait_before = goodput.snapshot()["categories"]["input_wait"]
    list(_cpu(_gen_batches(4, delay=0.02)))
    assert tel.counter_value("prefetch/batches") == before + 4
    h = tel.histogram("prefetch/h2d_bytes")
    assert h.count == h_before + 4
    # x [4, 8] f32 + i [4] i64 = 160 bytes a batch
    assert h.min <= 160 <= h.max
    assert tel.histogram("prefetch/h2d_ms").count >= 4
    assert goodput.snapshot()["categories"]["input_wait"] > wait_before


def test_ragged_batches_pad_into_buckets_and_count():
    tel = get_telemetry()
    h0 = tel.counter_value("prefetch/bucket_hits")
    m0 = tel.counter_value("prefetch/bucket_misses")
    src = (np.ones((2, L), np.float32) for L in (5, 40, 12, 16))
    out = list(_cpu(src, buckets=(16,)))
    assert [tuple(b.shape) for b in out] == [(2, 16), (2, 40), (2, 16),
                                             (2, 16)]
    assert float(out[0][:, 5:].abs().sum()) == 0.0
    assert tel.counter_value("prefetch/bucket_hits") == h0 + 3
    assert tel.counter_value("prefetch/bucket_misses") == m0 + 1


def test_pad_stage_only_keeps_the_leaves():
    src = ({"x": np.zeros((2, 3), np.float32)} for _ in range(2))
    out = list(DevicePrefetcher(src, to_device=False, buckets=(8,)))
    assert isinstance(out[0]["x"], np.ndarray)
    assert out[0]["x"].shape == (2, 8)


def test_default_device_and_sharding(monkeypatch):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        DevicePrefetcher([], sharding=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrefetcher([])


@pytest.mark.parametrize("sizes,axis,pad,leaves", [
    ((16, 32), 1, -1, {"x": (2, 11)}),
    ((16, 32), 1, 0, {"a": (2, 32), "b": (2, 40)}),
    ((8,), 1, 0, {"y": (4,)}),
    ((4, 12), 0, 7, {"x": (3, 5), "y": (20, 2), "z": (12,)}),
    ((16,), 2, 0.5, {"x": (2, 3, 9), "y": (2, 3)})])
def test_shape_buckets_match_reference(sizes, axis, pad, leaves):
    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.int64):
        tree = {k: (rng.randn(*s) * 10).astype(dtype)
                for k, s in leaves.items()}
        want, wh, wm = JShapeBuckets(sizes, axis=axis, pad_value=pad
                                     ).pad_tree(tree)
        bk = ShapeBuckets(sizes, axis=axis, pad_value=pad)
        got, gh, gm = bk.pad_tree(tree)
        as_t, th, tm = bk.pad_tree({k: torch.from_numpy(v)
                                    for k, v in tree.items()})
        assert (gh, gm) == (th, tm) == (wh, wm)
        for k in tree:
            w = np.asarray(want[k])
            np.testing.assert_array_equal(got[k], w)
            assert got[k].dtype == w.dtype
            np.testing.assert_array_equal(as_t[k].numpy(), w)


def test_shape_buckets_refuse_empty_and_non_positive_sizes():
    with pytest.raises(ValueError):
        ShapeBuckets(())
    with pytest.raises(ValueError):
        ShapeBuckets((0, 8))
    assert ShapeBuckets((32, 8)).target(9) == 32
    assert ShapeBuckets((8,)).target(9) is None


# -- the engines' prefetch ----------------------------------------------------
def _engine_run(engine_cls, prefetch, n=5):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.optimizer import Adam

    gen = torch.Generator().manual_seed(0)
    net = tnn.Linear(8, 4, device="cpu")
    with torch.no_grad():
        net.weight.copy_(torch.randn(8, 4, generator=gen))
    opt = Adam(1e-2, parameters=net.parameters())
    step = engine_cls(net, lambda out, y: ((out - y) ** 2).mean(), opt,
                      device="cpu")
    rng = np.random.RandomState(0)
    batches = [((rng.randn(16, 8).astype(np.float32),),
                (rng.randn(16, 4).astype(np.float32),)) for _ in range(n)]
    source = step.prefetch(iter(batches), depth=2) if prefetch else batches
    return [float(step(x, y)) for x, y in source]


@pytest.mark.parametrize("engine", ["TrainStep", "ParallelTrainStep"])
def test_engine_prefetch_gives_the_losses_of_the_plain_loop(engine):
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.jit.train_step import TrainStep

    cls = {"TrainStep": TrainStep, "ParallelTrainStep": ParallelTrainStep}[
        engine]
    plain = _engine_run(cls, prefetch=False)
    staged = _engine_run(cls, prefetch=True)
    assert len(staged) == 5 and staged == plain


def test_eval_step_prefetch_gives_the_same_outputs():
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.jit.train_step import EvalStep

    net = tnn.Linear(8, 4, device="cpu")
    with torch.no_grad():
        net.weight.copy_(torch.ones(8, 4))
    ev = EvalStep(net)
    rng = np.random.RandomState(1)
    xs = [rng.randn(3, 8).astype(np.float32) for _ in range(4)]
    with ev.prefetch(iter([(x,) for x in xs]), depth=2) as pf:
        staged = [ev(*b) for b in pf]
    assert len(staged) == 4
    for x, y in zip(xs, staged):
        assert isinstance(y, torch.Tensor)
        assert torch.equal(y, ev(torch.from_numpy(x)))


def test_engine_prefetch_stages_onto_the_engine_device():
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.jit.train_step import TrainStep
    from paddle_tpu_torch.optimizer import Adam

    net = tnn.Linear(2, 2, device="cpu")
    step = TrainStep(net, lambda o, y: o.sum(),
                     Adam(1e-3, parameters=net.parameters()), device="cpu")
    pf = step.prefetch([((np.ones((1, 2), np.float32),), ())],
                       buckets=(4,))
    assert pf._device == torch.device("cpu") and pf.depth == 2
    assert pf._buckets is not None
    pf.close()


def test_pipeline_bench_twin_gives_the_same_losses_with_the_prefetcher():
    """`bench pipeline`'s workload at a small size on the CPU: a pass
    with `step.prefetch` and one without, from the same weights, give the
    same losses (the bench's rates come from these passes)."""
    from paddle_tpu_torch import bench

    kw = dict(b=8, d=32, n_batches=4, acquire_s=0.0, device="cpu")
    off = bench.InputPipeline(**kw).epoch(False)
    on = bench.InputPipeline(**kw).epoch(True)
    assert len(on) == 4 and on == off
    assert all(np.isfinite(on))
