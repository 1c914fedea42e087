"""The port's process world and collectives on the CPU, in a gloo world
of 2 ranks (``torch_dist_world``; one world for the module): every
collective of ``distributed.communication`` with the values each rank
must see, a group and a mesh axis as groups, ``all_gather_object`` over
the process group; ``DataParallel`` with ``SyncBatchNorm`` held against
one process on the global batch (outputs, gradients, one SGD step,
``state_dict`` without the wrapper's prefix); the prefetcher's sharding
(each rank stages its own rows and positions); ``fleet.init`` with a
sharding strategy and ``create_train_step`` against the single-device
engine; and two 2-process jobs of their own: ``launch`` (a rank that dies
tears the job down, as the reference's supervisor does) and ``spawn``."""
import os
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.distributed.launch import launch
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
import torch_dist_workers as W
import torch_threads  # noqa: F401  (one torch thread a worker)
from torch_dist_world import World

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, str(tmp_path_factory.mktemp("world2")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def coll(world):
    return world.run("collectives")


EXPECTED = {
    "all_reduce_sum": [3.0] * 3, "all_reduce_max": [2.0] * 3,
    "all_reduce_min": [1.0] * 3, "all_reduce_prod": [2.0] * 3,
    "all_reduce_avg": [1.5] * 3, "all_gather": [[0, 0], [1, 10]],
    "broadcast": [1.0, 1.0], "wait": [1.0],
    "objects": [{"rank": 0}, {"rank": 1}], "axis_group": [2.0],
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_collective_gives_every_rank_the_same_value(coll, name):
    for r in coll:
        assert r[name] == EXPECTED[name]


def test_rank_dependent_collectives(coll):
    # reduce_scatter of [r + i] chunks: rank i gets sum_r (r + i)
    assert [r["reduce_scatter"] for r in coll] == [[1.0, 1.0], [3.0, 3.0]]
    assert coll[0]["reduce"] == [3.0, 3.0]
    assert [r["scatter"] for r in coll] == [[0.0, 0.0], [7.0, 7.0]]
    assert [r["alltoall"] for r in coll] == [[[0], [100]], [[1], [101]]]
    assert coll[1]["recv"] == [42.0]
    assert [r["group"] for r in coll] == [([2.0], 2, 0), ([2.0], 2, 1)]
    # the recorder saw them, in program order on every rank
    assert coll[0]["events"] == coll[1]["events"]


def _mlp_weights():
    rng = np.random.RandomState(0)
    return {"0.weight": rng.randn(6, 8).astype(np.float32),
            "0.bias": rng.randn(8).astype(np.float32) * 0.1,
            "1.weight": rng.rand(8).astype(np.float32) + 0.5,
            "1.bias": rng.randn(8).astype(np.float32) * 0.1,
            "1._mean": np.zeros(8, np.float32),
            "1._variance": np.ones(8, np.float32),
            "2.weight": rng.randn(8, 3).astype(np.float32),
            "2.bias": rng.randn(3).astype(np.float32) * 0.1}


def test_data_parallel_with_sync_batch_norm_matches_one_process(world):
    """Two ranks with half the rows each against one process with the
    whole batch: the outputs (the BatchNorm statistics are the whole
    batch's), the averaged gradients, the state after one SGD step."""
    w = _mlp_weights()
    rng = np.random.RandomState(1)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.int64)
    res = world.run("data_parallel", weights=w, x=x, y=y, lr=0.5)
    net = W._mlp(w, sync=False)
    out = net(torch.from_numpy(x))
    cross_entropy(out, torch.from_numpy(y)).backward()
    grads = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
    SGD(0.5, parameters=net.parameters()).step()
    state = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["out"], out.detach().numpy()[
            r * 4:(r + 1) * 4], rtol=1e-5, atol=1e-6)
        assert set(got["grads"]) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert set(got["state"]) == set(state)  # no "_layers." prefix
        for k, v in state.items():
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert got["buckets"] > 1  # a small comm_buffer_size: several


def test_engine_batch_norm_takes_the_global_statistics(world):
    """A plain ``BatchNorm1D`` inside a dp-2 engine normalises with the
    whole batch's statistics (its running ones too): two ranks against
    one process's engine on the global batches."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep

    w = _mlp_weights()
    rng = np.random.RandomState(4)
    batches = [(rng.randn(8, 6).astype(np.float32),
                rng.randint(0, 3, 8).astype(np.int64)) for _ in range(3)]
    res = world.run("engine_batch_norm", weights=w, batches=batches, lr=0.5)
    net = W._mlp(w, sync=False)
    step = ParallelTrainStep(net, cross_entropy,
                             SGD(0.5, parameters=net.parameters()),
                             device="cpu")
    want = [float(step((torch.from_numpy(x),), (torch.from_numpy(y),)))
            for x, y in batches]
    for got in res:
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(got["state"][k], v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_prefetcher_stages_each_ranks_rows(world):
    rng = np.random.RandomState(2)
    batches = [{"ids": rng.randint(0, 9, (4, 6)), "y": rng.randn(4)}
               for _ in range(3)]
    for dp, sp in ((2, 1), (1, 2)):
        res = world.run("prefetch_rows", batches=batches, dp=dp, sp=sp)
        for r in res:
            c = r["coords"]
            rows = slice(c["dp"] * 4 // dp, (c["dp"] + 1) * 4 // dp)
            cols = slice(c["sp"] * 6 // sp, (c["sp"] + 1) * 6 // sp)
            for got, want in zip(r["rows"], batches):
                np.testing.assert_array_equal(got["ids"],
                                              want["ids"][rows, cols])
                # a leaf without a second dimension keeps its rows only
                np.testing.assert_array_equal(got["y"], want["y"][rows])
            assert r["passes_through"]


CFG = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           max_position_embeddings=16, hidden_dropout=0.0,
           attention_dropout=0.0)


def test_fleet_sharding_strategy_trains_as_one_device(world):
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu", seed=5)
    weights = {k: v.detach().numpy().copy()
               for k, v in model.state_dict().items()}
    rng = np.random.RandomState(3)
    batches = [((rng.randint(0, 128, (4, 8)),), (rng.randint(0, 128, (4, 8)),))
               for _ in range(2)]
    res = world.run("fleet_train", weights=weights, cfg=CFG, batches=batches)
    step = ParallelTrainStep(model, model.loss_fn,
                             Adam(1e-3, parameters=model.parameters()),
                             device="cpu")
    want = [float(step(tuple(torch.from_numpy(a) for a in x),
                       tuple(torch.from_numpy(a) for a in y)))
            for x, y in batches]
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert got["zero"] == 2 and got["mesh"] == {
            "dp": 1, "pp": 1, "sharding": 2, "mp": 1, "sp": 1}
        assert got["sharding_group"] == [0, 1]
        assert got["sharding_rank"] == r
        assert "second half" in got["localsgd"]


WORKER = """
import json, os, sys, time
import torch
import paddle_tpu_torch.distributed as dist

dist.init_parallel_env()
r = dist.get_rank()
t = torch.full((4,), float(r + 1))
dist.all_reduce(t)
with open(os.environ["RESULT_FILE"] + f".{r}", "w") as f:
    json.dump({"sum": t.tolist(), "backend": torch.distributed.get_backend(),
               "world": dist.get_world_size(),
               "master": os.environ["MASTER_ADDR"] + ":"
               + os.environ["MASTER_PORT"]}, f)
if os.environ.get("DIE") and r == 1:
    os._exit(3)
if os.environ.get("DIE"):
    time.sleep(120)  # blocked until the supervisor tears the job down
"""


@pytest.mark.parametrize("die", [False, True], ids=["clean", "rank_dies"])
def test_launch_two_processes(tmp_path, die):
    """``launch(nproc_per_node=2, backend='cpu')``: the ranks join one
    gloo world from the launcher's environment and all-reduce; when rank
    1 dies with code 3 the supervisor tears rank 0 down and the job exits
    3."""
    import json
    import time

    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER))
    result = str(tmp_path / "result")
    env = {"PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
           "RESULT_FILE": result, "OMP_NUM_THREADS": "1"}
    if die:
        env["DIE"] = "1"
    t0 = time.monotonic()
    rc = launch(str(script), [], nproc_per_node=2, backend="cpu",
                log_dir=str(tmp_path / "logs"), extra_env=env)
    assert rc == (3 if die else 0)
    assert time.monotonic() - t0 < 60  # torn down, not slept out
    for r in range(2):
        with open(f"{result}.{r}") as f:
            got = json.load(f)
        assert got["sum"] == [3.0] * 4
        assert got["backend"] == "gloo" and got["world"] == 2
        assert got["master"].startswith("127.0.0.1:")


def test_spawn_two_workers(tmp_path):
    path = str(tmp_path / "out")
    dist.spawn(W.spawned, args=(path,), nprocs=2, backend="gloo")
    for r in range(2):
        with open(f"{path}.{r}") as f:
            assert f.read() == "gloo 2 [3.0, 3.0]"


def test_a_rank_of_an_unjoined_world_raises(monkeypatch):
    """A process the launcher made one of several ranks never skips the
    transport: before ``init_parallel_env`` a collective raises."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        dist.all_reduce(torch.ones(1))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    assert dist.all_reduce(torch.ones(1)).tolist() == [1.0]
