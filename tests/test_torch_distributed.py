"""The port's multi-device ``ParallelTrainStep`` against the reference's,
on the CPU: the port in a gloo world of 4 ranks (``torch_dist_world``,
one world for the module), the reference in this process on 4 devices of
its virtual CPU mesh, with the same weights (``get_params``) and global
batches. The reference's own tolerances (``tests/test_distributed.py``):
dp losses rtol 2e-4, parameters after 3 steps rtol 1e-3 atol 1e-5, ZeRO
rtol 3e-4.

Cases: data parallelism at dp 4 and at dp 2 (with a replica axis), ZeRO
1-3 over sharding = 2 (and its specs, shards, snapshot round trip and
``sync_to_layer``), the global-norm clip under ZeRO, GPT tiny with
``sp_axis`` at sp = 2 (ring attention, positions offset by the rank),
BERT's masked MLM loss at dp = 2 with a different number of masked
positions on each rank, a NaN on one rank skipping the step on every
rank, the fingerprint the same on every rank and equal to the
reference's, and the options a mesh engine refuses."""
import importlib

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.text.models import bert as jbert
from paddle_tpu.text.models import gpt as jgpt
import torch_threads  # noqa: F401  (one torch thread a worker)
from torch_dist_world import World

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")
jsan = importlib.import_module("paddle_tpu.core.sanitizer")

DP_LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
ZERO_RTOL = 3e-4
STEPS = 3
GPT_CFG = dict(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4,
               max_position_embeddings=32, hidden_dropout=0.0,
               attention_dropout=0.0, use_flash_attention=False)
BERT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=1, num_heads=2,
                intermediate_size=128, max_position_embeddings=32,
                hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("world4")))
    yield w
    w.close()


def _gpt_batches(n=STEPS, bs=8, seq=16):
    out = []
    for i in range(n):
        rng = np.random.RandomState(i)
        x = rng.randint(0, GPT_CFG["vocab_size"], (bs, seq)).astype(np.int64)
        y = rng.randint(0, GPT_CFG["vocab_size"], (bs, seq)).astype(np.int64)
        out.append(((x,), (y,)))
    return out


def _bert_batches(n=2, bs=8, seq=16):
    """MLM labels on 60% of the positions of the first half of the batch
    and 10% of the second: the two dp ranks count different numbers."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(10 + i)
        ids = rng.randint(0, BERT_CFG["vocab_size"], (bs, seq))
        rate = np.where(np.arange(bs) < bs // 2, 0.6, 0.1)[:, None]
        mlm = np.where(rng.rand(bs, seq) < rate, ids, -100)
        nsp = rng.randint(0, 2, bs)
        out.append(((ids.astype(np.int64),),
                    (mlm.astype(np.int64), nsp.astype(np.int64))))
    return out


def _mesh(shape, names):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _np(tree):
    return {k: np.asarray(v, dtype=np.float32) for k, v in tree.items()}


def _reference(kind, opt, mesh, engine, batches, seed=3, snapshot=False):
    """The reference's engine: (weights, losses, params, specs[, its
    snapshot and fingerprint])."""
    paddle.seed(seed)
    if kind == "gpt":
        model = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT_CFG))
    else:
        model = jbert.BertForPretraining(jbert.BertConfig(**BERT_CFG))
    weights = _np(jfunc.get_params(model))
    kw = dict(opt.get("kw", {}))
    if opt.get("clip"):
        kw["grad_clip"] = paddle.nn.ClipGradByGlobalNorm(opt["clip"])
    cls = {"sgd": paddle.optimizer.SGD, "adam": paddle.optimizer.Adam,
           "adamw": paddle.optimizer.AdamW}[opt["name"]]
    o = cls(opt["lr"], parameters=model.parameters(), **kw)
    loss_fn = model.loss_fn
    if kind == "gpt":  # the reference's GPT loss takes its Tensors
        T = lambda a: a if isinstance(a, paddle.Tensor) else paddle.Tensor(a)
        loss_fn = lambda out, y: model.loss_fn(T(out), T(y))
    step = JStep(model, loss_fn, o, _mesh(*mesh), **engine)
    losses = [float(np.asarray(step(x, y).numpy())) for x, y in batches]
    out = {"weights": weights, "losses": losses,
           "specs": {n: tuple(s) for n, s in step.param_specs.items()}}
    if snapshot:
        snap = jax.tree_util.tree_map(np.asarray, step.snapshot_state())
        out["snapshot"] = snap
        fp = jsan.tree_fingerprint(snap["params"], snap["opt_state"],
                                   snap["buffers"])
        out["fingerprint"] = {k: np.asarray(v) for k, v in fp.items()}
    step.sync_to_layer()
    out["params"] = _np(jfunc.get_params(model))
    return out


def _port(world, kind, ref, opt, mesh, engine, batches, **kw):
    return world.run("train", kind=kind,
                     cfg=GPT_CFG if kind == "gpt" else BERT_CFG,
                     weights=ref["weights"], opt=opt, mesh=mesh,
                     engine=engine, batches=batches, **kw)


def _assert_params(port_params, ref_params):
    assert set(port_params) == set(ref_params)
    for n, v in ref_params.items():
        np.testing.assert_allclose(port_params[n], v, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)


# -- data parallelism ---------------------------------------------------------------
SGD = {"name": "sgd", "lr": 0.1}


@pytest.fixture(scope="module")
def dp_reference():
    return _reference("gpt", SGD, ((4,), ("dp",)), {}, _gpt_batches())


@pytest.mark.parametrize("mesh,engine,prefetch", [
    (((4,), ("dp",)), {}, False),
    (((2, 2), ("dp", "sharding")), {}, False),
    (((2, 2), ("dp", "extra")), {"extra_batch_axes": ("extra",)}, False),
    (((4,), ("dp",)), {}, True)],
    ids=["dp4", "dp2", "dp2_extra2", "dp4_prefetch"])
def test_dp_losses_and_params_match_reference(world, dp_reference, mesh,
                                              engine, prefetch):
    """dp 4; dp 2 with a sharding axis of replicas (zero_stage 0); dp 2
    with an extra batch axis of 2 (the rows split 4 ways, dp major); dp 4
    through the engine's prefetcher (each rank stages its rows): against
    the reference's dp-4 engine on the same global batches."""
    res = _port(world, "gpt", dp_reference, SGD, mesh, engine,
                _gpt_batches(), want=("params",), prefetch=prefetch)
    for r in res:
        np.testing.assert_allclose(r["losses"], dp_reference["losses"],
                                   rtol=DP_LOSS_RTOL)
        assert r["losses"] == res[0]["losses"]
    _assert_params(res[0]["params"], dp_reference["params"])
    for r in res[1:]:
        for n, v in r["params"].items():
            np.testing.assert_array_equal(v, res[0]["params"][n])


# -- ZeRO -----------------------------------------------------------------------
ADAM = {"name": "adam", "lr": 1e-3}
ZMESH = ((2, 2), ("dp", "sharding"))


@pytest.fixture(scope="module")
def zero_references():
    return {stage: _reference("gpt", ADAM, ZMESH, {"zero_stage": stage},
                              _gpt_batches(), seed=9,
                              snapshot=stage == 3)
            for stage in (1, 2, 3)}


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_matches_reference(world, zero_references, stage):
    ref = zero_references[stage]
    res = _port(world, "gpt", ref, ADAM, ZMESH, {"zero_stage": stage},
                _gpt_batches(), want=("params", "specs", "shards",
                                      "roundtrip", "sync"))
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=ZERO_RTOL)
        # the specs name for name: the reference's param_partition_spec
        assert r["specs"] == ref["specs"]
        # the gathered values are the same on every rank
        for n, v in r["params"].items():
            np.testing.assert_array_equal(v, res[0]["params"][n])
        # a snapshot restored gives the same step again
        first, again, same = r["roundtrip"]
        assert first == again and same
        # sync_to_layer hands the layer the gathered parameters
        for n, v in r["synced"].items():
            np.testing.assert_array_equal(v, r["params"][n])
        assert np.isfinite(r["after_sync"])
    _assert_params(res[0]["params"], ref["params"])
    shards, totals = res[0]["shard_numel"], res[0]["total_numel"]
    # each rank holds 1/2 of every flat buffer: its optimizer state, and
    # at ZeRO-3 its parameters (the full buffer is freed between steps)
    assert all(2 * s == t for s, t in zip(shards, totals))
    assert sum(totals) >= res[0]["param_numel"]
    assert sum(totals) - res[0]["param_numel"] <= 64 * 64
    if stage == 3:
        assert all(b == 0 for r in res for b in r["resident"])
        sharded = [n for n, s in ref["specs"].items() if "sharding" in s]
        assert len(sharded) > 10
    else:
        assert all(b > 0 for r in res for b in r["resident"])


CLIPPED = {"name": "adamw", "lr": 1e-2, "clip": 0.05,
           "kw": {"weight_decay": 0.01}}


def test_zero_global_norm_clip_matches_reference(world):
    """AdamW with a global-norm clip that engages (norm ~1 against 0.05)
    at ZeRO-2: the sum of squares of the ranks' shards is all-reduced
    between the norm pass and the update."""
    batches = _gpt_batches(2)
    ref = _reference("gpt", CLIPPED, ZMESH, {"zero_stage": 2}, batches,
                     seed=5)
    res = _port(world, "gpt", ref, CLIPPED, ZMESH, {"zero_stage": 2},
                batches, want=("params",))
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=ZERO_RTOL)
    _assert_params(res[0]["params"], ref["params"])
    # unclipped, the same steps land elsewhere
    free = _port(world, "gpt", ref, {**CLIPPED, "clip": None}, ZMESH,
                 {"zero_stage": 2}, batches, want=("params",))
    w = "gpt.h.0.attn.qkv.weight"
    assert np.abs(free[0]["params"][w] - ref["params"][w]).max() > 1e-3


# -- sequence parallelism ----------------------------------------------------------
def test_sp_engine_matches_reference(world):
    """GPT tiny with ``sp_axis`` at sp = 2 (and dp 2): each rank holds 8
    of the 16 positions; attention runs as the ring over the sp group and
    the position ids start at rank_in_sp · 8."""
    mesh = ((2, 2), ("dp", "sp"))
    batches = _gpt_batches()
    ref = _reference("gpt", ADAM, mesh, {"sp_axis": "sp"}, batches, seed=4)
    res = _port(world, "gpt", ref, ADAM, mesh, {"sp_axis": "sp"}, batches,
                want=("params",))
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=DP_LOSS_RTOL)
    _assert_params(res[0]["params"], ref["params"])


# -- a loss whose denominator depends on the data ------------------------------------
def test_bert_masked_loss_at_dp2_is_the_global_mean(world):
    """BERT's MLM loss divides by the number of masked positions, which
    differs between the ranks (60% of the first half's positions, 10% of
    the second's): the engine's loss is the mean over the global batch,
    not the average of the ranks' means."""
    mesh = ((2, 2), ("dp", "sharding"))
    opt = {"name": "adamw", "lr": 1e-3, "kw": {"weight_decay": 0.01}}
    batches = _bert_batches()
    mlm = batches[0][1][0]
    counts = [(mlm[:4] >= 0).sum(), (mlm[4:] >= 0).sum()]
    assert counts[0] > 2 * counts[1]
    ref = _reference("bert", opt, mesh, {}, batches, seed=2)
    res = _port(world, "bert", ref, opt, mesh, {}, batches,
                want=("params",))
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=DP_LOSS_RTOL)
    _assert_params(res[0]["params"], ref["params"])


# -- the guards ------------------------------------------------------------------
@pytest.mark.parametrize("stage", [0, 2])
def test_nan_on_one_rank_skips_the_step_on_every_rank(world, dp_reference,
                                                      stage):
    """Rank 1's loss is NaN at step 1: its data group (ranks 1 and 3 of
    the dp x sharding mesh) reports a NaN loss, the other group a finite
    one, and yet every rank keeps every bit of its state, reports the
    same bad leaves (the flags are AND-ed over the world), and trains on
    at step 2."""
    res = world.run("train", kind="gpt", cfg=GPT_CFG,
                    weights=dp_reference["weights"], opt=ADAM, mesh=ZMESH,
                    engine={"zero_stage": stage, "guard_updates": True},
                    batches=_gpt_batches(), nan_at=(1, 1))
    for rank, r in enumerate(res):
        assert r["kept_state"]
        ok, bad = r["finite"][1]
        assert not ok and "loss" in bad
        assert r["finite"][1] == res[0]["finite"][1]
        assert r["finite"][0][0] and r["finite"][2][0]
        assert np.isnan(r["losses"][1]) == (rank in (1, 3))
        assert np.isfinite(r["losses"][2])


def test_fingerprint_is_the_same_on_every_rank_and_the_references(
        world, zero_references):
    """The reference's ZeRO-3 state after 3 steps restored into the
    port's ZeRO-2 engine: every rank folds the gathered state to the
    reference's XOR word and sums."""
    ref = zero_references[3]
    res = _port(world, "gpt", ref, ADAM, ZMESH, {"zero_stage": 2}, [],
                fingerprint_snapshot=ref["snapshot"])
    fps = [r["fingerprint"] for r in res]
    assert all(fp == fps[0] for fp in fps)
    want = ref["fingerprint"]
    assert fps[0]["xor"] == int(want["xor"]) & 0xFFFFFFFF
    for k in ("sum", "abs_sum"):
        np.testing.assert_allclose(fps[0][k], float(want[k]), rtol=1e-5)


def test_mesh_engine_refusals(world):
    res = world.run("engine_refusals")
    for r in res:
        assert r["mp"].startswith("NotImplementedError")
        assert "second half of the multi-device port" in r["mp"]
        assert r["zero_sgd"].startswith("NotImplementedError")
        assert "zero_stage=0" in r["zero_sgd"]
        assert r["bad_axis"].startswith("ValueError")
