"""What the ranks of a ``torch_dist_world.World`` run (torch and the
port only: no jax here). Each function is called on every rank with the
same arguments and returns numpy or plain Python values."""
from __future__ import annotations

import os

import torch

from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed import get_rank, get_world_size
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.distributed.fleet.mesh_utils import init_mesh
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _model(kind, cfg, weights):
    if kind == "gpt":
        from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

        model = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    else:
        from paddle_tpu_torch.text.models.bert import (BertConfig,
                                                       BertForPretraining)

        model = BertForPretraining(BertConfig(**cfg), device="cpu")
    return load_jax_params(model, weights)


def _optimizer(spec, model):
    name, lr = spec["name"], spec["lr"]
    kw = dict(spec.get("kw", {}))
    if spec.get("clip"):
        kw["grad_clip"] = ClipGradByGlobalNorm(spec["clip"])
    cls = {"sgd": SGD, "adam": Adam, "adamw": AdamW}[name]
    return cls(lr, parameters=model.parameters(), **kw)


def train(kind, cfg, weights, opt, mesh, engine, batches, nan_at=None,
          fingerprint_snapshot=None, want=(), prefetch=False):
    """Train ``kind`` ('gpt' or 'bert', its config ``cfg``, the
    reference's ``weights``) over ``mesh`` = (shape, axis names) with
    ``ParallelTrainStep(**engine)``, one step a global batch of
    ``batches`` ((inputs, labels) of numpy arrays). ``nan_at`` = (rank,
    step): that rank's loss is NaN at that step. ``prefetch``: the batches
    go through ``ParallelTrainStep.prefetch`` (each rank stages its rows).
    Returns the losses and what ``want`` names."""
    m = init_mesh(*mesh)
    model = _model(kind, cfg, weights)
    o = _optimizer(opt, model)
    step_no = [0]
    me = get_rank()

    def loss_fn(out, *labels):
        loss = model.loss_fn(out, *labels)
        if nan_at is not None and tuple(nan_at) == (me, step_no[0]):
            loss = loss * float("nan")
        return loss

    e = ParallelTrainStep(model, loss_fn, o, device="cpu", mesh=m, **engine)
    tensors = [(tuple(torch.from_numpy(a) for a in x),
                tuple(torch.from_numpy(a) for a in y)) for x, y in batches]
    if prefetch:
        tensors = list(e.prefetch(iter(tensors)))
    out = {"losses": [], "finite": []}
    before = None
    for i, (x, y) in enumerate(tensors):
        step_no[0] = i
        if nan_at is not None and i == nan_at[1]:
            before = e.snapshot_state()
        out["losses"].append(float(e(x, y)))
        if e._check_nan:
            out["finite"].append(e.last_step_finite())
        if before is not None and i == nan_at[1]:
            after = e.snapshot_state()
            out["kept_state"] = all(
                torch.equal(a, b) for a, b in zip(_leaves(before),
                                                  _leaves(after)))
    if "params" in want:
        snap = e.snapshot_state()
        out["params"] = {n: _np(v) for n, v in snap["params"].items()}
    if "specs" in want:
        out["specs"] = {n: tuple(s) for n, s in e.param_specs.items()}
    if "shards" in want:
        out["shard_numel"] = [bk.S for bk in e._buckets]
        out["total_numel"] = [bk.total for bk in e._buckets]
        out["param_numel"] = sum(sum(bk.numels) for bk in e._buckets)
        out["resident"] = [bk.full.untyped_storage().nbytes()
                           for bk in e._buckets]
    if "roundtrip" in want:
        snap = e.snapshot_state()
        x, y = batches[0]
        run = lambda: float(e(tuple(torch.from_numpy(a) for a in x),
                              tuple(torch.from_numpy(a) for a in y)))
        first = run()
        e.restore_state(snap)
        again = run()
        e.restore_state(snap)
        out["roundtrip"] = (first, again,
                            all(torch.equal(a, b) for a, b in zip(
                                _leaves(snap), _leaves(e.snapshot_state()))))
    if "sync" in want:
        e.sync_to_layer()
        out["synced"] = {n: _np(p) for n, p in model.named_parameters()}
        # and the next step trains on from the flat buffers
        x, y = batches[-1]
        out["after_sync"] = float(e(tuple(torch.from_numpy(a) for a in x),
                                    tuple(torch.from_numpy(a) for a in y)))
    if fingerprint_snapshot is not None:
        e.restore_state(fingerprint_snapshot)
        fp = e.state_fingerprint()
        out["fingerprint"] = {k: float(v) if k != "xor" else
                              int(v) & 0xFFFFFFFF for k, v in fp.items()}
    return out


def _leaves(snap):
    out = [snap["params"][n] for n in sorted(snap["params"])]
    for n in sorted(snap["opt_state"]):
        st = snap["opt_state"][n]
        out += [st[k] for k in sorted(st)]
    return out


def engine_refusals():
    """The options a mesh engine refuses, by message."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    out = {}
    cases = {
        "mp": (((2, 2), ("dp", "mp")), {}, "adam"),
        "zero_sgd": (((2, 2), ("dp", "sharding")), {"zero_stage": 2},
                     "sgd"),
        "bad_axis": (((4,), ("dp",)), {"sp_axis": "sp"}, "adam")}
    for name, (mesh, kw, opt) in cases.items():
        model = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                         num_layers=1, num_heads=2,
                                         max_position_embeddings=16,
                                         hidden_dropout=0.0,
                                         attention_dropout=0.0),
                               device="cpu")
        o = _optimizer({"name": opt, "lr": 0.1}, model)
        try:
            ParallelTrainStep(model, model.loss_fn, o, device="cpu",
                              mesh=init_mesh(*mesh), **kw)
            out[name] = None
        except Exception as e:  # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"
    return out


# -- collectives -----------------------------------------------------------------
def collectives():
    """Every collective of ``communication`` on CPU tensors, with the
    values each rank sees."""
    r, n = get_rank(), get_world_size()
    out = {}
    x = torch.full((3,), float(r + 1))
    for name, op in (("sum", comm.ReduceOp.SUM), ("max", comm.ReduceOp.MAX),
                     ("min", comm.ReduceOp.MIN), ("prod", comm.ReduceOp.PROD),
                     ("avg", comm.ReduceOp.AVG)):
        t = x.clone()
        comm.all_reduce(t, op=op)
        out["all_reduce_" + name] = t.tolist()
    parts = comm.all_gather([], torch.tensor([r, 10 * r]))
    out["all_gather"] = [p.tolist() for p in parts]
    t = torch.zeros(2)
    comm.reduce_scatter(t, [torch.full((2,), float(r + i)) for i in range(n)])
    out["reduce_scatter"] = t.tolist()
    t = torch.full((2,), float(r))
    comm.broadcast(t, src=n - 1)
    out["broadcast"] = t.tolist()
    t = torch.full((2,), float(r + 1))
    comm.reduce(t, dst=0)
    if r == 0:
        out["reduce"] = t.tolist()
    t = torch.zeros(2)
    comm.scatter(t, [torch.full((2,), float(i * 7)) for i in range(n)],
                 src=0)
    out["scatter"] = t.tolist()
    got = comm.alltoall([torch.tensor([100 * r + i]) for i in range(n)])
    out["alltoall"] = [g.tolist() for g in got]
    comm.barrier()
    if n > 1:
        if r == 0:
            comm.send(torch.tensor([42.0]), dst=1)
        elif r == 1:
            t = torch.zeros(1)
            comm.recv(t, src=0)
            out["recv"] = t.tolist()
    out["wait"] = comm.wait(torch.ones(1)).tolist()
    out["objects"] = comm.all_gather_object({"rank": r}, key="k")
    g = comm.new_group(list(range(n)))
    t = torch.ones(1)
    comm.all_reduce(t, group=g)
    out["group"] = (t.tolist(), g.nranks, g.rank)
    m = init_mesh((n,), ("dp",))
    t = torch.ones(1)
    comm.all_reduce(t, group="dp")
    out["axis_group"] = t.tolist()
    out["events"] = [e["name"] for e in comm.collective_events()][-3:]
    del m
    return out


def data_parallel(weights, x, y, lr):
    """``DataParallel`` over a Linear-BatchNorm-Linear net: this rank's
    rows, the gradients averaged in the backward, one SGD step."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import DataParallel
    from paddle_tpu_torch.nn.functional import cross_entropy

    net = _mlp(weights, sync=True)
    dp = DataParallel(net, comm_buffer_size=1e-4)
    r, n = get_rank(), get_world_size()
    rows = x.shape[0] // n
    xs = torch.from_numpy(x[r * rows:(r + 1) * rows])
    ys = torch.from_numpy(y[r * rows:(r + 1) * rows])
    out = dp(xs)
    loss = dp.scale_loss(cross_entropy(out, ys))
    loss.backward()
    dp.apply_collective_grads()
    grads = {k: _np(p.grad) for k, p in dp.named_parameters()}
    opt = SGD(lr, parameters=dp.parameters())
    opt.step()
    return {"out": _np(out), "grads": grads,
            "state": {k: _np(v) for k, v in dp.state_dict().items()},
            "buckets": len(dp._buckets)}


def _mlp(weights, sync):
    from paddle_tpu_torch import nn

    norm = nn.SyncBatchNorm if sync else nn.BatchNorm1D
    net = nn.Sequential(nn.Linear(6, 8, device="cpu"), norm(8, device="cpu"),
                        nn.Linear(8, 3, device="cpu"))
    with torch.no_grad():
        for k, v in net.state_dict().items():
            v.copy_(torch.from_numpy(weights[k]))
    return net


def prefetch_rows(batches, dp, sp):
    """An engine-style ``BatchSharding`` over a (dp, sp) mesh through
    ``DevicePrefetcher``: the rows and positions each rank stages."""
    from paddle_tpu_torch.distributed.fleet._sharded import BatchSharding
    from paddle_tpu_torch.io.prefetch import DevicePrefetcher

    m = init_mesh((dp, sp), ("dp", "sp"))
    sh = BatchSharding(m, ("dp",), "sp")
    got = [{k: _np(v) for k, v in b.items()}
           for b in DevicePrefetcher(iter(batches), depth=2, device="cpu",
                                     sharding=sh)]
    again = sh.local(DevicePrefetcher(iter(batches), device="cpu",
                                      sharding=sh).__iter__().__next__())
    return {"rows": got, "coords": m.coords(),
            "passes_through": all(
                getattr(v, "_ptt_batch_sharding", None) is sh
                for v in again.values())}


def ring(q, k, v, sp, causal):
    """``ring_attention`` over the sp axis of a (4 / sp, sp) mesh on this
    rank's shard of [b, h, L, d] q/k/v (f32), forward and the gradients
    of sum(out²); returns the shard's output and gradients."""
    from paddle_tpu_torch.ops import attention as att

    n = get_world_size()
    m = init_mesh((n // sp, sp), ("dp", "sp"))
    c = m.coords()["sp"]
    L = q.shape[2] // sp
    ts = [torch.from_numpy(a[:, :, c * L:(c + 1) * L].copy()
                           ).requires_grad_() for a in (q, k, v)]
    out = att.ring_attention(*ts, "sp", causal=causal)
    (out.float() ** 2).sum().backward()
    res = {"coord": c, "out": _np(out), "grads": [_np(t.grad) for t in ts]}
    # the dispatch: PADDLE_TPU_ATTN_POLICY=ring over the registered axis
    os.environ["PADDLE_TPU_ATTN_POLICY"] = "ring"
    try:
        att.set_ring_context(m, "sp")
        res["dispatched"] = _np(att.dot_product_attention(
            *(t.detach() for t in ts), causal=causal))
        res["offset"] = att.ring_position_offset(L)
    finally:
        del os.environ["PADDLE_TPU_ATTN_POLICY"]
        att.set_ring_context(None, None)
    return res


def fleet_train(weights, cfg, batches):
    """``fleet.init`` with a sharding strategy (ZeRO-2 over the world),
    ``create_train_step``, the topology's groups and the refusals."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import mesh_utils

    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "sharding_degree": get_world_size()}
    st.sharding = True
    st.sharding_configs = {"stage": 2}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    model = _model("gpt", cfg, weights)
    opt = fleet.distributed_optimizer(
        _optimizer({"name": "adam", "lr": 1e-3}, model))
    step = fleet.create_train_step(model, model.loss_fn, opt)
    losses = [float(step(tuple(torch.from_numpy(a) for a in x),
                         tuple(torch.from_numpy(a) for a in y)))
              for x, y in batches]
    out = {"losses": losses, "zero": step._zero,
           "mesh": dict(mesh_utils.get_mesh().shape),
           "sharding_group": hcg.get_sharding_parallel_group().ranks,
           "sharding_rank": hcg.get_sharding_parallel_rank()}
    st2 = fleet.DistributedStrategy()
    st2.localsgd = True
    fleet.fleet._strategy = st2
    try:
        fleet.create_train_step(model, model.loss_fn, opt)
    except NotImplementedError as e:
        out["localsgd"] = str(e)
    return out


def spawned(path):
    """A ``distributed.spawn`` worker: join, all-reduce, write."""
    from paddle_tpu_torch.distributed import init_parallel_env

    init_parallel_env()
    t = torch.full((2,), float(get_rank() + 1))
    comm.all_reduce(t)
    with open(f"{path}.{get_rank()}", "w") as f:
        f.write(f"{torch.distributed.get_backend()} {get_world_size()} "
                f"{t.tolist()}")


def engine_batch_norm(weights, batches, lr):
    """A Linear-BatchNorm-Linear net (a plain ``BatchNorm1D``) through a
    dp mesh engine: the statistics are the global batch's."""
    from paddle_tpu_torch.nn.functional import cross_entropy

    net = _mlp(weights, sync=False)
    e = ParallelTrainStep(net, cross_entropy, SGD(lr, parameters=
                                                  net.parameters()),
                          device="cpu",
                          mesh=init_mesh((get_world_size(),), ("dp",)))
    losses = [float(e((torch.from_numpy(x),), (torch.from_numpy(y),)))
              for x, y in batches]
    return {"losses": losses,
            "state": {k: _np(v) for k, v in net.state_dict().items()}}
