"""The multi-device engine across cards (NCCL between processes), against
one card: ``distributed.launch`` starts one rank a card (2 to 4 cards),
each rank joins the world on ``cuda:LOCAL_RANK`` and trains GPT-2 345M's
widths at 2 layers in bf16 with Adam's f32 masters, on the global batch
that one card also trains on in this process:

- data parallelism with ZeRO-2 over a (n/2 dp, 2 sharding) mesh at 8 x
  1024: step 1's loss within 1e-5 of one card's (the same rows, two
  means averaged), steps 2-3 within 2^-7 (the bf16 gradients are summed
  across cards in another order);
- sequence parallelism over an sp axis of all n cards at 1 x 8192: each
  card holds 8192 / n positions and the attention runs as the ring over
  NCCL; every step within 2^-7 (each hop's bf16 output is rounded before
  the f32 merge). After the steps, the L2 norms of the loss's gradient
  (all of it, and the layers' qkv weights' q, k and v columns, which it
  reaches only through the ring's dQ, dK and dV) within 2^-7 of one
  card's: the loss at a random init barely depends on the attention,
  these norms do.

Each leg also reports its step p50 (CUDA events) beside one card's.
Marked ``cuda``; it skips with fewer than two cards. It imports no
JAX."""
import contextlib
import json
import math
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP1_RTOL = 1e-5
STEP_RTOL = 2.0 ** -7
GPT = dict(vocab_size=50304, hidden_size=1024, num_layers=2, num_heads=16,
           max_position_embeddings=8192, hidden_dropout=0.0,
           attention_dropout=0.0)
LEGS = {"zero2": dict(batch=(8, 1024), steps=3, timed=5),
        "sp": dict(batch=(1, 8192), steps=2, timed=3)}

WORKER = """
import json, os, sys
import numpy as np, torch
sys.path.insert(0, os.environ["MC_REPO"])
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.parallel import world_device
from paddle_tpu_torch.distributed.fleet.mesh_utils import init_mesh
import test_torch_multicard as mc

dist.init_parallel_env()
n = dist.get_world_size()
out = {}
for leg in json.loads(os.environ["MC_LEGS"]):
    mesh = (init_mesh((n // 2, 2), ("dp", "sharding")) if leg == "zero2"
            else init_mesh((1, n), ("dp", "sp")))
    kw = ({"zero_stage": 2} if leg == "zero2" else {"sp_axis": "sp"})
    out[leg] = mc.train(leg, world_device(),
                        json.loads(os.environ.get("MC_GPT", "null")),
                        json.loads(os.environ.get("MC_SHAPES", "null")),
                        mesh=mesh, **kw)
if dist.get_rank() == 0:
    with open(os.environ["MC_RESULT"], "w") as f:
        json.dump(out, f)
"""


def batch(shape, vocab, device):
    ids = np.random.RandomState(0).randint(0, vocab, shape)
    ids = torch.from_numpy(ids).to(device)
    return ids, torch.roll(ids, -1, dims=1)


def train(leg, device, gpt=None, shapes=None, **engine):
    """One leg's losses and step p50 (ms) on ``device`` (``engine``: the
    mesh options, none for one card; ``gpt`` and ``shapes`` replace
    ``GPT`` and the legs' batch shapes, for a small run)."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**(gpt or GPT))
    model = GPTForCausalLM(cfg, device=device, seed=4)
    opt = Adam(1e-4, parameters=model.parameters(), multi_precision=True)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt,
                             device=device, compute_dtype=torch.bfloat16,
                             **engine)
    shape = tuple((shapes or {}).get(leg) or LEGS[leg]["batch"])
    ids, labels = batch(shape, cfg.vocab_size, device)
    losses = [float(step((ids, labels), (labels,)))
              for _ in range(LEGS[leg]["steps"])]
    sp = engine.get("sp_axis")
    norms = (grad_norms(model, ids, labels,
                        engine["mesh"].group(sp) if sp else None)
             if leg == "sp" else None)
    ms = []
    if device.type == "cuda":
        for _ in range(LEGS[leg]["timed"]):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            step((ids, labels), (labels,))
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    return {"losses": losses, "grad_norms": norms,
            "step_ms_p50": sorted(ms)[len(ms) // 2] if ms else None}


def grad_norms(model, ids, labels, group=None):
    """The L2 norms of the loss's gradient at the model's parameters as
    the engine leaves them (bf16): all of it, and the layers' qkv weights'
    q, k and v columns (``{"all", "q", "k", "v"}``). Over a
    ring ``group`` each rank takes its slice of the positions, the
    attention runs as the ring (``ring_scope``) and the gradients are
    averaged over the group, as the engine's step does."""
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.ops.attention import ring_scope

    scope = contextlib.nullcontext()
    if group is not None:
        c = ids.shape[1] // group.nranks
        sl = slice(group.rank * c, (group.rank + 1) * c)
        ids, labels = ids[:, sl], labels[:, sl]
        scope = ring_scope(group)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    with scope:
        loss = model(ids, labels).float()
        grads = torch.autograd.grad(loss, [p for _, p in named])
    sq = {"all": 0.0, "q": 0.0, "k": 0.0, "v": 0.0}
    for (name, _), g in zip(named, grads):
        g = g.float()
        if group is not None:
            comm.all_reduce(g, op=comm.ReduceOp.AVG, group=group)
        sq["all"] += float(g.pow(2).sum())
        if name.endswith("attn.qkv.weight"):  # [h, 3h]: q, k, v columns
            for part, t in zip("qkv", g.chunk(3, dim=1)):
                sq[part] += float(t.pow(2).sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def run_world(tmp_path, n, backend=None, legs=tuple(LEGS), gpt=None,
              shapes=None):
    """The legs in a launched world of ``n`` ranks; rank 0's results."""
    from paddle_tpu_torch.distributed.launch import launch

    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER))
    result = tmp_path / "result.json"
    env = {"MC_REPO": _REPO, "MC_RESULT": str(result),
           "MC_LEGS": json.dumps(list(legs)),
           "PYTHONPATH": os.pathsep.join([_REPO, os.path.join(_REPO, "tests"),
                                          os.environ.get("PYTHONPATH", "")])}
    if gpt is not None:
        env["MC_GPT"] = json.dumps(gpt)
    if shapes is not None:
        env["MC_SHAPES"] = json.dumps(shapes)
    rc = launch(str(script), [], nproc_per_node=n, backend=backend,
                log_dir=str(tmp_path / "logs"), extra_env=env)
    if rc != 0:
        logs = "".join((tmp_path / "logs" / f"workerlog.{r}").read_text()
                       [-3000:] for r in range(n)
                       if (tmp_path / "logs" / f"workerlog.{r}").exists())
        raise AssertionError(f"launch rc={rc}\n{logs}")
    return json.loads(result.read_text())


def test_multicard_zero2_and_ring_match_one_card(tmp_path):
    n = min(torch.cuda.device_count(), 4) if torch.cuda.is_available() \
        else 0
    if n < 2:
        pytest.skip("needs 2 or more CUDA cards")
    from paddle_tpu_torch.ops import _build

    _build.library()  # built once, before the ranks load it
    got = run_world(tmp_path, n)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()[0]
    one = {leg: train(leg, torch.device("cuda", 0)) for leg in LEGS}
    for leg, res in got.items():
        print(f"{leg} on {n} cards ({smi}): losses {res['losses']}, step "
              f"p50 {res['step_ms_p50']:.2f} ms; one card: losses "
              f"{one[leg]['losses']}, step p50 "
              f"{one[leg]['step_ms_p50']:.2f} ms", file=sys.stderr)
        ref = one[leg]["losses"]
        for i, (a, b) in enumerate(zip(res["losses"], ref)):
            tol = STEP1_RTOL if (leg == "zero2" and i == 0) else STEP_RTOL
            assert abs(a - b) <= tol * abs(b), (leg, i, a, b)
        if leg == "sp":
            print(f"sp gradient norms on {n} cards {res['grad_norms']}, "
                  f"one card {one[leg]['grad_norms']}", file=sys.stderr)
            for k, b in one[leg]["grad_norms"].items():
                a = res["grad_norms"][k]
                assert abs(a - b) <= STEP_RTOL * abs(b), (leg, k, a, b)


pytestmark = pytest.mark.cuda
