"""Training throughput on one card — the port's twin of the repository's
``bench.py`` (GPT-2 345M) and of ``bench_all.py``'s ``bench_bert_dp``
(BERT-base pretraining) and ``bench_input_pipeline``:

    python -m paddle_tpu_torch.bench            # GPT-2 345M
    python -m paddle_tpu_torch.bench bert       # BERT-base
    python -m paddle_tpu_torch.bench pipeline   # the prefetcher on and off

GPT-2 345M: the configuration and loop of ``bench.py`` — 24 layers,
hidden 1024, 16 heads, vocab 50304, dropout 0, batch 8 x 1024 tokens,
bf16 compute with f32 master weights, Adam lr 1e-4 (``multi_precision``),
no recompute; one random batch from seed 0 stays on the device; one
warm-up step, then 3 timed windows of 45 steps, each ending in a sync,
and the median window's tokens/s; ``bench.py``'s JSON keys, with
``vs_baseline`` against the same constant.

BERT-base: ``bench_bert_dp``'s model (``bert_base`` with both dropouts
0), batch 32 x 128 with no attention mask, MLM labels on 15% of the
positions and NSP labels from seed 0, ``AdamW(lr=1e-4,
weight_decay=0.01)``, bf16 compute without master weights; its
``_rate(one, 2, 30)`` loop (2 warm-up steps, 3 windows of 30 steps, the
median window) and its keys (``metric``, ``value`` in samples/s,
``unit``, ``tokens_per_sec``, ``mfu_pct``). The MFU takes
``bench_all``'s FLOPs per token over the H100's own dense bf16 peak.
Before the headline leg, as ``bench_bert_dp`` does, a second engine on a
fresh model fingerprints its state at every step (``fingerprint_every=1``,
the multi-tensor fold of ``ops.tree_reduce``): ``fingerprint_samples_per_
sec``, ``fingerprint_fold_overhead_pct`` (the fold's cost as a share of a
step) and ``fingerprint_overhead_pct`` (that share at the production
interval of 100 steps). ``bench_bert_dp`` runs on a one-device ``mesh``;
meshes wait for the multi-device port, so this twin runs the engine on
the card without one.

The input pipeline: ``bench_input_pipeline``'s configuration — a 3-layer
MLP (1024, 1024, 1024, 10) with ``CrossEntropyLoss`` and Adam lr 1e-3
through ``jit.TrainStep``, 30 batches of 256 x 1024 a pass, each costing
a 30 ms sleep (the source's latency) and a numpy decode (uint8 to f32,
per-row normalisation), and ``float(loss)`` at every step: one warm-up
pass without the prefetcher, then the median of 3 passes without it and
of 3 with ``step.prefetch(batches, depth=2)``; its keys (``value``: the
samples/s with the prefetcher, ``prefetch_off_samples_per_sec``,
``speedup``).

Long context: ``bench_gpt_long_context``'s configuration and legs —
GPT-small (12 layers, hidden 768, 12 heads, vocab 50304,
``max_position_embeddings=8192``, dropout 0) at b = 1, L = 8192, ``Adam(1e-4)``,
bf16 compute on f32 parameters through ``ParallelTrainStep`` with no
recompute, one batch from ``RandomState(0)``: (1) the forced ``blockwise``
tier, ``max(2, iters // 2)`` steps a window; (2) ``PADDLE_TPU_ATTN_POLICY=
bench`` (unless the caller set a policy) with the verdict cache in a
temporary file; (3) the ``remat='auto'`` probe: ``lower_cost('off')``, the
budget pinned to 60% of its peak (``PADDLE_TPU_DEVICE_HBM_BYTES``), then
``remat_policy.resolve``; (4) the headline leg, ``iters = 10`` steps a
window after a telemetry reset. Its keys are the reference's (``metric``,
``value``, ``unit``, ``seq_len``, ``tokens_per_sec_forced_blockwise``,
``tier_ablation_speedup``, ``attn_tier_selected``, ``remat_off_peak_hbm_
bytes``, ``remat_auto_policy``, ``remat_auto_peak_hbm_bytes``, ``mfu_pct``
over the H100's dense bf16 peak, ``vs_baseline``) and ``tier_timings_ms``,
the verdict's timings. The reference's one-device ``mesh`` waits for the
multi-device port. ``--smoke`` is the reference's smoke size (2 layers,
hidden 128, 4 heads, vocab 1024, L = 512, f32, ``remat='full'``, 2 steps a
window) and runs on the CPU:

    python -m paddle_tpu_torch.bench longctx [--smoke]

ResNet-50 through the static graph (BASELINE config #2): ``bench_all``'s
``build_resnet50_train`` and ``bench_resnet50`` as written — ResNet-50
recorded into a ``static.Program`` under ``program_guard`` (bf16 AMP O1,
``Momentum(0.01, 0.9).minimize``), trained by ``Executor.run_steps`` in
windows of 20 steps on device-resident feeds from ``RandomState(0)`` at
b = 128, ``_rate(one, 2, 3)``; the reference's key
``resnet50_static_executor_samples_per_sec_per_chip`` and ``mfu_pct``
(3 x 4.1 GFLOP a sample over the H100's dense bf16 peak). ``--smoke``
(b = 8 at 32², 100 classes, no AMP, no window) runs on the CPU:

    python -m paddle_tpu_torch.bench resnet50 [--smoke]

Serving: ``bench_all``'s ``bench_serving`` and ``bench_decode`` as
written. ``serving`` runs closed-loop streams through the one-shot
``ServingEngine`` over a ``Predictor`` of a 3-layer MLP (each request an
[L, d] activation, L = 128, d = 512; 16 streams x 40 requests, one batch
bucket of 16, 2 warm-up requests a stream) and reports tokens/s
(``ok_per_s * L``), requests/s, latency p50/p99, the batch occupancy p50
and the bucket's warm-up time. ``decode`` serves greedy generation to 8
streams (prompts of 256 tokens from ``RandomState(0)``, 64 new tokens,
4 requests a stream after one warm-up round) from a GPT (vocab 2048,
hidden 256, 4 layers, 8 heads, f32, seed 0) over the paged KV cache:
first with ``spec_k=3`` and a draft (hidden 128, 1 layer, 2 heads, seed
3), then the one-shot baseline (a ``Predictor`` whose ``serving_fn``
recomputes the whole padded context for every token), then plain
continuous batching, the headline; the keys are ``bench_all``'s.
``--smoke`` takes the reference's ``SMOKE`` sizes and runs on the CPU:

    python -m paddle_tpu_torch.bench serving [--smoke]
    python -m paddle_tpu_torch.bench decode [--smoke]

Each prints a line naming its device, then one JSON line. Apart from
the ``--smoke`` runs they need a CUDA card and raise without one.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from .profiler.xla_cost import H100_BF16_DENSE_FLOPS

# bench.py's BASELINE_TOKENS_PER_SEC: 90% of an A100 at 45% training MFU
# on this model (~68k tokens/s), the north star of the whole repository
BASELINE_TOKENS_PER_SEC = 61_000.0


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"paddle_tpu_torch.bench measures {what} on the "
                           "card: CUDA is not available")


def bench_gpt() -> dict:
    from .distributed.fleet.engine import ParallelTrainStep
    from .optimizer import Adam
    from .text.models.gpt import GPTConfig, GPTForCausalLM

    _require_card("GPT-2 345M training")
    config = GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                       max_position_embeddings=1024, hidden_dropout=0.0,
                       attention_dropout=0.0)
    batch, seq, iters, reps = 8, 1024, 45, 3
    model = GPTForCausalLM(config, device="cuda", seed=0)
    opt = Adam(learning_rate=1e-4, parameters=model.parameters(),
               multi_precision=True)
    step = ParallelTrainStep(model, loss_fn=lambda out, lbl: out,
                             optimizer=opt, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, config.vocab_size, (batch, seq))
    labels = np.roll(ids, -1, axis=1)
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))

    loss = step((ids, labels), (labels,))  # warm-up (kernel build)
    float(loss)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step((ids, labels), (labels,))
        float(loss)
        rates.append(batch * seq * iters / (time.perf_counter() - t0))
    tokens_per_sec = sorted(rates)[len(rates) // 2]
    return {
        "metric": "gpt2_345m_train_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec, 2),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(tokens_per_sec / BASELINE_TOKENS_PER_SEC, 4),
    }


def bert_flops_per_token(config) -> float:
    """``bench_all.bench_bert_dp``'s count: 6·N per token with N = 86M
    non-embedding transformer parameters of BERT-base, plus the MLM head
    matmul, 2·h·V forward, times 3."""
    return 6 * 86e6 + 6 * config.hidden_size * config.vocab_size


def _rate(fn, n_warm: int, n_iter: int, reps: int = 3) -> float:
    """``bench_all._rate``: median steps/s of ``reps`` windows of
    ``n_iter`` steps after ``n_warm`` warm-up steps; each window ends by
    reading the last output back (a sync)."""
    for i in range(n_warm):
        out = fn(i)
    _block(out)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(n_iter):
            out = fn(i)
        _block(out)
        rates.append(n_iter / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def _block(out) -> None:
    """Read ``out`` (a loss, or a window's stacked losses) to the host."""
    torch.as_tensor(out).detach().cpu()


# bench_bert_dp's production fingerprint interval: the fold's cost a step
# is divided by it for the amortized overhead
_FP_PRODUCTION_EVERY = 100


def bert_engine(config, fingerprint_every: int = 0, device="cuda"):
    """``bench_bert_dp``'s engine on a fresh BERT-base from seed 0:
    ``AdamW(1e-4, weight_decay=0.01)``, bf16 compute on f32 parameters."""
    from .distributed.fleet.engine import ParallelTrainStep
    from .optimizer import AdamW
    from .text.models.bert import BertForPretraining

    model = BertForPretraining(config, device=device, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    return ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                             device=device, compute_dtype=torch.bfloat16,
                             fingerprint_every=fingerprint_every)


def bert_batch(config, b: int = 32, L: int = 128, device="cuda"):
    """``bench_bert_dp``'s batch from ``RandomState(0)``, on ``device``."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, config.vocab_size, (b, L)).astype(np.int32)
    mlm = np.where(rng.rand(b, L) < 0.15, ids, -100).astype(np.int32)
    nsp = rng.randint(0, 2, b).astype(np.int64)
    return tuple(torch.from_numpy(a).long().to(device)
                 for a in (ids, mlm, nsp))


def bench_bert() -> dict:
    from .text.models.bert import bert_base

    _require_card("BERT-base pretraining")
    config = bert_base(hidden_dropout=0.0, attention_dropout=0.0)
    b, L = 32, 128
    ids, mlm, nsp = bert_batch(config, b, L)
    # the fingerprinting leg first, on its own fresh model (bench_bert_dp's
    # order: it pays any cold-start cost, a conservative bias)
    step_fp = bert_engine(config, fingerprint_every=1)
    sps_fp = _rate(lambda i: step_fp((ids,), (mlm, nsp)), 2, 30) * b
    del step_fp
    torch.cuda.empty_cache()
    step = bert_engine(config)
    sps = _rate(lambda i: step((ids,), (mlm, nsp)), 2, 30) * b
    fold_pct = (sps / sps_fp - 1.0) * 100
    return {"metric": "bert_base_dp_pretrain_samples_per_sec_per_chip",
            "value": round(sps, 2), "unit": "samples/sec",
            "tokens_per_sec": round(sps * L, 2),
            "fingerprint_samples_per_sec": round(sps_fp, 2),
            "fingerprint_fold_overhead_pct": round(fold_pct, 3),
            "fingerprint_overhead_pct": round(
                fold_pct / _FP_PRODUCTION_EVERY, 4),
            "mfu_pct": round(100.0 * sps * L * bert_flops_per_token(config)
                             / H100_BF16_DENSE_FLOPS, 2)}


class InputPipeline:
    """``bench_input_pipeline``'s workload: the MLP's ``TrainStep`` on the
    card (weights from a seed) and its batch source. ``epoch(prefetch)``
    runs one pass and returns its per-step losses (read with ``float``
    at every step, the logging loop's sync)."""

    def __init__(self, b: int = 256, d: int = 1024, n_batches: int = 30,
                 acquire_s: float = 0.030, seed: int = 0, device="cuda"):
        from . import nn
        from .jit.train_step import TrainStep
        from .optimizer import Adam

        gen = torch.Generator().manual_seed(seed)
        net = nn.Sequential(
            nn.Linear(d, d, generator=gen), nn.ReLU(),
            nn.Linear(d, d, generator=gen), nn.ReLU(),
            nn.Linear(d, 10, generator=gen)).to(device)
        opt = Adam(learning_rate=1e-3, parameters=net.parameters())
        self.step = TrainStep(net, nn.CrossEntropyLoss(), opt, device=device)
        rng = np.random.RandomState(0)
        self.payloads = [rng.randint(0, 256, (b, d)).astype(np.uint8)
                         for _ in range(8)]
        self.ys = rng.randint(0, 10, b).astype(np.int64)
        self.b, self.n_batches, self.acquire_s = b, n_batches, acquire_s

    def batches(self):
        for i in range(self.n_batches):
            time.sleep(self.acquire_s)  # the source's latency: a wait
            raw = self.payloads[i % len(self.payloads)]
            x = raw.astype(np.float32) / 255.0
            x = (x - x.mean(axis=1, keepdims=True)) / (
                x.std(axis=1, keepdims=True) + 1e-6)
            yield (x,), (self.ys,)

    def epoch(self, prefetch: bool) -> List[float]:
        it = (self.step.prefetch(self.batches(), depth=2) if prefetch
              else self.batches())
        return [float(self.step(inp, lab)) for inp, lab in it]

    def rate(self, prefetch: bool, reps: int = 3) -> float:
        vals = []
        for _ in range(reps):
            t0 = time.perf_counter()
            self.epoch(prefetch)
            vals.append(self.n_batches * self.b / (time.perf_counter() - t0))
        return sorted(vals)[len(vals) // 2]


def bench_pipeline() -> dict:
    _require_card("the input pipeline")
    run = InputPipeline()
    run.epoch(False)  # warm-up: the kernels' first launches off the clock
    off = run.rate(False)
    on = run.rate(True)
    return {"metric": "input_pipeline_prefetch_samples_per_sec",
            "value": round(on, 2), "unit": "samples/sec",
            "prefetch_off_samples_per_sec": round(off, 2),
            "speedup": round(on / off, 3)}


def longctx_config(smoke: bool = False):
    """``bench_gpt_long_context``'s model and shape: ``(config, b, L,
    iters)``."""
    from .text.models.gpt import GPTConfig

    if smoke:
        return (GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=4, max_position_embeddings=512,
                          hidden_dropout=0.0, attention_dropout=0.0),
                1, 512, 2)
    return (GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                      max_position_embeddings=8192, hidden_dropout=0.0,
                      attention_dropout=0.0), 1, 8192, 10)


def longctx_engine(config, smoke: bool = False, remat=None, device="cuda"):
    """The leg's engine on a fresh model from seed 0: ``Adam(1e-4)``; at
    full size bf16 compute on f32 parameters and no recompute, at the
    smoke size f32 and ``remat='full'``."""
    from .distributed.fleet.engine import ParallelTrainStep
    from .optimizer import Adam
    from .text.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(config, device=device, seed=0)
    opt = Adam(learning_rate=1e-4, parameters=model.parameters())
    return ParallelTrainStep(
        model, loss_fn=model.loss_fn, optimizer=opt, device=device,
        remat=("full" if smoke else "off") if remat is None else remat,
        compute_dtype=None if smoke else torch.bfloat16)


def longctx_batch(config, b: int, L: int, device="cuda"):
    """The leg's batch from ``RandomState(0)``: ids and the ids shifted
    by one."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, config.vocab_size, (b, L)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


def longctx_flops_per_token(config, L: int) -> float:
    """``bench_gpt_long_context``'s count: 6 x the matmul parameters
    (12·n·h² + V·h) plus the causal attention term 6·L·h·n."""
    n_mat = (12 * config.num_layers * config.hidden_size ** 2
             + config.vocab_size * config.hidden_size)
    return 6 * n_mat + 6 * L * config.hidden_size * config.num_layers


_LONGCTX_ENV = ("PADDLE_TPU_ATTN_POLICY", "PADDLE_TPU_ATTN_TIER_CACHE",
                "PADDLE_TPU_DEVICE_HBM_BYTES")


def bench_longctx(smoke: bool = False, headline_hook=None) -> dict:
    """The four legs (module docstring). ``headline_hook(engine, ids,
    labels)``, when given, is called with the headline leg's engine after
    its windows (the smoke test reads launches and losses there)."""
    from .ops import remat_policy, tier_policy
    from .profiler.telemetry import get_telemetry

    device = "cpu" if smoke else "cuda"
    if not smoke:
        _require_card("GPT-small long-context training")
    config, b, L, iters = longctx_config(smoke)
    ids, labels = longctx_batch(config, b, L, device)

    def measure(engine, n_iter):
        return _rate(lambda i: engine((ids,), (labels,)), 1, n_iter) * b * L

    def release():
        if device == "cuda":
            torch.cuda.empty_cache()

    tel = get_telemetry()
    saved_env = {k: os.environ.get(k) for k in _LONGCTX_ENV}
    scratch = tempfile.TemporaryDirectory(prefix="paddle_tpu_torch_bench_")
    try:
        # the tier ablation leg: the forced streaming floor
        os.environ["PADDLE_TPU_ATTN_POLICY"] = "blockwise"
        engine = longctx_engine(config, smoke, device=device)
        abl_tps = measure(engine, max(2, iters // 2))
        del engine
        release()

        # measured tier selection for the remaining legs
        os.environ["PADDLE_TPU_ATTN_POLICY"] = (
            saved_env["PADDLE_TPU_ATTN_POLICY"] or "bench")
        if tier_policy.cache_path() is None:
            os.environ["PADDLE_TPU_ATTN_TIER_CACHE"] = os.path.join(
                scratch.name, "attn_tiers.json")
        tier_policy.reset()  # in-memory verdicts; the file decides

        # the remat control-loop probe
        probe = longctx_engine(config, smoke, remat="auto", device=device)
        remat_cols = {}
        off = probe.lower_cost("off", (ids,), (labels,))
        if off is not None:
            os.environ["PADDLE_TPU_DEVICE_HBM_BYTES"] = str(
                max(int(off["peak_hbm_bytes"] * 0.6), 1))
            chosen = remat_policy.resolve(
                "fleet.train_step",
                lambda p: probe.lower_cost(p, (ids,), (labels,)),
                device=device)
            remat_cols = {
                "remat_off_peak_hbm_bytes": off["peak_hbm_bytes"],
                "remat_auto_policy": chosen,
                "remat_auto_peak_hbm_bytes": tel.scalars().get(
                    "gauge/remat/peak_hbm/fleet.train_step"),
                "remat_budget_bytes": remat_policy.budget_bytes(device)}
            del os.environ["PADDLE_TPU_DEVICE_HBM_BYTES"]
        del probe
        release()

        # the headline leg: measured tier selection, clean telemetry
        tel.reset()
        engine = longctx_engine(config, smoke, device=device)
        tps = measure(engine, iters)
        if headline_hook is not None:
            headline_hook(engine, ids, labels)
        del engine
        release()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        scratch.cleanup()
    d = config.hidden_size // config.num_heads
    tier_id = tel.scalars().get(
        f"gauge/attn/tier.{tier_policy.gauge_key(L, d, True)}")
    id_to_name = {v: k for k, v in tier_policy.TIER_IDS.items()}
    dtype = torch.float32 if smoke else torch.bfloat16
    verdict = tier_policy.registry().verdict(tier_policy.make_key(
        config.num_heads, L, d, dtype, True, device)) or {}
    out = {"metric": "gpt_small_L8192_longctx_train_tokens_per_sec",
           "value": round(tps, 1), "unit": "tokens/sec", "seq_len": L,
           "tokens_per_sec_forced_blockwise": round(abl_tps, 1),
           "tier_ablation_speedup": round(tps / abl_tps, 3),
           "attn_tier_selected": id_to_name.get(tier_id, "unknown"),
           "tier_timings_ms": verdict.get("timings_ms")}
    out.update(remat_cols)
    if not smoke:
        flops_tok = longctx_flops_per_token(config, L)
        out["mfu_pct"] = round(100.0 * tps * flops_tok
                               / H100_BF16_DENSE_FLOPS, 2)
        # bench.py's north-star methodology: 90% of an A100 at a typical
        # 45% training MFU (312 TF/s bf16 peak)
        out["vs_baseline"] = round(
            tps / (0.9 * 0.45 * 312e12 / flops_tok), 4)
    return out


# ResNet-50 at 224²: ~4.1 GFLOP a sample forward, ~3x that with the
# backward (bench_all.py's reckoning)
RESNET50_FLOPS_PER_SAMPLE = 3 * 4.1e9


def build_resnet50_train(smoke: bool = False, window: Optional[int] = None,
                         device="cuda"):
    """``bench_all.build_resnet50_train``: ResNet-50 recorded into a
    ``static.Program`` (``data`` x [None, 3, 224, 224] and y [None, 1],
    the model and ``cross_entropy`` under ``amp.auto_cast(dtype=
    "bfloat16")``, ``Momentum(0.01, 0.9).minimize(loss)``), ``exe.run``
    of the startup program, and device-resident feeds from
    ``RandomState(0)`` at b = 128. ``step(i)`` runs one ``Executor.run``,
    or with ``window`` one ``run_steps`` of that many steps
    (``return_numpy=False``), and returns the loss fetch. ``smoke``: b = 8
    at 32² with 100 classes and no AMP. Returns ``(step, b, parts)``,
    parts holding the program, executor, loss variable and model."""
    from . import amp, static
    from .nn.functional import cross_entropy
    from .optimizer import Momentum
    from .vision.models import resnet50

    dev = torch.device(device)
    b = 8 if smoke else 128
    size = 32 if smoke else 224
    classes = 100 if smoke else 1000
    main, start = static.Program(), static.Program()
    with static.program_guard(main, start):
        x = static.data("x", [None, 3, size, size], "float32", device=dev)
        y = static.data("y", [None, 1], "int64", device=dev)
        model = resnet50(num_classes=classes, seed=0, device=dev)
        with amp.auto_cast(enable=not smoke, dtype="bfloat16"):
            logits = model(x)
            loss = cross_entropy(logits, y.reshape(-1))
        Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    exe = static.Executor(dev)
    exe.run(start)
    rng = np.random.RandomState(0)
    xv = torch.from_numpy(rng.randn(b, 3, size, size).astype(
        np.float32)).to(dev)
    yv = torch.from_numpy(rng.randint(0, classes, (b, 1)).astype(
        np.int64)).to(dev)
    feed = {"x": xv, "y": yv}
    if window:
        def step(_i=None):
            return exe.run_steps(main, feed=feed, fetch_list=[loss],
                                 n_steps=window, return_numpy=False)[0]
    else:
        def step(_i=None):
            return exe.run(main, feed=feed, fetch_list=[loss],
                           return_numpy=False)[0]
    return step, b, {"program": main, "executor": exe, "loss": loss,
                     "model": model, "feed": feed}


def bench_resnet50(smoke: bool = False) -> dict:
    """``bench_all.bench_resnet50``: ``_rate(one, 2, 3) * b * window``
    over windows of 20 steps (``smoke``: single runs on the CPU)."""
    if not smoke:
        _require_card("ResNet-50 training")
    window = None if smoke else 20
    one, b, _ = build_resnet50_train(smoke, window,
                                     "cpu" if smoke else "cuda")
    sps = _rate(one, 2, 3) * b * (window or 1)
    out = {"metric": "resnet50_static_executor_samples_per_sec_per_chip",
           "value": round(sps, 2), "unit": "samples/sec"}
    if not smoke:
        out["mfu_pct"] = round(100.0 * sps * RESNET50_FLOPS_PER_SAMPLE
                               / H100_BF16_DENSE_FLOPS, 2)
    return out


def bench_serving(smoke: bool = False) -> dict:
    """``bench_all.bench_serving``: closed-loop request latency and
    throughput at N synchronous streams through the one-shot
    ``ServingEngine``, one batch bucket sized to the concurrency. The
    closed loop never sheds: any non-OK status raises."""
    from .inference import Config, create_predictor
    from .inference.serving import ServeConfig, ServingEngine, run_streams
    from .nn import Linear, ReLU, Sequential
    from .profiler.telemetry import get_telemetry
    from .static.program import InputSpec

    if not smoke:
        _require_card("serving")
    device = "cpu" if smoke else "cuda"
    L, d = (16, 64) if smoke else (128, 512)
    streams = 2 if smoke else 16
    per_stream = 4 if smoke else 40
    gen = torch.Generator().manual_seed(0)
    net = Sequential(Linear(d, d, device=device, generator=gen), ReLU(),
                     Linear(d, d, device=device, generator=gen), ReLU(),
                     Linear(d, d, device=device, generator=gen))
    net.eval()
    cfg = Config()
    if smoke:
        cfg.disable_gpu()
    cfg.set_layer(net, [InputSpec([None, L, d], "float32", "x")])
    engine = ServingEngine(create_predictor(cfg), ServeConfig(
        capacity=4 * streams, buckets=(streams,)))
    engine.start()  # warm-up: the bucket's shape runs before the clock
    rng = np.random.RandomState(0)
    xs = rng.randn(32, L, d).astype(np.float32)
    try:
        run_streams(engine, streams, 2, lambda k: [xs[k % len(xs)]])  # warm
        out = run_streams(engine, streams, per_stream,
                          lambda k: [xs[k % len(xs)]])
    finally:
        acct = engine.shutdown()
    n = streams * per_stream
    if acct["unaccounted"] or acct["double_terminal"] \
            or out["by_status"].get("ok", 0) != n:
        raise AssertionError(
            f"closed-loop serving shed or lost requests: {out['by_status']}, "
            f"unaccounted={acct['unaccounted']}, "
            f"double_terminal={acct['double_terminal']}")
    occ = get_telemetry().hist_summary("serve/batch_occupancy") or {}
    return {"metric": "serving_closed_loop_tokens_per_sec",
            "value": round(out["ok_per_s"] * L, 1), "unit": "tokens/sec",
            "streams": streams, "tokens_per_request": L,
            "requests_per_sec": round(out["ok_per_s"], 2),
            "p50_ms": round(out["p50_ms"], 3),
            "p99_ms": round(out["p99_ms"], 3),
            "batch_occupancy_p50": round(occ.get("p50", 0.0), 3),
            "warmup_compile_ms": round(engine.warmup_ms[streams], 1)}


def decode_setup(smoke: bool = False) -> dict:
    """``bench_decode``'s workload: the target and draft GPTs (f32, seeds
    0 and 3), the 8 prompts, the sizes (``P`` prompt tokens, ``T`` new
    tokens, ``per_stream`` timed requests a stream, ``Lmax``) and
    ``serve_cfg(spec_k=0)``, the engines' ``TokenServeConfig``."""
    from .inference.serving import TokenServeConfig
    from .text.models.gpt import GPTConfig, GPTForCausalLM

    device = "cpu" if smoke else "cuda"
    streams = 8
    if smoke:
        P, T, per_stream = 48, 16, 2
        mcfg = dict(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4)
    else:
        P, T, per_stream = 256, 64, 4
        mcfg = dict(vocab_size=2048, hidden_size=256, num_layers=4,
                    num_heads=8)
    Lmax = P + T
    model = GPTForCausalLM(GPTConfig(
        max_position_embeddings=Lmax, hidden_dropout=0.0,
        attention_dropout=0.0, **mcfg), device=device, seed=0).eval()
    draft = GPTForCausalLM(GPTConfig(
        vocab_size=mcfg["vocab_size"], hidden_size=mcfg["hidden_size"] // 2,
        num_layers=1, num_heads=2, max_position_embeddings=Lmax,
        hidden_dropout=0.0, attention_dropout=0.0), device=device,
        seed=3).eval()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, mcfg["vocab_size"], P).astype(np.int32)
               for _ in range(streams)]
    bs = 16
    kv_blocks = streams * (Lmax // bs + 1) + 8

    def serve_cfg(spec_k=0):
        return TokenServeConfig(
            capacity=4 * streams, decode_buckets=(1, 2, 4, 8),
            max_running=streams, prefill_chunk=min(P, 32),
            kv_blocks=kv_blocks, kv_block_size=bs, max_seq_len=Lmax,
            spec_k=spec_k)

    return dict(device=device, streams=streams, P=P, T=T,
                per_stream=per_stream, Lmax=Lmax, model=model, draft=draft,
                prompts=prompts, serve_cfg=serve_cfg)


def bench_decode(smoke: bool = False) -> dict:
    """``bench_all.bench_decode``: greedy generation at 8 streams through
    decode-step continuous batching over the paged KV cache, against the
    one-shot baseline (a Predictor recomputing the full prefix every
    token) and with speculative decoding (a draft proposing k=3). The
    spec and baseline legs run first, the headline leg last."""
    from .inference import Config, create_predictor
    from .inference.serving import TokenServingEngine, run_generation_streams
    from .profiler.telemetry import get_telemetry
    from .static.program import InputSpec

    if not smoke:
        _require_card("decode serving")
    w = decode_setup(smoke)
    device, streams, P, T = w["device"], w["streams"], w["P"], w["T"]
    per_stream, Lmax, model = w["per_stream"], w["Lmax"], w["model"]
    prompts, serve_cfg = w["prompts"], w["serve_cfg"]

    def run_leg(engine):
        engine.start()
        try:
            run_generation_streams(  # warm: every step shape has run
                engine, streams, 1,
                lambda k: prompts[k % streams], max_new_tokens=4)
            out = run_generation_streams(
                engine, streams, per_stream,
                lambda k: prompts[k % streams], max_new_tokens=T)
        finally:
            acct = engine.shutdown()
        want_ok = streams * (per_stream + 1)  # warm + timed rounds
        if acct["unaccounted"] or acct["double_terminal"] \
                or engine.kv_accounting()["leaked_blocks"] \
                or acct["by_status"].get("ok", 0) != want_ok:
            raise AssertionError(f"decode bench lost requests or blocks: "
                                 f"{acct}, {engine.kv_accounting()}")
        return out

    tel = get_telemetry()
    # leg 1: speculative decoding
    spec = run_leg(TokenServingEngine(model, serve_cfg(spec_k=3),
                                      device=device, draft_model=w["draft"]))
    accept = tel.snapshot()["gauges"].get("serve/spec_accept_rate", 0.0)

    # leg 2: the one-shot baseline — a Predictor over the full padded
    # context, recomputing the whole prefix for every generated token
    # (all streams batched per step)
    cfg = Config()
    if smoke:
        cfg.disable_gpu()
    cfg.set_layer(model, [InputSpec([None, Lmax], "int64", "ids")])
    raw_fn = create_predictor(cfg).serving_fn()

    def serving_logits(arr):
        out = raw_fn(arr)
        return (out[0] if isinstance(out, (list, tuple)) else out) \
            .float().cpu().numpy()

    ids = np.zeros((streams, Lmax), np.int64)
    for s in range(streams):
        ids[s, :P] = prompts[s]
    serving_logits(ids)  # warm-up off the clock
    t0 = time.perf_counter()
    n_base_tokens = 0
    for _ in range(per_stream):
        cur = ids.copy()
        ln = P
        for _ in range(T):
            logits = serving_logits(cur)
            cur[:, ln] = logits[:, ln - 1].argmax(-1)
            ln += 1
            n_base_tokens += streams
    oneshot_tps = n_base_tokens / (time.perf_counter() - t0)

    # leg 3 (last, the headline): plain continuous batching; evictions
    # are this leg's own (the counters are process-wide)
    ev0 = tel.counter_value("serve/kv_evictions")
    out = run_leg(TokenServingEngine(model, serve_cfg(), device=device))
    evictions = tel.counter_value("serve/kv_evictions") - ev0
    return {"metric": "decode_serving_tokens_per_sec",
            "value": round(out["tokens_per_s"], 1), "unit": "tokens/sec",
            "streams": streams, "prompt_len": P, "max_new_tokens": T,
            "oneshot_tokens_per_sec": round(oneshot_tps, 1),
            "continuous_batching_speedup":
                round(out["tokens_per_s"] / max(oneshot_tps, 1e-9), 3),
            "spec_tokens_per_sec": round(spec["tokens_per_s"], 1),
            "spec_accept_rate": round(float(accept), 4),
            "ttft_p50_ms": round(out.get("ttft_p50_ms", 0.0), 3),
            "ttft_p99_ms": round(out.get("ttft_p99_ms", 0.0), 3),
            "tpot_p50_ms": round(out.get("tpot_p50_ms", 0.0), 3),
            "tpot_p99_ms": round(out.get("tpot_p99_ms", 0.0), 3),
            "kv_evictions": int(evictions)}


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the bench named by ``argv[0]`` (``gpt``, the default, ``bert``,
    ``pipeline``, ``longctx``, ``resnet50``, ``serving`` or ``decode``,
    the last four with ``--smoke``) and print its result."""
    argv = list(argv or [])
    smoke = "--smoke" in argv
    argv = [a for a in argv if a != "--smoke"]
    which = argv[0] if argv else "gpt"
    benches = {"gpt": bench_gpt, "bert": bench_bert,
               "pipeline": bench_pipeline,
               "longctx": lambda: bench_longctx(smoke),
               "resnet50": lambda: bench_resnet50(smoke),
               "serving": lambda: bench_serving(smoke),
               "decode": lambda: bench_decode(smoke)}
    smokes = ("longctx", "resnet50", "serving", "decode")
    if which not in benches or (smoke and which not in smokes):
        raise SystemExit(f"usage: python -m paddle_tpu_torch.bench "
                         f"[{'|'.join(benches)}] [--smoke "
                         f"({', '.join(smokes)})]")
    result = benches[which]()
    print("device: " + ("cpu" if smoke else torch.cuda.get_device_name(0)))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
