"""Training throughput on one card — the port's twin of the repository's
``bench.py`` (GPT-2 345M) and of ``bench_all.py``'s ``bench_bert_dp``
(BERT-base pretraining):

    python -m paddle_tpu_torch.bench          # GPT-2 345M
    python -m paddle_tpu_torch.bench bert     # BERT-base

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

Each prints a line naming the card, then one JSON line. They need a CUDA
card and raise without one.
"""
from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

# bench.py's BASELINE_TOKENS_PER_SEC: 90% of an A100 at 45% training MFU
# on this model (~68k tokens/s), the north star of the whole repository
BASELINE_TOKENS_PER_SEC = 61_000.0
# NVIDIA's data sheet for the H100 SXM: dense bf16 tensor-core peak at its
# 700 W power limit
H100_BF16_DENSE_FLOPS = 989e12


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
    reading the last loss back (a sync)."""
    for i in range(n_warm):
        out = fn(i)
    float(out)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(n_iter):
            out = fn(i)
        float(out)
        rates.append(n_iter / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def bench_bert() -> dict:
    from .distributed.fleet.engine import ParallelTrainStep
    from .optimizer import AdamW
    from .text.models.bert import BertForPretraining, bert_base

    _require_card("BERT-base pretraining")
    config = bert_base(hidden_dropout=0.0, attention_dropout=0.0)
    b, L = 32, 128
    rng = np.random.RandomState(0)
    ids = rng.randint(0, config.vocab_size, (b, L)).astype(np.int32)
    mlm = np.where(rng.rand(b, L) < 0.15, ids, -100).astype(np.int32)
    nsp = rng.randint(0, 2, b).astype(np.int64)
    ids, mlm, nsp = (torch.from_numpy(a).long().cuda()
                     for a in (ids, mlm, nsp))
    model = BertForPretraining(config, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    step = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                             compute_dtype=torch.bfloat16)
    sps = _rate(lambda i: step((ids,), (mlm, nsp)), 2, 30) * b
    return {"metric": "bert_base_dp_pretrain_samples_per_sec_per_chip",
            "value": round(sps, 2), "unit": "samples/sec",
            "tokens_per_sec": round(sps * L, 2),
            "mfu_pct": round(100.0 * sps * L * bert_flops_per_token(config)
                             / H100_BF16_DENSE_FLOPS, 2)}


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the bench named by ``argv[0]`` (``gpt``, the default, or
    ``bert``) and print its result."""
    which = argv[0] if argv else "gpt"
    benches = {"gpt": bench_gpt, "bert": bench_bert}
    if which not in benches:
        raise SystemExit(f"usage: python -m paddle_tpu_torch.bench "
                         f"[{'|'.join(benches)}]")
    result = benches[which]()
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
