"""Training throughput of GPT-2 345M on one card — the port's twin of the
repository's ``bench.py``, run as ``python -m paddle_tpu_torch.bench``.

Same configuration and loop as ``bench.py``: GPT-2 345M (24 layers,
hidden 1024, 16 heads, vocab 50304, dropout 0), batch 8 x 1024 tokens,
bf16 compute with f32 master weights, Adam lr 1e-4 (``multi_precision``),
no recompute; one random batch from seed 0 stays on the device; one
warm-up step, then 3 timed windows of 45 steps, each ending in a sync,
and the median window's tokens/s. It prints one JSON line with the same
keys as ``bench.py`` (after a line naming the card); ``vs_baseline``
is against the same constant.
It needs a CUDA card and raises without one.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

# bench.py's BASELINE_TOKENS_PER_SEC: 90% of an A100 at 45% training MFU
# on this model (~68k tokens/s), the north star of the whole repository
BASELINE_TOKENS_PER_SEC = 61_000.0


def main() -> dict:
    from .distributed.fleet.engine import ParallelTrainStep
    from .optimizer import Adam
    from .text.models.gpt import GPTConfig, GPTForCausalLM

    if not torch.cuda.is_available():
        raise RuntimeError("paddle_tpu_torch.bench measures the card: CUDA "
                           "is not available")
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
    result = {
        "metric": "gpt2_345m_train_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec, 2),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(tokens_per_sec / BASELINE_TOKENS_PER_SEC, 4),
    }
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
