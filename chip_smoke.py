#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc`` and then,
failing on the first phase that fails:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels and prints the build time and ptxas' register use;
3. holds each kernel against its plain PyTorch version on the card at the
   served shapes (tolerances below), and times the kernel, the plain
   version and one PyTorch library call as a yardstick (CUDA events over
   back-to-back calls, which at small shapes measure the host's launch
   rate; the kernel's and the library call's device time come from
   ``torch.profiler``), beside the least time the card could take (bytes
   or operations over the H100's peak);
4. runs the dense forward of GPT-2 345M (24 layers, hidden 1024, 16
   heads, vocab 50304, bf16 weights from a seed) on [1, 1024] tokens
   through the kernels and through the plain path, compares the logits,
   and checks the launch counts (49 LayerNorms, 24 attentions);
5. serves 8 requests (prompts of 32-512 tokens, 32 new tokens each)
   through ``TokenServingEngine`` with bf16 weights and bf16 KV, checks
   every request ends ``ok`` with no leaked KV block, and prints
   tokens/s, TTFT/TPOT p50, the step-time histograms and, from a second
   run under ``torch.profiler``, the device busy share and the device
   time by kernel;
6. in f32 (weights, KV, no TF32), checks that two requests' served
   tokens equal ``dense_greedy_reference`` over the kernels.

Every kernel's launch count is set to 0 before each of phases 4-6 and
read after it. The last two lines are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# --- tolerances (max |kernel - plain| <= ATOL + RTOL * |plain|) -------------
# f32: both sides accumulate in f32, in different orders.
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# bf16 outputs: both sides compute in f32 and round once; a rounding flip
# is one bf16 ulp (2^-8 relative), covered by rtol 1e-2.
FLASH_OUT_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
# lse is f32 on both sides, from the same (bf16 or f32) inputs.
FLASH_LSE_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-4, 0.0)}
# dense GPT-2 345M logits in bf16: a few bf16 ulps at |logit| <= 4 after
# 24 layers of independently rounded activations.
LOGITS_BF16_ATOL = 0.125

# --- the card's peaks (H100 SXM data sheet, dense, at 700 W) ----------------
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
F32_CORE_FLOPS = 67e12  # f32 arithmetic outside the tensor cores

LN_ROWS = (1, 2, 4, 8, 128, 1024, 8192)  # decode buckets, chunk, dense
LN_HIDDEN = (1024, 768)
FLASH_SHAPES = ((1, 1024, 16, 64), (4, 512, 16, 64), (2, 77, 16, 64),
                (1, 256, 8, 128))
DTYPES = (torch.float32, torch.bfloat16)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back runs
    (CUDA events, after ``warmup`` runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Device time of one call of ``fn``: the summed duration of the
    kernels it launches (``torch.profiler``), without the host's launch
    gaps that CUDA events over back-to-back calls also count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / iters / 1e3


def worst(got, ref, atol, rtol):
    """(max |got - ref|, whether every element is within tolerance)."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + rtol * ref.float().abs()).all())
    return float(d.max()), ok


def ln_bound(rows, hidden, dtype):
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * rows * hidden + 2 * hidden) * esize
    flops = 8 * rows * hidden  # mean 1, var 3, affine 4 per element (f32)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def flash_bound(b, L, H, d, dtype):
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * L * H * d * esize + b * H * L * 4
    flops = 4 * d * b * H * L * (L + 1) // 2  # QK^T and PV over k <= q
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


@contextlib.contextmanager
def plain_kernels(gpt_mod, fused, flash_tpu):
    """Run the model's LayerNorms and attention through the kernels'
    plain PyTorch versions (the comparison path of phase 4)."""
    saved = gpt_mod.fused_layer_norm, gpt_mod.dot_product_attention
    gpt_mod.fused_layer_norm = fused._ln_reference
    gpt_mod.dot_product_attention = \
        lambda q, k, v, causal, layout: flash_tpu._flash_reference(q, k, v)[0]
    try:
        yield
    finally:
        gpt_mod.fused_layer_norm, gpt_mod.dot_product_attention = saved


def profile_serving(model, serve_cfg, prompts, engine_cls, run_streams):
    """Device busy share of the serving loop: ``torch.profiler`` over a
    second closed-loop run (8 requests, 8 new tokens each) on a fresh
    engine; prints the busy share and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    engine = engine_cls(model, serve_cfg)
    engine.start()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_streams(engine, n_streams=8, requests_per_stream=1,
                    prompt_fn=lambda i: prompts[i], max_new_tokens=8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.shutdown()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0:
        log("[5] profile: the profiler saw no device time (device busy "
            "share not measured)")
        return
    log(f"[5] profile: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, busy share {busy_us / wall_us:.4f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[5] profile: {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paddle_tpu_torch.inference.serving import (
        TokenServeConfig, TokenServingEngine, dense_greedy_reference,
        run_generation_streams)
    from paddle_tpu_torch.ops import _build, flash_tpu, fused
    from paddle_tpu_torch.profiler.telemetry import get_telemetry
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ln_fn, flash_fn = fused.fused_layer_norm, flash_tpu.flash_attention_blhd

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}  (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({_build.build_info['path']})")
    for src, text in _build.build_info.get("log", {}).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {src}: {line.strip()}")

    # -- phase 3: each kernel against its plain version ---------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, dtype: torch.randn(
        *shape, device=dev, generator=gen).to(dtype)
    err = {"layer_norm_fwd": 0.0, "flash_attn_fwd": 0.0}
    for dtype in DTYPES:
        for hidden in LN_HIDDEN:
            for rows in LN_ROWS:
                x = rnd(rows, hidden, dtype=dtype)
                w, b = rnd(hidden, dtype=dtype), rnd(hidden, dtype=dtype)
                y = ln_fn(x, w, b)
                torch.cuda.synchronize()
                e, ok = worst(y, fused._ln_reference(x, w, b),
                              *LN_TOL[dtype])
                err["layer_norm_fwd"] = max(err["layer_norm_fwd"], e)
                log(f"[3] layer_norm {str(dtype)[6:]} rows={rows} "
                    f"hidden={hidden}: max err {e:.3g} "
                    f"(tol {LN_TOL[dtype]})")
                if not ok:
                    raise AssertionError("layer_norm kernel disagrees")
        for shape in FLASH_SHAPES:
            q, k, v = (rnd(*shape, dtype=dtype) for _ in range(3))
            out, lse = flash_fn(q, k, v)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_tpu._flash_reference(q, k, v)
            e_o, ok_o = worst(out, ref_out, *FLASH_OUT_TOL[dtype])
            e_l, ok_l = worst(lse, ref_lse, *FLASH_LSE_TOL[dtype])
            err["flash_attn_fwd"] = max(err["flash_attn_fwd"], e_o, e_l)
            log(f"[3] flash {str(dtype)[6:]} (b,L,H,d)={shape}: out err "
                f"{e_o:.3g} (tol {FLASH_OUT_TOL[dtype]}), lse err {e_l:.3g} "
                f"(tol {FLASH_LSE_TOL[dtype]})")
            if not (ok_o and ok_l):
                raise AssertionError("flash kernel disagrees")

    timings = []
    for rows in (1, 8, 128, 1024, 8192):
        x = rnd(rows, 1024, dtype=torch.bfloat16)
        w, b = (rnd(1024, dtype=torch.bfloat16) for _ in range(2))
        bound, by = ln_bound(rows, 1024, torch.bfloat16)
        timings.append({
            "kernel": "layer_norm_fwd", "shape": [rows, 1024],
            "dtype": "bfloat16",
            "ms": time_ms(lambda: ln_fn(x, w, b)),
            "plain_ms": time_ms(lambda: fused._ln_reference(x, w, b)),
            "library_ms": time_ms(lambda: torch.nn.functional.layer_norm(
                x, (1024,), w, b, 1e-5)),
            "device_ms": device_ms(lambda: ln_fn(x, w, b)),
            "library_device_ms": device_ms(
                lambda: torch.nn.functional.layer_norm(x, (1024,), w, b,
                                                       1e-5)),
            "bound_ms": bound, "bound_by": by})
    for shape in FLASH_SHAPES:
        q, k, v = (rnd(*shape, dtype=torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound, by = flash_bound(*shape, torch.bfloat16)
        timings.append({
            "kernel": "flash_attn_fwd", "shape": list(shape),
            "dtype": "bfloat16",
            "ms": time_ms(lambda: flash_fn(q, k, v), iters=20),
            "plain_ms": time_ms(
                lambda: flash_tpu._flash_reference(q, k, v), iters=20),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), iters=20),
            "device_ms": device_ms(lambda: flash_fn(q, k, v)),
            "library_device_ms": device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
            "bound_ms": bound, "bound_by": by})
    for t in timings:
        log(f"[3] time {t['kernel']} {t['shape']} bf16: kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
            f"(device {t['library_device_ms']:.4f}), bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
    log("timings " + json.dumps(timings))

    launches = {"layer_norm_fwd": {}, "flash_attn_fwd": {}}

    def reset_counts():
        ln_fn.launches = 0
        flash_fn.launches = 0

    def read_counts(phase):
        launches["layer_norm_fwd"][phase] = ln_fn.launches
        launches["flash_attn_fwd"][phase] = flash_fn.launches
        return ln_fn.launches, flash_fn.launches

    # -- phase 4: dense forward at full width ------------------------------
    cfg = gpt_mod.gpt2_medium()
    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=0).eval()
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), device=dev,
                        generator=gen)
    with torch.no_grad():
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        n_ln, n_flash = read_counts("dense_forward")
        with plain_kernels(gpt_mod, fused, flash_tpu):
            logits_plain = model(ids)
            plain_fwd_ms = time_ms(lambda: model(ids), iters=5, warmup=1)
        kernel_fwd_ms = time_ms(lambda: model(ids), iters=5, warmup=1)
    if tuple(logits.shape) != (1, 1024, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    e = float((logits.float() - logits_plain.float()).abs().max())
    agree = float((logits.argmax(-1) == logits_plain.argmax(-1))
                  .float().mean())
    log(f"[4] dense forward gpt2_medium bf16 [1, 1024]: logits max err "
        f"{e:.4g} (atol {LOGITS_BF16_ATOL}), argmax agreement {agree:.4f}; "
        f"launches LN {n_ln}, flash {n_flash}; forward {kernel_fwd_ms:.2f} "
        f"ms through kernels, {plain_fwd_ms:.2f} ms plain")
    if e > LOGITS_BF16_ATOL:
        raise AssertionError("dense logits disagree with the plain path")
    if (n_ln, n_flash) != (2 * cfg.num_layers + 1, cfg.num_layers):
        raise AssertionError(f"dense forward launched LN {n_ln}, flash "
                             f"{n_flash}; expected 49 and 24")

    # -- phase 5: token serving at full width --------------------------------
    block = 16
    serve_cfg = TokenServeConfig(
        capacity=16, decode_buckets=(1, 2, 4, 8), prefill_chunk=128,
        max_new_tokens=32, kv_blocks=8 * 1024 // block + 1,
        kv_block_size=block, kv_dtype="bfloat16")
    lengths = (32, 512, 77, 200, 128, 333, 64, 450)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    engine = TokenServingEngine(model, serve_cfg)
    engine.start()
    tel = get_telemetry()
    tel.reset()
    reset_counts()
    res = run_generation_streams(engine, n_streams=8, requests_per_stream=1,
                                 prompt_fn=lambda i: prompts[i],
                                 max_new_tokens=32)
    acct = engine.shutdown()
    torch.cuda.synchronize()
    n_ln, n_flash = read_counts("serving")
    kv = engine.kv_accounting()
    steps = tel.counter_value("serve/decode_steps")
    chunks = tel.counter_value("serve/prefill_chunks")
    log(f"[5] served {res['by_status']} in {res['wall_s']:.3f} s: "
        f"{res['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{res.get('ttft_p50_ms', float('nan')):.2f} ms, TPOT p50 "
        f"{res.get('tpot_p50_ms', float('nan')):.2f} ms; {steps} decode "
        f"steps, {chunks} prefill chunks; launches LN {n_ln}, flash "
        f"{n_flash}; leaked blocks {kv['leaked_blocks']}")
    log("serving " + json.dumps({k: v for k, v in res.items()
                                 if k != "requests"}))
    for r in res["requests"]:
        toks = r.outputs[0] if r.outputs else []
        if r.status != "ok" or len(toks) != 32 or not all(
                0 <= int(t) < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {r.id} ended {r.status} with "
                                 f"{len(toks)} tokens")
    if kv["leaked_blocks"] != 0 or acct["unaccounted"] \
            or acct["double_terminal"]:
        raise AssertionError(f"accounting broken: {acct} {kv}")
    if tel.counter_value("serve/kv_blocks_alloc") \
            != tel.counter_value("serve/kv_blocks_free"):
        raise AssertionError("kv_blocks_alloc != kv_blocks_free")
    if n_ln != (2 * cfg.num_layers + 1) * (steps + chunks):
        raise AssertionError(f"serving launched {n_ln} LayerNorms for "
                             f"{steps + chunks} steps")
    for name in ("serve/decode_ms", "serve/prefill_ms"):
        s = tel.hist_summary(name)
        log(f"[5] {name}: p50 {s['p50']:.3f} p95 {s['p95']:.3f} "
            f"(n={s['count']})")
    profile_serving(model, serve_cfg, prompts, TokenServingEngine,
                    run_generation_streams)
    del engine, model, logits, logits_plain
    torch.cuda.empty_cache()

    # -- phase 6: f32 greedy parity ------------------------------------------
    model32 = gpt_mod.GPTForCausalLM(cfg, dtype=torch.float32, seed=1).eval()
    engine = TokenServingEngine(model32, TokenServeConfig(
        decode_buckets=(1, 2), prefill_chunk=128, max_new_tokens=8,
        kv_blocks=2 * 1024 // block + 1, kv_block_size=block,
        kv_dtype="float32"))
    engine.start()
    reset_counts()
    parity_prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                      for n in (40, 150)]
    reqs = [engine.submit(p, max_new_tokens=8) for p in parity_prompts]
    for r in reqs:
        if not r.wait(600):
            raise AssertionError(f"request {r.id} did not finish")
    acct = engine.shutdown()
    refs = [dense_greedy_reference(model32, p, 8) for p in parity_prompts]
    torch.cuda.synchronize()
    n_ln, n_flash = read_counts("greedy_parity")
    for r, ref in zip(reqs, refs):
        got = [int(t) for t in r.outputs[0]]
        log(f"[6] f32 request {r.id}: served {got}, dense reference {ref}")
        if r.status != "ok" or got != ref:
            raise AssertionError("served tokens differ from "
                                 "dense_greedy_reference")
    if engine.kv_accounting()["leaked_blocks"] or acct["unaccounted"]:
        raise AssertionError("f32 engine leaked")
    # the served side uses paged attention; the reference's 2 x 8 dense
    # forwards each run every layer's attention through the kernel
    if n_flash != 2 * 8 * cfg.num_layers:
        raise AssertionError(f"dense reference launched flash {n_flash} "
                             f"times, expected {2 * 8 * cfg.num_layers}")
    log(f"[6] f32 greedy parity ok; launches LN {n_ln}, flash {n_flash}")

    # -- the kernels line and the result --------------------------------------
    main_ln = next(t for t in timings if t["kernel"] == "layer_norm_fwd"
                   and t["shape"] == [1024, 1024])
    main_fl = next(t for t in timings if t["kernel"] == "flash_attn_fwd"
                   and t["shape"] == [1, 1024, 16, 64])
    kernels = []
    for name, source, replaces, t in (
            ("layer_norm_fwd", "paddle_tpu_torch/csrc/layer_norm.cu",
             "paddle_tpu/ops/fused.py:25", main_ln),
            ("flash_attn_fwd", "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
             "paddle_tpu/ops/flash_tpu.py:43", main_fl)):
        by_phase = launches[name]
        if by_phase["dense_forward"] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "shape": t["shape"],
            "dtype": t["dtype"]})
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
