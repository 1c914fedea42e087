#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc`` and then,
failing on the first phase that fails:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels and prints the build time and ptxas' register use
   (and fails if a warp-per-row LayerNorm kernel, or the packed dK/dV
   kernel at d <= 64, spills);
3. holds each kernel against its plain PyTorch version on the card at the
   served shapes (tolerances below; bf16 attention runs the tensor-core
   forward, f32 the exact scalar one; LayerNorm both of its kernels: the
   warp-per-row one at the models' widths and a predicated tail, the
   block-per-row one at a width that is no multiple of the 16-byte vector
   and on misaligned views), and times the kernel, the plain
   version and one PyTorch library call as a yardstick (CUDA events over
   back-to-back calls, which at small shapes measure the host's launch
   rate; the kernel's and the library call's device time come from
   ``torch.profiler``; a window in which it records no kernel is taken
   again, and a third such window fails the run), beside the least time
   the card could take (bytes or operations over the H100's peak); at the
   training shapes the LayerNorms are timed on copies of their inputs in
   turn, so that each call reads them from HBM as a step does, and the
   time with the inputs in the 50 MB L2 is kept beside it; it prints
   each attention
   forward's share of its bound and its ratio to SDPA;
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
   tokens equal ``dense_greedy_reference`` over the kernels;
7. (after 3b, which holds the LayerNorm backward (and its dw/db bit for
   bit over two calls), flash-attention dQ (with delta) and dK/dV and
   multi-tensor Adam kernels against their plain versions in bf16 and
   f32 — the bf16 backward against the plain
   version with bf16-rounded P and dS and against the f32 one — times
   them as phase 3 does, and prints each backward kernel's share of its
   bound and the pair's ratio to SDPA's backward) takes one training
   step of a 2-layer GPT-2 345M in f32 (batch 2 x 1024, TF32 off)
   through the kernels and one through the plain path, and compares the
   loss, every gradient and every parameter after the Adam step; then
   the same step in bf16 with f32 masters (loss and gradients);
8. trains GPT-2 345M (24 layers) at batch 8 x 1024 in bf16 with f32
   master weights through ``ParallelTrainStep``: 3 warm-up and 20 timed
   steps, tokens/s, p50 step time, peak memory, the loss finite and
   falling, the launch counts per step, and a 2-step profile (which must
   show every attention forward on ``flash_fwd_mma_kernel`` and every
   backward on ``flash_dq_mma_kernel`` and ``flash_dkv_mma_kernel``, none
   on the scalar kernels, and every LayerNorm on ``ln_fwd_warp_kernel``
   and ``ln_bwd_warp_kernel``, none on the block kernels; it prints the
   ``gemv`` launches per step);
9. (after 3c, which holds the full-attention forward, dQ and dK/dV
   kernels (also on q/k/v as the strided views of a fused QKV projection
   that BERT passes, and with a key-padding bias of random valid lengths),
   the packed dK/dV of the experiment (at d = 32, 64 and 128, also against
   the causal dK/dV kernel, whose bits it must give at d = 64, the same
   bits over two calls, every launch on the tensor-core kernel in a
   profile) and the AdamW mode of the Adam
   kernel against their plain versions and times them) takes one f32
   AdamW step of a 2-layer BERT-base (batch 4 x 128) through the kernels
   and one through the plain path, and compares the loss, every gradient
   and every parameter after the step; then the same on a padded batch
   (an attention mask of random valid lengths);
10. trains BERT-base (12 layers, hidden 768, vocab 30528) at batch
    32 x 128 in bf16 without master weights, AdamW lr 1e-4 and weight
    decay 0.01: 3 warm-up and 20 timed steps, samples/s, tokens/s, p50
    step time, peak memory, the loss finite and falling, the launch counts
    per step, every attention call on the kernel, and a 2-step profile
    (every attention forward and backward on the tensor-core kernels,
    every LayerNorm on the warp-per-row kernels);
    then padded batches on the card: a bf16 BERT-base forward with an
    attention mask through the kernels against the plain path, and 3
    masked AdamW steps with every attention call on the full kernels;
11. runs the packed dK/dV experiment's own entry point
    (``paddle_tpu_torch.experiments.dkv_packed.main``) and checks its
    gradients against autograd;
12. trains GPT-2 345M the way Megatron-LM's ``examples/pretrain_gpt.sh``
    pretrains it (AdamW with weight decay 0.01 off the LayerNorm weights
    and biases, ``LinearWarmup(CosineAnnealingDecay)`` from 1.5e-4 to 1e-5
    with its warm-up and decay cut to 3 and 10 steps,
    ``ClipGradByGlobalNorm(1.0)``, dropout 0.1, bf16 with f32 masters,
    batch 8 x 1024): 12a holds the global norm's sum-of-squares kernel
    against its plain version on the model's 292 bf16 gradients (and the
    same bits over two calls) and the clip-scaled AdamW kernel against
    ``_adam_reference``, and times both; 12b trains GPT-2 345M's widths
    at 12 of its 24 layers through
    ``ParallelTrainStep`` under remat 'off', 'full', 'dots' and
    'dots_no_batch' from the same seeds: step 1's loss and gradient norm
    (the kernel's device scalar) must be bitwise those of 'off' (or, if
    two 'off' runs differ here, within their difference), then 5 steps
    with the scheduler stepped must give finite, falling losses and the
    launch counts per step (attention forward 12, or 24 under a recompute
    policy; LayerNorm forward 25, or 49: ln_f is outside the recomputed
    blocks; Adam 2 and its sum-of-squares pass 2), and it prints each
    policy's step p50 and peak memory ('full''s peak must be below
    'off''s); 12c takes 3 steps through ``jit.TrainStep`` and through
    ``ParallelTrainStep`` from the same bf16 weights and needs the same
    losses;
13. trains the vision family: 13a holds the Adam kernel against its plain
    version on LeNet's 10 tensors (tails of 2 past the vector) and times
    it, takes one LeNet step through the kernel and one through the plain
    update from the same weights (loss, gradients, parameters), then runs
    BASELINE config #1 (``TrainStep(LeNet(), CrossEntropyLoss(),
    Adam(1e-3))`` at batch 64 x 1 x 28 x 28 from ``RandomState(0)``): 3
    warm-up and 30 timed steps, samples/s, step p50, busy share and the
    Adam launches (2 a step), then one epoch of
    ``DataLoader(MNIST(mode="train"), 64, shuffle=True, drop_last=True)``
    (the synthetic digits, pinned batches): the loss falls and
    ``Accuracy`` on the test split ends above chance; 13b takes one f32
    ``Momentum(0.01, 0.9)`` step of ResNet-50 at 2 x 3 x 64 x 64 on the
    card (TF32 off) and on the CPU from the same weights and buffers and
    compares the loss, the gradients, the updates and the running
    statistics; 13c trains ResNet-50 at config #2's model and batch
    (128 x 3 x 224 x 224, 1000 classes, ``Momentum(0.01, 0.9)``, AMP O1 in
    bf16 under ``amp.auto_cast``) through ``TrainStep``: 3 warm-up and 10
    timed steps, samples/s, step p50, peak memory, a 2-step profile (busy
    share, device time a step, the top 12 device operations), the loss
    finite and falling, and an eval-mode forward finite;
14. trains through the high-level API: 14a runs BASELINE config #1 as the
    reference's hapi test does (``Model(LeNet()).prepare(Adam(1e-3),
    CrossEntropyLoss(), Accuracy())``, ``fit`` over the synthetic MNIST at
    batch 64 for 2 epochs with ``prefetch_depth=2``, a ``save_dir``,
    ``EarlyStopping``, ``LRScheduler`` and ``ModelCheckpoint``, then
    ``evaluate``, ``predict(stack_outputs=True)``, ``save`` and ``load``):
    Adam (#7) 2 launches a step, samples/s and step p50 beside 13a's
    ``TrainStep``, the host split from ``fit``'s spans (train step, metric
    forward, callbacks, checkpoints, loader), a profiled busy share, the
    files written and a ``.pdparams`` read back to the same bits; then,
    with deterministic cuDNN, ``prefetch_depth=2`` against 0 and 1 epoch +
    save + load into a fresh Model and Adam + 1 epoch against 2 epochs, the
    same bits; 14b trains MobileNetV2 (1000 classes) at 128 x 3 x 224 x 224
    in fp16 O1 with ``GradScaler(2**15)`` and ``Momentum(0.1, 0.9,
    L2Decay(4e-5))``, fed by ``FakeData`` 256 x 256 images through
    ``RandomCrop``, ``RandomHorizontalFlip``, ``Normalize`` and
    ``Transpose`` in 4 loader workers and the ``DevicePrefetcher``: 3
    warm-up and 20 timed steps (samples/s, step p50, input-wait share from
    the goodput ledger, peak memory, the scale each step, a 2-step profile),
    then a step with a gradient made non-finite (no parameter or velocity
    bit moves, the scale halves) and a finite one that updates again; 14c
    trains VGG-16 at 64 x 3 x 224 x 224 the same way for 5 steps
    (samples/s, peak memory, finite losses, a positive scale);
15. trains guarded and fingerprinted: 15a is ``bench_input_pipeline``'s
    twin at its full size (``paddle_tpu_torch.bench.InputPipeline``: the
    MLP through ``TrainStep`` with and without ``step.prefetch``; the
    per-step losses of a pass with and a pass without it the same bits,
    Adam 2 launches a step, samples/s and the speedup); 15b is BERT-base
    at ``bench_bert_dp``'s configuration with ``fingerprint_every=1``: two
    3-step runs give the same digests, the multi-tensor fold
    (``csrc/tree_reduce.cu``) against its plain version on the engine's
    state (the XOR word equal, the sums within ``FOLD_SUM_RTOL`` of the
    abs-sum, two folds the same bits) and timed beside
    ``torch._foreach_norm(ord=1)``, ``corrupt_param_bit`` changes the
    word, and ``bench.bench_bert``'s three fingerprint columns; 15c runs
    ``StepGuard`` over guarded engines on GPT-2 345M (8 x 1024, bf16 with
    f32 masters) and BERT-base: an injected NaN batch and an update made
    to overflow (lr 3.4e38) move no bit of the state and name their
    leaves, two bad steps in a row roll back to the snapshot's bits,
    Adam's check pass (``adam_finite_check``) gives its plain version's
    flags and is timed, and the step p50 with and without the guard.

16. trains long-context GPT-small (12 layers, hidden 768, 12 heads,
    ``max_position_embeddings=8192``) at b = 1, L = 8192 as
    ``bench_all.py``'s ``longctx`` does: 16a holds #1-#3 at
    [1, 8192, 12, 64] bf16 causal against their plain versions, the
    ``xla`` (q-chunked) and ``blockwise`` tiers' outputs and gradients
    against the f32 plain path (``TIER_REL_TOL``), and times #1-#3 and
    SDPA's causal forward and backward beside their bound; 16b runs
    ``paddle_tpu_torch.bench.bench_longctx`` at full size (the forced
    blockwise leg, the measured tier verdict with every candidate's
    timing, the ``remat='auto'`` probe at 60% of the off peak, whose
    chosen peak must not exceed it, and the headline leg, whose engine
    then takes 3 counted steps: losses finite and falling, #1-#3 12 a
    step when the verdict is ``flash_tpu``, #5 25 and #7 2, peak memory,
    and a 2-step profile), and a leg
    forced onto ``flash_tpu`` when the verdict is another tier; 16c takes
    2 steps under remat 'off' (twice), 'dots_no_batch', 'offload' and
    'auto' (with the card's memory pinned to 60% of the off peak, so that
    it must recompute) and holds step 1's loss, step 1's gradient norm
    and step 2's loss against 'off' as 12b does, and compares offload's
    measured peak with 'dots_no_batch''s (it must be lower).

17. runs the static graph: 17a a recorded ResNet-50 f32 step against an
    eager step, 17b BASELINE config #2 through ``bench.build_resnet50_
    train``, 17c a recorded 2-layer GPT-2 345M step with and inside
    ``plain_kernels`` and ``jit.to_static`` of phase 4's dense forward;
18. serves breadth: 18a holds the registered kernel ops
    (``paddle_tpu_torch::layer_norm_fwd``, ``::flash_attn_fwd``) against
    their plain versions at the Predictor's shapes, then runs GPT-2 345M
    (bf16, phase 4's weights) through an ``inference.Predictor`` from
    ``set_layer`` and from the ``.pdexport`` that ``jit.save`` wrote
    (loaded by ``create_predictor_from_path``): phase 4's logits (the
    layer the same bits, the artifact within ``LOGITS_BF16_ATOL``), #1 24
    and #5 49 launches a forward on both paths, the p50 of a forward at
    [8, 1024]; 18b runs ``bench serving`` and 18c ``bench decode`` at
    ``bench_all``'s full size (every request ``ok``, nothing unaccounted,
    no leaked block); 18c runs ``bench decode``'s plain leg again under
    ``torch.profiler`` (busy share, top kernels; its tokens must equal
    ``dense_greedy_reference``'s), then GPT-2 345M in f32 served with
    ``spec_k=3`` and a 1-layer draft, whose tokens must equal
    ``dense_greedy_reference``'s (accept rate, tokens/s, no block of
    either pool leaked); 18d serves GPT-2 345M from an int8 pool beside a
    bf16 pool (the int8 pool at most ``INT8_POOL_SHARE`` of the bf16
    pool's bytes, the share of greedy tokens that agree, the first decode
    step's logits within ``INT8_LOGIT_SPAN_SHARE`` of the bf16 logits'
    range), each pool's run profiled once. Every shape 18b-18d gave #1
    and #5 is then held against the plain versions.
19. the parameter surface: 19a (run right after 3c, where the profiler's
    windows hold every launch) holds Adam's fp16 instance (fp16
    gradients and resident copies, f32 masters) with its per-tensor
    learning-rate scale column against the plain version over GPT-2
    345M's 292 tensors (scales 1, 0.5 on the LayerNorms, 0 on wpe, times
    an AdamW ``lr_ratio`` of 2 on the matrices; a step plain, one clipped,
    one checked) and over ResNet-50's tensors, the copy equal to the
    master's fp16 rounding, and times it beside its bound and
    ``torch.optim.Adam(fused=True)`` over the f32 masters; 19b trains
    ResNet-50 at config #2's batch (128 x 3 x 224^2) in pure fp16
    (``amp.decorate(level='O2')``, ``Adam(multi_precision=True)``,
    ``GradScaler``) through the eager loop and through ``TrainStep``:
    Adam's launches per step, step 1's loss against the f32 forward on the
    same weights and batch, the skipped steps, samples/s, step p50, a
    profile and peak memory; 19c trains ``Embedding(50304, 1024,
    padding_idx=0, sparse=True)`` and a dense head over 8 x 1024 ids for 3
    steps of SGD, Adam, lazy Adam and Adam with a global-norm clip
    against the same model with a dense table (lazy Adam: the untouched
    rows keep their bits, the padding row never moves) and prints the
    step times; 19d takes one eager ``Adam.step`` of GPT-2 345M (bf16, f32
    masters) with learning-rate scales 0.5 on the LayerNorms and 0 on wpe
    through the kernel and through the plain update: the same bits, wpe
    unchanged.

20. the rest of nn/: 20a trains Transformer-base (``nn.Transformer()`` at
    its defaults, the paper's "base") with a shared 37,000-token embedding
    tied to the output projection and label smoothing 0.1, Adam(0.9,
    0.98, 1e-9) under ``NoamDecay(512, 4000)``, at 32 sentence pairs of
    128 tokens a side through ``ParallelTrainStep``: step 1 in f32
    (dropout 0, TF32 off) against the CPU's plain step (loss, gradient
    norm, an updated weight of each kind), then f32 and bf16 O1 legs (3
    warm-up and 5 timed steps at dropout 0.1: tokens/s, step p50, device
    ms, busy share, peak memory, MFU, the top kernels, #5 30, #6 60 and
    #7 2 launches a step and no LayerNorm on its plain path); 20b beam
    searches 8 sources (beam 4, at most 64 steps) through
    ``BeamSearchDecoder`` / ``dynamic_decode`` over the decoder's
    ``gen_cache`` caches: the incremental logits against the full causal
    forward at every step, each beam's score against the full forward's
    log-probabilities, the beams sorted, beam size 1 the greedy decode;
    20c trains Zaremba et al.'s "medium" LSTM language model and a GRU at
    its shape (SGD 1.0, global-norm clip 5): step 1 against the CPU's,
    tokens/s, step p50, kernel launches a step; 20d runs every function
    and layer of the slice at small shapes on the card, with synchronizing
    calls turned into errors, against the same call on CPU tensors, and
    the four ``static.nn`` functions of the slice through
    ``Executor.run``.
21. the tensor API: 21a runs every case of ``tests/torch_tensor_cases.py``
    (each function of ``paddle_tpu_torch.tensor``, with its gradient where
    the reference differentiates it) on the card, creation on the current
    device "gpu:0", against the same case on the CPU, with synchronizing
    calls turned into errors but for the listed data-dependent cases (and
    the linalg cases whose cuSOLVER status torch reads back, which it
    prints), then the static sequence functions through ``Executor.run``;
    21b trains GPT-2 345M at phase 8's shape through the top-level API
    (``paddle.seed``, ``paddle.randint``, O2 bf16 with Adam's f32
    masters, ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``):
    step 1's loss against phase 8's ``ParallelTrainStep`` on the same
    weights and batch, 10 timed steps (tokens/s, step p50, device time, busy
    share, peak memory, each beside phase 8's), the launch counts of #1-#3
    and #5-#7, an accuracy from ``argmax`` / ``equal`` / ``mean``; 21c
    samples 16 tokens (top-k 40: ``topk``, ``softmax``, ``multinomial``,
    ``concat``) and, after ``set_cuda_rng_state`` back to the saved state,
    the same 16 again; 21d holds third-order gradients, the WGAN-GP
    penalty's gradient on a 1024-4096-1024 GELU MLP at batch 8192 and a
    straight-through ``PyLayer`` against the CPU (or its plain function),
    and the third derivative through #5/#6, #1-#3 and #4 (with a key
    bias) against their plain versions'.

22. detection, CRF tagging and the hapi tail: 22a serves SSD-MobileNet-v1
    on VOC (PaddleDetection's ``ssd_mobilenet_v1_voc``: MobileNetV1 to
    conv11 and conv13, four extra 1x1/3x3 pairs, ``multi_box_head``'s
    priors, ``box_coder`` decode, softmax, ``multiclass_nms``) at 8 x 3 x
    300 x 300: images/s, batch p50, device time, busy share, NMS's share
    and peak memory; the NMS block and the 11-point mAP against the CPU's
    on the card's boxes, decoding and NMS with synchronizing calls turned
    into errors, and the head as a ``static.Program`` (its priors
    ``prior_box``'s bits); 22b trains a BERT-base-CRF tagger (MSRA-NER's 7
    tags) at phase 10's shape, lengths 64-128, with bf16 compute and
    AdamW for 10 steps (#5 25 and #6 50 a step: ``BertModel`` has no MLM
    LayerNorm; the full attention 12 each; #7 2) beside phase 10, then
    holds ``linear_chain_crf`` (cost and gradients), ``crf_decoding``,
    ``static.nn.crf_decoding`` and ``viterbi_decode`` on the trained
    emissions against the CPU; 22c runs the rest of ``vision.ops`` at
    published shapes (YOLOv3-416's heads and NMS, R50-C4's RoIAlign,
    R-FCN's PSRoIPool, DCNv2 at res5, priors, box coding, IoU, SPP, the
    space-to-depth stem) against the CPU with each one's device time;
    22d trains GPT-2 345M with ``fused_head_ce=True`` at phase 8's shape
    (step 1's loss against phase 8's path, #1-#3 and #5-#7 as in phase
    8, step p50, device time and peak memory beside phase 8's); 22e holds
    ``flops`` of LeNet, ResNet-50 and MobileNetV1 built on the card to
    the reference's integers, builds the 22a model through ``hub.load``,
    and runs the encrypted ``save`` / ``load`` and ``.pdexport`` where
    ``cryptography`` is installed (else checks that the port names it),
    and the image loader where PIL is (else the same).

23. the fp16 instances of #1-#6 and second derivatives through the
    kernels: 23d (run after phase 3c) holds each fp16 instance against its
    plain version at GPT-2 345M's and BERT-base's training shapes (the
    attention's backward against the plain version with fp16-rounded P
    and dS) and times it beside its bound, its plain version and the fp16
    library call (``F.layer_norm``, SDPA causal and with the padding mask,
    and their backward); 23a trains GPT-2 345M through
    ``ParallelTrainStep(compute_dtype=torch.float16)`` with Adam's f32
    masters at phase 8's 8 x 1024 from phase 8's weights and batch (step
    1's loss against phase 8's bf16 step 1, the launches of phase 8 a
    step, a profile with every attention and LayerNorm launch on the
    ``__half`` instances; tokens/s, step p50, device time, busy share and
    peak memory beside phase 8's); 23b BERT-base the same way at phase
    10's 32 x 128 with AdamW, then padded steps on #4's key bias; 23c the
    WGAN-GP penalty's gradient through two GPT-2 345M blocks and a linear
    head at [8, 1024, 1024]: in f32 through the kernels (the first-order
    path's launches counted) against f32 under ``plain_kernels``, then in
    bf16 for the time of the double backward and its peak memory.

Every kernel's launch count is set to 0 before each of phases 4-23 and
read after it. The last two lines are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

# --- tolerances (max |kernel - plain| <= ATOL + RTOL * |plain|) -------------
# f32: both sides accumulate in f32, in different orders.
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# f32: the scalar kernel and the plain version both accumulate in f32.
# bf16 (the tensor-core forward): P is rounded to bf16 as the P·V operand
# (as the reference's `_fwd_kernel` does; the plain version keeps f32 P),
# at most 2^-9 relative per element, so at most 2^-9·max|v| on an output
# element — a sum of roundings of both signs, far less in practice — and
# each side rounds the output once (2^-9 relative each): bound
# 2^-9·max|v| + 2^-8·|ref|, within atol 1e-2 + rtol 1e-2 for |v| <= 5.
FLASH_OUT_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
# lse is f32 on both sides, from the same (bf16 or f32) inputs.
FLASH_LSE_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-4, 0.0)}
# dense GPT-2 345M logits in bf16 (and BERT-base's masked MLM logits,
# phase 10): a few bf16 ulps at |logit| <= 4 after 24 (12) layers of
# independently rounded activations.
LOGITS_BF16_ATOL = 0.125
# LayerNorm backward: dx is one f32 result rounded once; dw/db are f32
# sums over up to 8192 rows taken in another order (f32: relative error of
# a few 1e-7 of the sum), or one bf16 rounding of them.
LN_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# flash backward, f32 (the scalar kernels): both sides sum f32 products in
# f32.
FLASH_BWD_TOL = (2e-5, 1e-5)
# bf16 (the tensor-core kernels) against the plain version with
# bf16-rounded P and dS: each side rounds its outputs to bf16 once (one
# ulp apart at most, 2^-7 of |ref|), and a few rounded P or dS elements
# flip one bf16 ulp between the two sum orders (mma against einsum, ex2 on
# the folded scale against exp), each moving one term by 2^-8 of itself:
# |err| <= 2^-7 |ref| + 2^-9 max|ref| per tensor (rtol, share of max).
FLASH_BWD_BF16_TOL = (2.0 ** -7, 2.0 ** -9)
# ... and against the f32 plain version of the same bf16 inputs: the
# roundings of P, dS and the outputs, 2^-6 of the tensor's largest
# magnitude (as #8's check).
BF16_VS_F32_REL_TOL = 2.0 ** -6
# the plain backward against autograd of the plain forward (f32): one
# function computed two ways (lse and softmax round differently).
FLASH_BWD_AUTOGRAD_TOL = (1e-4, 1e-4)
# Adam: kernel and plain version run the same separately rounded IEEE f32
# operations in the same order.
ADAM_TOL = (1e-6, 0.0)
# packed dK/dV (#8), bf16 with bf16-rounded P and dS: against its plain
# version (same roundings, other sum order: a rounded P or dS element can
# flip one bf16 ulp) and against the causal dK/dV kernel (f32 products),
# max |diff| within 2^-6 of the tensor's largest magnitude
PACKED_REL_TOL = 2.0 ** -6
# phase 7, f32 with TF32 off: the loss to a few f32 ulps, each gradient
# tensor within 1e-4 of its own largest magnitude (sums of up to 2048
# tokens in another order).
LOSS_RTOL = 1e-5
GRAD_REL_TOL = 1e-4
# phase 7's bf16 pass: the kernels round P (forward and backward) and dS
# to bf16 where the plain path keeps f32, and every bf16 activation after
# them is rounded from slightly different values: the loss within 1e-2
# relative, each gradient tensor within 2^-5 of its own largest magnitude
# (a few bf16 roundings of 2^-9 compounded over 2 layers).
LOSS_BF16_RTOL = 1e-2
GRAD_BF16_REL_TOL = 2.0 ** -5
TRAIN_LR = 1e-4
# after one Adam step every element moves by lr·g/(|g| + eps), ~lr: an
# element whose gradient is within f32 noise of 0 may move up to lr the
# other way; a real disagreement is a 2·lr move, which the gradient check
# catches first.
PARAM_ATOL = TRAIN_LR

# phase 19b: step 1's f32 loss against the pure-fp16 one on the same
# weights and batch: fp16 keeps 11 bits, and ResNet-50's 53 BatchNorms
# renormalise what each layer's rounding (2^-11 relative) adds; the loss
# (~ln 1000) within 2e-2 of itself
O2_LOSS_RTOL = 2e-2
# 19b's GradScaler starts at the reference's default scale; the warm-up
# runs until the scaler has taken a step (at most O2_WARMUP_MAX steps)
O2_INIT_LOSS_SCALE = 2.0 ** 15
O2_WARMUP_MAX = 20
# phase 19c: the sparse table's update against the dense one, f32: the
# same per-element formula, duplicate rows summed in another order
SPARSE_TOL = (1e-6, 1e-5)
SPARSE_STEPS = 3
# 19c's table (GPT-2 345M's wte) and its ids (the training batch)
SPARSE_VOCAB, SPARSE_DIM = 50304, 1024

# --- the card's peaks (H100 SXM data sheet, dense, at 700 W) ----------------
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
F32_CORE_FLOPS = 67e12  # f32 arithmetic outside the tensor cores

LN_ROWS = (1, 2, 4, 8, 128, 1024, 8192)  # decode buckets, chunk, dense
# (hidden, the kernels ``_ln_plan`` must pick): GPT-2 345M, BERT-base, a
# predicated tail (125 bf16 vectors) and a width that is no multiple of the
# 16-byte vector
LN_HIDDEN = ((1024, "warp"), (768, "warp"), (1000, "warp"), (1022, "block"))
# widths also checked on a misaligned view (one element past an
# allocation's start), which must go to the block kernels
LN_MISALIGNED_HIDDEN = (1024, 768)
LN_TIMED = ((8192, 1024), (4096, 768))  # GPT's and BERT's training shapes
# copies of the inputs the LayerNorms are also timed on in turn, so that a
# call finds its inputs out of the 50 MB L2 (6 x 16 MB of x at GPT's shape)
LN_COPIES = 6
FLASH_SHAPES = ((1, 1024, 16, 64), (4, 512, 16, 64), (2, 77, 16, 64),
                (1, 256, 8, 128))
DTYPES = (torch.float32, torch.bfloat16)
LN_BWD_ROWS = (1, 8, 1024, 8191, 8192)
FLASH_BWD_SHAPES = ((8, 1024, 16, 64), (4, 512, 16, 64), (2, 77, 16, 64),
                    (1, 256, 8, 128))
ADAM_NUMELS = (1, 1000, 65536, 1024 * 4096, 50304 * 1024)
TRAIN_SHAPE = (8, 1024)  # batch x tokens of the training phase
GPT_ATTN_SHAPE = (8, 1024, 16, 64)  # attention of the training phase
# full attention (#4): BERT's shape, a ragged L, GPT's shape
BERT_ATTN_SHAPE = (32, 128, 12, 64)
FULL_SHAPES = (BERT_ATTN_SHAPE, (4, 200, 12, 64), (8, 1024, 16, 64))
# packed dK/dV (#8), (b, L, H, d): the experiment's shape first, ragged L,
# BERT's, and the head dims where bf16(q * scale) rounds (32, 128)
PACKED_SHAPES = ((8, 1024, 16, 64), (4, 200, 12, 64), BERT_ATTN_SHAPE,
                 (2, 512, 8, 32), (2, 1024, 8, 128), (2, 333, 4, 128))
# ... timed at the experiment's b, L, H for each head dim
PACKED_TIMED = ((8, 1024, 16, 64), (8, 1024, 16, 32), (8, 1024, 16, 128))
BERT_SHAPE = (32, 128)  # batch x tokens of the BERT training phase
# phase 12: GPT-2 345M trained as Megatron-LM's examples/pretrain_gpt.sh
# trains it (lr 1.5e-4, linear warm-up then cosine decay to 1e-5, weight
# decay 0.01, global-norm clip 1.0, dropout 0.1), its warm-up and decay
# cut to 3 and 10 steps so that a short run crosses both
OPTIONS_PEAK_LR, OPTIONS_MIN_LR = 1.5e-4, 1e-5
OPTIONS_WARMUP, OPTIONS_T_MAX = 3, 10
OPTIONS_CLIP = 1.0
OPTIONS_DROPOUT = 0.1
OPTIONS_STEPS = 5  # timed steps per policy, after step 1
# GPT-2 345M's widths at half its depth: seven models are built and
# trained (each policy, 'off' twice, both engines), and the script must
# stay within half its time limit
OPTIONS_LAYERS = 12
REMAT_POLICIES = ("off", "full", "dots", "dots_no_batch")
# the global norm: kernel and plain version sum the same f32 squares in
# other orders (f32 rounding of a sum of 3.5e8 terms)
NORM_RTOL = 1e-5
# phase 13: the vision family. LeNet as BASELINE config #1 runs it
# (batch 64 x 1 x 28 x 28 from RandomState(0), Adam 1e-3) and ResNet-50 at
# config #2's model and batch (128 x 3 x 224 x 224, 1000 classes,
# Momentum(0.01, 0.9), AMP O1 in bf16)
LENET_BATCH = 64
LENET_STEPS = 30
RESNET_BATCH, RESNET_SIZE = 128, 224
RESNET_STEPS = 10
# 13b, ResNet-50 f32 on the card against the CPU at 2 x 3 x 64 x 64, TF32
# off: both sides sum in f32 in other orders, and a randomly initialised
# ResNet-50 at batch 2 amplifies that rounding (its 53 BatchNorms see 8
# values a channel in layer4, and its gradients grow ~100-fold toward the
# stem): the same bounds as tests/test_torch_vision.py's CPU comparison
# with the reference (logits and running statistics 1e-3 of their largest
# magnitude, fc's gradient 5e-3, every gradient tensor and every update
# p' - p within 0.1 of its L2 norm)
R50_CHECK_SHAPE = (2, 3, 64, 64)
R50_FWD_TOL = 1e-3
R50_FC_GRAD_TOL = 5e-3
R50_GRAD_L2_TOL = 0.1
# 13a: LeNet's step through the Adam kernel against the plain update, from
# the same weights and the same gradients (cuDNN run deterministic for the
# two backward passes): the loss and gradients the same to f32 noise, the
# parameters to ADAM_TOL
LENET_GRAD_RTOL = 1e-6
# phase 14: the high-level API. 14a is BASELINE config #1 as the
# reference's hapi test runs it (Model(LeNet()) with Adam(1e-3),
# CrossEntropyLoss and Accuracy, fit over the synthetic MNIST at batch
# 64); 14b MobileNetV2 at ImageNet width (1000 classes, 3 x 224 x 224 crops
# of FakeData's 256 x 256 images, batch 128) in fp16 O1 with dynamic loss
# scaling and Momentum(0.1, 0.9, L2Decay(4e-5)); 14c VGG-16 the same way at
# batch 64
FIT_EPOCHS = 2
PROFILE_ITERS = 10  # steps of the profiled fit
MOBILE_BATCH, MOBILE_SIZE, MOBILE_STEPS = 128, 224, 20
IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
VGG_BATCH, VGG_SIZE, VGG_STEPS = 64, 224, 5
# the kinds a profile's device operations are summed by, first match wins
# sessions of a step profile whose kernel counts are held exactly: the
# profiler now and then drops a few of a session's records
PROFILE_ATTEMPTS = 3

DEVICE_OP_KINDS = (
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions and GEMMs", ("conv", "xmma", "gemm", "cudnn", "wgrad",
                                "dgrad", "sm90_", "sm80_", "cutlass")),
    ("Adam (#7)", ("adam_update", "grad_sumsq", "grad_norm_finish")),
    ("reductions", ("reduce_kernel",)),
    ("pooling", ("max_pool", "avg_pool", "adaptive")),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise",)),
)


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


def device_ms(fn, what, iters=20, attempts=10, per_call=1):
    """Device time of one call of ``fn``: the summed duration of the
    kernels it launches (``torch.profiler``), without the host's launch
    gaps that CUDA events over back-to-back calls also count. Each
    profiler session first runs a warm-up window of ``iters`` calls whose
    records it discards, then the measured window. Now and then the
    profiler records no kernel of a window, or only some of them (a sum a
    third short, seen at L = 8192 without the warm-up window): a window
    with fewer device operations than ``per_call`` a call (each call
    launches at least that many) is taken again, after a pause, up to
    ``attempts`` sessions; then the run fails, naming ``what`` was timed.
    (A window of the Adam kernel once held half its launches and timed
    it at twice its bound: its calls launch 2.) (Five sessions in a row
    were once short by a third or more, early in the script.)"""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        got = {}

        def ready(prof):
            ops = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            got["total"] = sum(getattr(e, "self_device_time_total", 0.0)
                               for e in ops)
            got["count"] = sum(e.count for e in ops)

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):  # the warm-up window, the measured one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen.append(got.get("count", 0))
        if got.get("total", 0) > 0 and got["count"] >= iters * per_call:
            return got["total"] / iters / 1e3
        time.sleep(0.5)
    raise RuntimeError(f"device time of {what}: the profiler recorded "
                       f"{seen} device operations in {attempts} windows of "
                       f"{iters} calls (fewer than calls)")


def in_turn(fns):
    """One callable that runs ``fns`` in turn, a call each. Given the same
    call on distinct copies of its inputs, which together are well over the
    50 MB L2, each call finds its inputs in HBM, as a training step does."""
    turn = itertools.cycle(fns)
    return lambda: next(turn)()


def worst(got, ref, atol, rtol):
    """(max |got - ref|, whether every element is within tolerance)."""
    got, ref = got.detach(), ref.detach()
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + rtol * ref.float().abs()).all())
    return float(d.max()), ok


def bwd_report(res, res32, res_d):
    """The log text of ``check_flash_backward``'s results."""
    if res32:
        rtol, share = FLASH_BWD_BF16_TOL
        tol = (f"tol {rtol:.4g}|ref| + {share:.4g} max|ref|); vs f32 plain "
               + "/".join(f"{e:.3g}" for e, _ in res32)
               + f" (tol {BF16_VS_F32_REL_TOL:.4g} max|ref|)")
    else:
        tol = f"tol {FLASH_BWD_TOL})"
    return ("dq/dk/dv max err " + "/".join(f"{e:.3g}" for e, _ in res)
            + f" ({tol}; delta err {res_d[0]:.3g} (tol d 2^-23 sum|dO O|)")


def share_worst(got, ref, share):
    """(max |got - ref|, whether it is within ``share`` of max|ref|)."""
    d = float((got.float() - ref.float()).abs().max())
    return d, d <= share * float(ref.float().abs().max())


def check_flash_backward(flash_tpu, q, k, v, do, out, lse, causal, kb):
    """One dQ (with delta) and one dK/dV launch against the plain
    versions: f32 within FLASH_BWD_TOL; bf16 within FLASH_BWD_BF16_TOL of
    the plain version with bf16-rounded P and dS and within
    BF16_VS_F32_REL_TOL of the f32 one; delta within f32 sum-order error
    (d·2^-23·Σ|dO·O|) of ``_delta``. Returns (per-tensor (err, ok) for
    dq/dk/dv, the f32 comparison's (bf16 only, else []), delta's (err,
    ok))."""
    if causal:
        dq, delta = flash_tpu.flash_bwd_dq(q, k, v, do, lse, out)
        dk, dv = flash_tpu.flash_bwd_dkv(q, k, v, do, lse, delta)
    else:
        dq, delta = flash_tpu.flash_bwd_dq_full(q, k, v, do, lse, out, kb)
        dk, dv = flash_tpu.flash_bwd_dkv_full(q, k, v, do, lse, delta, kb)
    torch.cuda.synchronize()
    got = (dq, dk, dv)
    ddiff = (delta - flash_tpu._delta(out, do)).abs()
    bound = q.shape[-1] * 2.0 ** -23 * torch.einsum(
        "blhd,blhd->bhl", do.float().abs(), out.float().abs())
    res_d = (float(ddiff.max()), bool((ddiff <= bound).all()))
    if q.dtype == torch.float32:
        ref = flash_tpu._flash_bwd_reference(q, k, v, out, lse, do, causal,
                                             kb)
        return [worst(a, b, *FLASH_BWD_TOL) for a, b in zip(got, ref)], \
            [], res_d
    ref = flash_tpu._flash_bwd_reference(q, k, v, out, lse, do, causal, kb,
                                         operand_dtype=torch.bfloat16)
    rtol, share = FLASH_BWD_BF16_TOL
    res = [worst(a, b, share * float(b.float().abs().max()), rtol)
           for a, b in zip(got, ref)]
    del ref
    ref32 = flash_tpu._flash_bwd_reference(
        *(t.float() for t in (q, k, v, out)), lse, do.float(), causal, kb)
    res32 = [share_worst(a, b, BF16_VS_F32_REL_TOL)
             for a, b in zip(got, ref32)]
    return res, res32, res_d


def ln_bound(rows, hidden, dtype):
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * rows * hidden + 2 * hidden) * esize
    flops = 8 * rows * hidden  # mean 1, var 3, affine 4 per element (f32)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def ln_bwd_bound(rows, hidden, dtype):
    esize = torch.finfo(dtype).bits // 8
    # x, g read and dx written; w read, dw and db written
    nbytes = (3 * rows * hidden + 3 * hidden) * esize
    flops = 15 * rows * hidden  # statistics, x^, two means, dx, dw, db
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def flash_bound(b, L, H, d, dtype, kernel="fwd", causal=True):
    """The least time of one attention kernel's own function: the
    forward's 2 products (QKᵀ, PV) with out and lse written; dQ's 3 (S, dP,
    dS·K) with q, k, v, O, dO and lse read, dQ and delta written; dK/dV's 4
    (S, dP, dSᵀ·Q, Pᵀ·dO) with q, k, v, dO and the f32 lse, delta read and
    dK, dV written. (The whole backward needs 5: S and dP once.) Each
    product runs over the pairs k <= q (causal) or all L x L."""
    esize = torch.finfo(dtype).bits // 8
    products, nbytes = {
        "fwd": (2, 4 * b * L * H * d * esize + b * H * L * 4),
        "dq": (3, 6 * b * L * H * d * esize + 2 * b * H * L * 4),
        "dkv": (4, 6 * b * L * H * d * esize + 2 * b * H * L * 4)}[kernel]
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = products * 2 * d * b * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def adam_bound(numels, grad_esize, low_esize):
    # grad read, master/m/v read and written, the bf16 copy written
    nbytes = sum(numels) * (grad_esize + 24 + low_esize)
    flops = 20 * sum(numels)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def bert_param_shapes(cfg):
    """Shapes of BertForPretraining's parameters (157 for BERT-base)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    layer = [(h, 3 * h), (3 * h,), (h, h), (h,), (h,), (h,), (h, f), (f,),
             (f, h), (h,), (h,), (h,)]
    return ([(cfg.vocab_size, h), (cfg.max_position_embeddings, h),
             (cfg.type_vocab_size, h), (h,), (h,)]
            + layer * cfg.num_layers + [(h, h), (h,), (h, h), (h,), (h,),
                                        (h,), (h, 2), (2,)])


def gpt_param_shapes(cfg):
    """Shapes of GPTForCausalLM's parameters (292 for GPT-2 345M)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    layer = [(h,), (h,), (h, 3 * h), (3 * h,), (h, h), (h,), (h,), (h,),
             (h, f), (f,), (f, h), (h,)]
    return ([(cfg.vocab_size, h), (cfg.max_position_embeddings, h)]
            + layer * cfg.num_layers + [(h,), (h,)])


@contextlib.contextmanager
def plain_kernels(gpt_mod, fused, flash_tpu, norm_mod, bert_mod, attention):
    """Run the models' LayerNorms and attention (forward and, through
    autograd, backward) and the optimizer's Adam through the kernels'
    plain PyTorch versions (the comparison path of phases 4, 7 and 9).
    The LayerNorm layer lives in ``nn.layer.norm``; the GPT decode path
    calls ``fused_layer_norm`` from the GPT module itself."""
    saved = (norm_mod.fused_layer_norm, gpt_mod.fused_layer_norm,
             gpt_mod.dot_product_attention, bert_mod.dot_product_attention,
             fused.fused_adam_step)

    def bert_attention(q, k, v, causal=False, bias=None, layout="bhld"):
        if bias is not None:
            return attention.xla_attention(q, k, v, causal, bias, layout)
        return flash_tpu._flash_reference(q, k, v, causal)[0]

    norm_mod.fused_layer_norm = fused._ln_reference
    gpt_mod.fused_layer_norm = fused._ln_reference
    gpt_mod.dot_product_attention = \
        lambda q, k, v, causal, layout, **_: \
        flash_tpu._flash_reference(q, k, v)[0]
    bert_mod.dot_product_attention = bert_attention
    fused.fused_adam_step = fused._fused_adam_reference
    try:
        yield
    finally:
        (norm_mod.fused_layer_norm, gpt_mod.fused_layer_norm,
         gpt_mod.dot_product_attention, bert_mod.dot_product_attention,
         fused.fused_adam_step) = saved


def profile_serving(model, serve_cfg, prompts, engine_cls, run_streams,
                    tag="5", new_tokens=8):
    """Device busy share of the serving loop: ``torch.profiler`` over a
    closed-loop run (one request a prompt, ``new_tokens`` new tokens each)
    on a fresh engine; prints the busy share and the device time by
    kernel under ``[tag]``. Returns the busy share, the top kernels and
    the run's requests."""
    from torch.profiler import ProfilerActivity, profile

    engine = engine_cls(model, serve_cfg)
    engine.start()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_streams(engine, n_streams=len(prompts),
                          requests_per_stream=1,
                          prompt_fn=lambda i: prompts[i],
                          max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.shutdown()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
           "busy_share": None, "top": [], "requests": res["requests"]}
    if busy_us <= 0:
        log(f"[{tag}] profile: the profiler saw no device time (device "
            "busy share not measured)")
        return out
    out["busy_share"] = busy_us / wall_us
    log(f"[{tag}] profile: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, busy share {busy_us / wall_us:.4f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        out["top"].append([e.key[:90], dev_us(e) / 1e3, e.count])
        log(f"[{tag}] profile: {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    return out


def check_backward_kernels(dev, rnd, fused, flash_tpu, err):
    """Phase 3b: the LayerNorm backward, flash dQ (with delta) / dK-dV and
    Adam kernels against their plain versions on the card, in f32 and
    bf16 (the flash backward also on q/k/v as views of GPT's fused QKV
    projection)."""
    for dtype in DTYPES:
        tol = LN_BWD_TOL[dtype]
        for rows, hidden, off, want in ln_cases(LN_BWD_ROWS):
            x, g = rnd(rows, hidden, dtype=dtype), rnd(rows, hidden,
                                                        dtype=dtype)
            x = misaligned(x) if off else x
            w = rnd(hidden, dtype=dtype)
            got = fused.layer_norm_bwd(x, w, g)
            again = fused.layer_norm_bwd(x, w, g)
            torch.cuda.synchronize()
            ref = fused._ln_bwd_reference(x, w, g)
            res = [worst(a, b, *tol) for a, b in zip(got, ref)]
            err["layer_norm_bwd"] = max(err["layer_norm_bwd"],
                                        *(e for e, _ in res))
            # dw/db: partials summed in a fixed order, the same bits twice
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"[3b] layer_norm_bwd {str(dtype)[6:]} rows={rows} "
                f"hidden={hidden}{' misaligned' if off else ''} "
                f"({ln_variant(fused, want, x, w, g, got[0], backward=True)})"
                ": "
                f"dx/dw/db max err "
                + "/".join(f"{e:.3g}" for e, _ in res) + f" (tol {tol}); "
                f"bitwise equal over two calls: {same}")
            if not all(ok for _, ok in res):
                raise AssertionError("layer_norm_bwd kernel disagrees")
            if not same:
                raise AssertionError("layer_norm_bwd is not deterministic")
        for shape, fused_qkv in ([(sh, False) for sh in FLASH_BWD_SHAPES]
                                 + [(GPT_ATTN_SHAPE, True)]):
            q, k, v, do = attn_operands(rnd, shape, dtype, fused_qkv)
            out, lse = flash_tpu._fwd(q, k, v)
            res, res32, res_d = check_flash_backward(flash_tpu, q, k, v, do,
                                                     out, lse, True, None)
            err["flash_attn_bwd_dq"] = max(err["flash_attn_bwd_dq"],
                                           res[0][0])
            err["flash_attn_bwd_dkv"] = max(err["flash_attn_bwd_dkv"],
                                            res[1][0], res[2][0])
            log(f"[3b] flash_bwd {str(dtype)[6:]} (b,L,H,d)={shape}"
                + (f" as fused-QKV views (row stride {q.stride(1)})"
                   if fused_qkv else "") + ": " + bwd_report(res, res32,
                                                             res_d))
            if not all(ok for _, ok in res + res32 + [res_d]):
                raise AssertionError("flash backward kernels disagree")
            del q, k, v, do, out, lse
    # the plain backward is itself the gradient of the plain forward
    shape = (2, 256, 4, 64)
    q, k, v, do = (rnd(*shape, dtype=torch.float32) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_tpu._flash_reference(*leaves)
    auto = torch.autograd.grad(out, leaves, do)
    mirror = flash_tpu._flash_bwd_reference(q, k, v, out.detach(), lse, do)
    res = [worst(a, b, *FLASH_BWD_AUTOGRAD_TOL) for a, b in zip(mirror,
                                                                auto)]
    log(f"[3b] plain flash backward vs autograd of the plain forward "
        f"(f32, {shape}): max err "
        + "/".join(f"{e:.3g}" for e, _ in res)
        + f" (tol {FLASH_BWD_AUTOGRAD_TOL})")
    if not all(ok for _, ok in res):
        raise AssertionError("the plain flash backward is not the gradient")

    gen = torch.Generator(device=dev).manual_seed(1)
    for master in (True, False):
        low = torch.bfloat16 if master else torch.float32
        f32 = [torch.randn(n, device=dev, generator=gen) for n in ADAM_NUMELS]
        # per-tensor step counts 0..4: each member's own beta powers
        got = dict(
            P=[p.to(low) for p in f32],
            G=[torch.randn(n, device=dev, generator=gen).to(low)
               for n in ADAM_NUMELS],
            M=[torch.zeros(n, device=dev) for n in ADAM_NUMELS],
            V=[torch.zeros(n, device=dev) for n in ADAM_NUMELS],
            P1=[torch.full((), 0.9 ** i, device=dev)
                for i in range(len(ADAM_NUMELS))],
            P2=[torch.full((), 0.999 ** i, device=dev)
                for i in range(len(ADAM_NUMELS))],
            MS=[p.clone() for p in f32] if master else None)
        del f32
        want = {key: [t.clone() for t in val] if val is not None else None
                for key, val in got.items()}
        want["G"] = got["G"]
        lr = torch.full((), TRAIN_LR, device=dev)
        for _ in range(3):
            fused.fused_adam_step(got["P"], got["G"], got["M"], got["V"],
                                  got["P1"], got["P2"], lr,
                                  masters=got["MS"])
            fused._adam_reference(want["P"], want["G"], want["M"],
                                  want["V"], want["P1"], want["P2"], lr,
                                  masters=want["MS"])
        torch.cuda.synchronize()
        errs = {}
        for key in ("P", "MS", "M", "V", "P1", "P2"):
            if got[key] is None:
                continue
            res = [worst(a, b, *ADAM_TOL) for a, b in zip(got[key],
                                                          want[key])]
            errs[key] = max(e for e, _ in res)
            if not all(ok for _, ok in res):
                raise AssertionError(f"adam kernel disagrees on {key}")
        err["adam"] = max(err["adam"], *errs.values())
        log(f"[3b] adam {'master (bf16 + f32 master)' if master else 'f32'}"
            f", numel {ADAM_NUMELS}, 3 steps: max err "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f" (tol {ADAM_TOL})")
        del got, want
        torch.cuda.empty_cache()


def time_backward_kernels(dev, rnd, fused, flash_tpu, cfg):
    """Phase 3b timings at the training step's shapes (bf16)."""
    F = torch.nn.functional
    timings = []
    # GPT's and BERT's shapes, and at GPT's the block kernels (on a
    # misaligned view), the kernels before the warp kernels
    for (rows, hidden), kernel in ([(sh, "layer_norm_bwd") for sh in LN_TIMED]
                                   + [(LN_TIMED[0], "layer_norm_bwd_block")]):
        w, b = (rnd(hidden, dtype=torch.bfloat16) for _ in range(2))
        # LN_COPIES of (x, g) and of F.layer_norm's graph, for the time
        # with the inputs out of the L2
        copies = []
        for _ in range(LN_COPIES):
            x, g = (rnd(rows, hidden, dtype=torch.bfloat16) for _ in range(2))
            x = misaligned(x) if kernel.endswith("block") else x
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            y = F.layer_norm(leaves[0], (hidden,), leaves[1], leaves[2], 1e-5)
            copies.append((x, g, leaves, y))
        kerns = [lambda x=x, g=g: fused.layer_norm_bwd(x, w, g)
                 for x, g, _, _ in copies]
        libs = [lambda g=g, leaves=leaves, y=y: torch.autograd.grad(
                    y, leaves, g, retain_graph=True)
                for _, g, leaves, y in copies]
        kern, lib = in_turn(kerns), in_turn(libs)
        x, g = copies[0][:2]
        what = f"{kernel} {[rows, hidden]}"
        bound, by = ln_bwd_bound(rows, hidden, torch.bfloat16)
        timings.append({
            "kernel": kernel, "shape": [rows, hidden],
            "dtype": "bfloat16", "ms": time_ms(kern),
            "plain_ms": time_ms(lambda: fused._ln_bwd_reference(x, w, g)),
            "library_ms": time_ms(lib),
            "device_ms": device_ms(kern, what, iters=4 * LN_COPIES),
            "library_device_ms": device_ms(lib, f"autograd of F.layer_norm "
                                           f"{[rows, hidden]}",
                                           iters=4 * LN_COPIES),
            # one copy, called again and again: its inputs stay in the L2
            "device_l2_ms": device_ms(kerns[0], what + " in the L2"),
            "library_device_l2_ms": device_ms(
                libs[0], f"autograd of F.layer_norm {[rows, hidden]} in the "
                "L2"),
            "bound_ms": bound, "bound_by": by})
        del copies, kerns, libs, kern, lib, x, g

    shape = (TRAIN_SHAPE[0], TRAIN_SHAPE[1], cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    q, k, v, do = (rnd(*shape, dtype=torch.bfloat16) for _ in range(4))
    out, lse = flash_tpu._fwd(q, k, v)
    _, delta = flash_tpu.flash_bwd_dq(q, k, v, do, lse, out)
    lt = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    ys = F.scaled_dot_product_attention(*lt, is_causal=True)
    lib = lambda: torch.autograd.grad(ys, lt, do.transpose(1, 2),
                                      retain_graph=True)
    plain_ms = time_ms(lambda: flash_tpu._flash_bwd_reference(
        q, k, v, out, lse, do, operand_dtype=torch.bfloat16), iters=5, warmup=1)
    lib_ms, lib_dev = time_ms(lib, iters=20), device_ms(
        lib, f"SDPA's causal backward {list(shape)}")
    for name, kern in (
            ("dq", lambda: flash_tpu.flash_bwd_dq(q, k, v, do, lse, out)),
            ("dkv", lambda: flash_tpu.flash_bwd_dkv(q, k, v, do, lse,
                                                    delta))):
        bound, by = flash_bound(*shape, torch.bfloat16, name)
        timings.append({
            "kernel": f"flash_attn_bwd_{name}", "shape": list(shape),
            "dtype": "bfloat16", "ms": time_ms(kern, iters=20),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_ms": device_ms(kern, f"flash_attn_bwd_{name} {shape}"),
            "library_device_ms": lib_dev, "bound_ms": bound, "bound_by": by,
            "note": "plain and library times are the whole backward "
                    "(dQ, dK and dV)"})
    del q, k, v, do, out, lse, delta, lt, ys

    shapes = gpt_param_shapes(cfg)
    numels = [int(np.prod(s)) for s in shapes]
    gen = torch.Generator(device=dev).manual_seed(2)
    masters = [torch.randn(n, device=dev, generator=gen) for n in numels]
    params = [m.to(torch.bfloat16) for m in masters]
    grads = [torch.randn(n, device=dev, generator=gen).to(torch.bfloat16)
             for n in numels]
    zeros = lambda: [torch.zeros(n, device=dev) for n in numels]
    ms_, vs_ = zeros(), zeros()
    p1 = [torch.ones((), device=dev) for _ in numels]
    p2 = [torch.ones((), device=dev) for _ in numels]
    lr = torch.full((), TRAIN_LR, device=dev)
    args = (params, grads, ms_, vs_, p1, p2, lr)
    kern = lambda: fused.fused_adam_step(*args, masters=masters)
    plain = lambda: fused._adam_reference(*args, masters=masters)
    kern_ms = time_ms(kern, iters=10)
    kern_dev = device_ms(kern, f"adam over {len(numels)} tensors", iters=5,
                         per_call=2)
    plain_ms = time_ms(plain, iters=3, warmup=1)
    del params, grads, ms_, vs_, masters
    torch.cuda.empty_cache()
    # torch.optim.Adam(fused=True) over f32 params of the same sizes: a
    # time yardstick only (its eps is bias-corrected, the port's is not)
    lib_p = [torch.zeros(n, device=dev, requires_grad=True) for n in numels]
    for p in lib_p:
        p.grad = torch.randn(p.numel(), device=dev, generator=gen)
    opt = torch.optim.Adam(lib_p, lr=TRAIN_LR, fused=True)
    lib_ms = time_ms(opt.step, iters=10)
    lib_dev = device_ms(opt.step, "torch.optim.Adam(fused=True)", iters=5)
    del lib_p, opt
    torch.cuda.empty_cache()
    bound, by = adam_bound(numels, 2, 2)
    timings.append({
        "kernel": "adam", "shape": [len(numels), sum(numels)],
        "dtype": "bf16 params + f32 masters", "ms": kern_ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": kern_dev,
        "library_device_ms": lib_dev, "bound_ms": bound, "bound_by": by})
    for t in timings:
        log(f"[3b] time {t['kernel']} {t['shape']}: kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
    return timings


def profiled_session(run, warmup):
    """The device operations (``key_averages``) and the wall microseconds
    of ``run()`` under ``torch.profiler``, after ``warmup()`` in a first
    window of the same session whose records are discarded: the first
    kernels of a session are sometimes missing from its records (a few
    forward launches of a step, every session alike), as ``device_ms``
    found for its windows."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {}

    def ready(prof):
        # the schedule's own range, ``ProfilerStep*``, carries the device
        # time of every kernel in the window: not a device operation
        got["ops"] = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("ProfilerStep")]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        warmup()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    return got.get("ops", []), wall_us


def check_attention_in_profile(kernels, phase, want, n_steps=2):
    """The profiled steps' bf16 attention ran on the tensor-core kernels
    only: ``want`` launches each of ``flash_fwd_mma_kernel``,
    ``flash_dq_mma_kernel`` and ``flash_dkv_mma_kernel`` and none of the
    scalar ``flash_fwd_kernel``, ``flash_dq_kernel`` and
    ``flash_dkv_kernel``, printed by name; also prints the ``gemv``
    launches per step."""
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    for what in ("fwd", "dq", "dkv"):
        mma = [e for e in kernels if f"flash_{what}_mma_kernel" in e.key]
        scalar = [e for e in kernels if f"flash_{what}_kernel<" in e.key]
        for e in mma + scalar:
            log(f"[{phase}] profile, attention {what}: {dev_us(e) / 1e3:9.3f}"
                f" ms  x{e.count:<6d} {e.key[:90]}")
        n = sum(e.count for e in mma)
        if n != want or scalar:
            raise AssertionError(
                f"phase {phase}'s profile shows {n} tensor-core attention "
                f"{what} launches (expected {want}) and "
                f"{sum(e.count for e in scalar)} scalar ones")
    gemv = [e for e in kernels if "gemv" in e.key]
    log(f"[{phase}] profile: {sum(e.count for e in gemv) / n_steps:g} gemv "
        f"launches per step ({sum(dev_us(e) for e in gemv) / n_steps / 1e3:.3f}"
        " ms)")


def check_layer_norm_in_profile(kernels, phase, want, n_steps=2):
    """Every LayerNorm launch of the profiled steps ran the warp-per-row
    kernels: ``want`` launches each of ``ln_fwd_warp_kernel``,
    ``ln_bwd_warp_kernel`` and ``ln_bwd_reduce_kernel`` and none of the
    block kernels ``ln_fwd_kernel`` and ``ln_bwd_rows_kernel``; prints
    them by name with their device time per step."""
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    counts = {}
    for name in ("ln_fwd_warp_kernel<", "ln_bwd_warp_kernel<",
                 "ln_bwd_reduce_kernel<", "ln_fwd_kernel<",
                 "ln_bwd_rows_kernel<"):
        found = [e for e in kernels if name in e.key]
        for e in found:
            log(f"[{phase}] profile, layer norm: "
                f"{dev_us(e) / n_steps / 1e3:9.3f} ms per step  "
                f"x{e.count:<6d} {e.key[:90]}")
        counts[name] = sum(e.count for e in found)
    if [counts[n] for n in list(counts)[:3]] != [want] * 3 \
            or counts["ln_fwd_kernel<"] or counts["ln_bwd_rows_kernel<"]:
        raise AssertionError(f"phase {phase}'s profile shows LayerNorm "
                             f"launches {counts} (expected {want} of each "
                             "warp kernel and the reduce, none of the block "
                             "kernels)")


def profile_training(step, ids, labels, n_layers):
    """Device busy share of two training steps under ``torch.profiler``
    (``profiled_session``, after a warm-up step), the device time by
    kernel, and the forward kernel by name. A session whose records fall
    short of the launches is taken again, up to ``PROFILE_ATTEMPTS``
    sessions, each held to the exact counts."""
    def two_steps():
        for _ in range(2):
            step((ids, labels), (labels,))

    for attempt in range(PROFILE_ATTEMPTS):
        kernels, wall_us = profiled_session(
            two_steps, lambda: step((ids, labels), (labels,)))
        dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
        busy_us = sum(dev_us(e) for e in kernels)
        if busy_us <= 0:
            log("[8] profile: the profiler saw no device time (device busy "
                "share not measured)")
            return None
        log(f"[8] profile (2 steps): wall {wall_us / 1e3:.1f} ms, device "
            f"busy {busy_us / 1e3:.1f} ms, busy share "
            f"{busy_us / wall_us:.4f}")
        for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
            log(f"[8] profile: {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:90]}")
        try:
            check_attention_in_profile(kernels, 8, 2 * n_layers)
            check_layer_norm_in_profile(kernels, 8, 2 * (2 * n_layers + 1))
            break
        except AssertionError as e:
            if attempt + 1 == PROFILE_ATTEMPTS:
                raise
            log(f"[8] profile session {attempt + 1}: {e}; profiling again")
    return {"device_ms_per_step": busy_us / 1e3 / 2,
            "busy_share": busy_us / wall_us}


def attn_operands(rnd, shape, dtype, fused_qkv=False):
    """q, k, v and dO of ``shape`` (b, L, H, d). With ``fused_qkv``, q/k/v
    are the [b, L, H, d] views of one [b, L, 3·H·d] tensor that BERT's
    fused QKV projection gives the kernels (row stride 3·H·d)."""
    b, L, H, d = shape
    if not fused_qkv:
        return tuple(rnd(*shape, dtype=dtype) for _ in range(4))
    qkv = rnd(b, L, 3 * H * d, dtype=dtype)
    q, k, v = (t.view(shape) for t in qkv.split(H * d, dim=-1))
    return q, k, v, rnd(*shape, dtype=dtype)


def ln_cases(rows_list):
    """(rows, hidden, misaligned, kernels) of the LayerNorm checks."""
    return ([(r, h, False, want) for h, want in LN_HIDDEN for r in rows_list]
            + [(r, h, True, "block") for h in LN_MISALIGNED_HIDDEN
               for r in rows_list])


def misaligned(t):
    """A contiguous copy of ``t`` whose data pointer is one element past an
    allocation's start (not 16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def ln_variant(fused, want, x, *others, backward=False):
    """The kernels ``_ln_plan`` gives this call, which must be ``want``."""
    rows, hidden = x.numel() // x.shape[-1], x.shape[-1]
    plan = fused._ln_plan(rows, hidden, x.dtype,
                          fused._alignment(x, *others), backward)
    if plan.variant != want:
        raise AssertionError(f"LayerNorm plan {plan} for {tuple(x.shape)} "
                             f"{x.dtype}, expected {want}")
    return plan.variant


def padding_bias(b, L, gen, dev):
    """BERT's key-padding bias for random valid lengths (1..L per
    sequence): 0 on the kept keys, -1e9 on the padded ones, f32 [b, L]."""
    lengths = torch.randint(1, L + 1, (b,), device=dev, generator=gen)
    keep = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    return torch.where(keep, 0.0, -1e9).float()


def check_bert_kernels(dev, rnd, gen, fused, flash_tpu, dkv_mod, bert_cfg,
                       err):
    """Phase 3c: the full-attention forward, dQ (with delta) and dK/dV
    kernels (#4), without and with a key-padding bias, the packed dK/dV
    (#8, also against the causal dK/dV kernel #3) and the AdamW mode of
    the Adam kernel against their plain versions on the card."""
    # the shapes with dense operands, then BERT's with q/k/v as the main
    # path passes them (strided views of one fused QKV projection), then
    # padded batches: a key bias of random valid lengths
    cases = ([(shape, False, False) for shape in FULL_SHAPES]
             + [(BERT_ATTN_SHAPE, True, False), (BERT_ATTN_SHAPE, True, True),
                ((4, 200, 12, 64), False, True)])
    for dtype in DTYPES:
        out_tol, lse_tol = FLASH_OUT_TOL[dtype], FLASH_LSE_TOL[dtype]
        for shape, fused_qkv, biased in cases:
            q, k, v, do = attn_operands(rnd, shape, dtype, fused_qkv)
            kb = padding_bias(shape[0], shape[1], gen, dev) if biased \
                else None
            out, lse = flash_tpu._fwd(q, k, v, False, kb)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_tpu._flash_reference(q, k, v, False, kb)
            e_o, ok_o = worst(out, ref_out, *out_tol)
            e_l, ok_l = worst(lse, ref_lse, *lse_tol)
            del ref_out, ref_lse
            res, res32, res_d = check_flash_backward(flash_tpu, q, k, v, do,
                                                     out, lse, False, kb)
            err["flash_attn_fwd_full"] = max(err["flash_attn_fwd_full"],
                                             e_o, e_l)
            err["flash_attn_bwd_dq_full"] = max(
                err["flash_attn_bwd_dq_full"], res[0][0])
            err["flash_attn_bwd_dkv_full"] = max(
                err["flash_attn_bwd_dkv_full"], res[1][0], res[2][0])
            log(f"[3c] flash full {str(dtype)[6:]} (b,L,H,d)={shape}"
                + (" as fused-QKV views (row stride "
                   f"{q.stride(1)})" if fused_qkv else "")
                + (" with a key bias (valid lengths "
                   f"{(kb == 0).sum(1).tolist()[:8]}...)" if biased else "")
                + ": out "
                f"err {e_o:.3g} (tol {out_tol}), lse err {e_l:.3g} (tol "
                f"{lse_tol}); " + bwd_report(res, res32, res_d))
            if not (ok_o and ok_l
                    and all(ok for _, ok in res + res32 + [res_d])):
                raise AssertionError("full-attention kernels disagree")
            del q, k, v, do, kb, out, lse
    torch.cuda.empty_cache()

    for shape in PACKED_SHAPES:  # (b, L, H, d), bf16
        q, k, v, do = (rnd(*shape, dtype=torch.bfloat16) for _ in range(4))
        out, lse = flash_tpu._fwd(q, k, v)
        delta = flash_tpu._delta(out, do)
        bhld = lambda t: t.transpose(1, 2).contiguous()
        args4 = (bhld(q), bhld(k), bhld(v), bhld(do), lse, delta)
        # the first call under the profiler: every launch on the
        # tensor-core kernel, none on another kernel of that name
        found = kernel_launches(lambda: dkv_mod.dkv_call(*args4),
                                f"dkv_packed {shape}")
        mma = sum(n for key, n in found.items()
                  if "dkv_packed_mma_kernel<" in key)
        other = {key: n for key, n in found.items() if "dkv_packed" in key
                 and "dkv_packed_mma_kernel<" not in key}
        dk, dv = dkv_mod.dkv_call(*args4)
        dk2, dv2 = dkv_mod.dkv_call(*args4)
        dk3, dv3 = flash_tpu.flash_bwd_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        same = torch.equal(dk, dk2) and torch.equal(dv, dv2)
        # at d = 64 the scale is 2^-3, bf16(q * scale) is exact, and #8
        # runs #3's loop and numerics on the same values: the same bits
        same3 = torch.equal(dk, bhld(dk3)) and torch.equal(dv, bhld(dv3))
        ref = dkv_mod._dkv_packed_reference(*args4)
        res = [packed_worst(a, b) for a, b in zip((dk, dv), ref)]
        res3 = [packed_worst(a, bhld(b)) for a, b in zip((dk, dv),
                                                          (dk3, dv3))]
        err["dkv_packed"] = max(err["dkv_packed"], *(e for e, _ in res))
        log(f"[3c] dkv_packed bf16 (b,L,H,d)={shape}: dk/dv max err vs plain "
            + "/".join(f"{e:.3g}" for e, _ in res) + ", vs the causal dK/dV "
            "kernel (#3, tensor cores) "
            + "/".join(f"{e:.3g}" for e, _ in res3)
            + f" (tol {PACKED_REL_TOL:.4g} x max|ref|); same bits over two "
            f"calls {same}, as #3's {same3}; profile: {mma} launch(es) of "
            f"dkv_packed_mma_kernel, others {other}")
        if not all(ok for _, ok in res + res3):
            raise AssertionError("packed dK/dV kernel disagrees")
        if not same:
            raise AssertionError("packed dK/dV kernel gives other bits on a "
                                 "second call")
        if shape[3] == 64 and not same3:
            raise AssertionError("at d = 64 the packed dK/dV kernel and the "
                                 "causal dK/dV kernel give other bits")
        if mma != 1 or other:
            raise AssertionError(f"packed dK/dV's profile shows {mma} "
                                 f"tensor-core launches (expected 1) and "
                                 f"{other}")
        del q, k, v, do, out, lse, delta, args4, dk, dv, dk2, dv2, dk3, dv3
        del ref
    torch.cuda.empty_cache()

    # AdamW over BERT-base's 157 f32 tensors (no masters), decay on the
    # matrices only, per-tensor step counts 0..4
    numels = [int(np.prod(s)) for s in bert_param_shapes(bert_cfg)]
    decay = [0.01 if len(s) == 2 else 0.0 for s in bert_param_shapes(
        bert_cfg)]
    gen = torch.Generator(device=dev).manual_seed(3)
    got = dict(
        P=[torch.randn(n, device=dev, generator=gen) for n in numels],
        M=[torch.zeros(n, device=dev) for n in numels],
        V=[torch.zeros(n, device=dev) for n in numels],
        P1=[torch.full((), 0.9 ** (i % 5), device=dev)
            for i in range(len(numels))],
        P2=[torch.full((), 0.999 ** (i % 5), device=dev)
            for i in range(len(numels))])
    want = {key: [t.clone() for t in val] for key, val in got.items()}
    grads = [torch.randn(n, device=dev, generator=gen) for n in numels]
    lr = torch.full((), TRAIN_LR, device=dev)
    for _ in range(3):
        fused.fused_adam_step(got["P"], grads, got["M"], got["V"],
                              got["P1"], got["P2"], lr,
                              decoupled_decay=decay)
        fused._adam_reference(want["P"], grads, want["M"], want["V"],
                              want["P1"], want["P2"], lr,
                              decoupled_decay=decay)
    torch.cuda.synchronize()
    errs = {}
    for key in got:
        res = [worst(a, b, *ADAM_TOL) for a, b in zip(got[key], want[key])]
        errs[key] = max(e for e, _ in res)
        if not all(ok for _, ok in res):
            raise AssertionError(f"adam kernel (AdamW mode) disagrees on "
                                 f"{key}")
    err["adam"] = max(err["adam"], *errs.values())
    log(f"[3c] adamw f32, {len(numels)} tensors / {sum(numels)} params, 3 "
        "steps: max err " + ", ".join(f"{k} {e:.3g}" for k, e in
                                      errs.items()) + f" (tol {ADAM_TOL})")
    del got, want, grads
    torch.cuda.empty_cache()


def sumsq_bound(numels, esize):
    # each gradient read once; a multiply-add per element (f32)
    nbytes = sum(numels) * esize + 8
    flops = 2 * sum(numels)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def check_clip_kernels(dev, cfg, fused, err):
    """Phase 12a: the sum-of-squares kernel (``grad_global_norm``)
    against ``_global_norm_reference`` on GPT-2 345M's 292 bf16 gradients
    (relative NORM_RTOL, the same bits over two calls), and one AdamW step
    with the clip folded in (bf16 params, f32 masters, per-tensor L2 and
    decoupled decay on the matrices) against ``_adam_reference`` given the
    kernel's scale, to ADAM_TOL; then their times. Returns the timings of
    the sum-of-squares pass and of the clip-scaled Adam."""
    numels = [int(np.prod(s)) for s in gpt_param_shapes(cfg)]
    gen = torch.Generator(device=dev).manual_seed(12)
    grads = [(torch.randn(n, device=dev, generator=gen) * 0.05).to(
        torch.bfloat16) for n in numels]
    got = fused.grad_global_norm(grads, OPTIONS_CLIP)
    again = fused.grad_global_norm(grads, OPTIONS_CLIP)
    want = fused._global_norm_reference(grads, OPTIONS_CLIP)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs()).max())
    err["grad_sumsq"] = max(err["grad_sumsq"], float((got - want).abs()[0]))
    log(f"[12a] global norm over {len(numels)} bf16 gradients "
        f"({sum(numels)} values): kernel {float(got[0]):.7g} scale "
        f"{float(got[1]):.7g}, plain {float(want[0]):.7g} scale "
        f"{float(want[1]):.7g}, rel err {rel:.3g} (tol {NORM_RTOL}); same "
        f"bits over two calls {torch.equal(got, again)}")
    if not (rel <= NORM_RTOL and torch.equal(got, again)
            and float(got[1]) < 1.0):
        raise AssertionError("the sum-of-squares kernel disagrees")

    masters = [torch.randn(n, device=dev, generator=gen) for n in numels]
    l2 = [0.01 * (i % 3 == 1) for i in range(len(numels))]
    decay = [0.01 if len(s) == 2 else 0.0 for s in gpt_param_shapes(cfg)]
    lr = torch.full((), OPTIONS_PEAK_LR, device=dev)

    def state():
        return dict(P=[m.to(torch.bfloat16) for m in masters],
                    M=[torch.zeros_like(m) for m in masters],
                    V=[torch.zeros_like(m) for m in masters],
                    P1=[torch.ones((), device=dev) for _ in numels],
                    P2=[torch.ones((), device=dev) for _ in numels],
                    MS=[m.clone() for m in masters])

    k, pl = state(), state()
    norm = fused.fused_adam_step(k["P"], grads, k["M"], k["V"], k["P1"],
                                 k["P2"], lr, masters=k["MS"],
                                 weight_decay=l2, decoupled_decay=decay,
                                 clip_norm=OPTIONS_CLIP)
    fused._adam_reference(pl["P"], grads, pl["M"], pl["V"], pl["P1"],
                          pl["P2"], lr, masters=pl["MS"], weight_decay=l2,
                          decoupled_decay=decay, grad_scale=norm[1])
    torch.cuda.synchronize()
    e_adam, ok = 0.0, True
    for key in ("P", "M", "V", "P1", "P2", "MS"):
        for a, b in zip(k[key], pl[key]):
            e, good = worst(a, b, *ADAM_TOL)
            e_adam, ok = max(e_adam, e), ok and good
    err["adam"] = max(err["adam"], e_adam)
    log(f"[12a] AdamW with the clip scale over {len(numels)} tensors: max "
        f"err vs plain {e_adam:.3g} (tol {ADAM_TOL}); kernel's norm equals "
        f"grad_global_norm's {torch.equal(norm, got)}")
    if not (ok and torch.equal(norm, got)):
        raise AssertionError("the clip-scaled Adam kernel disagrees")
    del pl, masters
    torch.cuda.empty_cache()

    # times: the pass alone; the Adam step with the pass folded in
    norm_fn = lambda: fused.grad_global_norm(grads, OPTIONS_CLIP)
    if hasattr(torch.nn.utils, "get_total_norm"):
        lib_name = "torch.nn.utils.get_total_norm"
        lib = lambda: torch.nn.utils.get_total_norm(grads)
    else:
        lib_name = "torch.linalg.vector_norm(torch._foreach_norm)"
        lib = lambda: torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    bound, by = sumsq_bound(numels, 2)
    sumsq = {"kernel": "grad_sumsq", "shape": [len(numels), sum(numels)],
             "dtype": "bf16 grads", "ms": time_ms(norm_fn, iters=20),
             "device_ms": device_ms(norm_fn, "grad_global_norm", iters=10),
             "plain_ms": time_ms(lambda: fused._global_norm_reference(
                 grads, OPTIONS_CLIP), iters=3, warmup=1),
             "library_ms": time_ms(lib, iters=10),
             "library_device_ms": device_ms(lib, lib_name, iters=5),
             "library": lib_name, "bound_ms": bound, "bound_by": by}
    step = lambda: fused.fused_adam_step(
        k["P"], grads, k["M"], k["V"], k["P1"], k["P2"], lr,
        masters=k["MS"], weight_decay=l2, decoupled_decay=decay,
        clip_norm=OPTIONS_CLIP)
    with_clip = {"ms": time_ms(step, iters=10),
                 "device_ms": device_ms(step, "adam with the clip", iters=5)}
    with_clip["adam_device_ms"] = with_clip["device_ms"] - sumsq["device_ms"]
    log(f"[12a] time grad_sumsq {sumsq['shape']}: kernel {sumsq['ms']:.4f} "
        f"ms (device {sumsq['device_ms']:.4f}), plain "
        f"{sumsq['plain_ms']:.4f} ms, {lib_name} {sumsq['library_ms']:.4f} "
        f"ms (device {sumsq['library_device_ms']:.4f}), bound "
        f"{bound:.5f} ms ({by}), {bound / sumsq['device_ms']:.3f} of it")
    log(f"[12a] time AdamW + clip over {len(numels)} tensors: "
        f"{with_clip['ms']:.4f} ms (device {with_clip['device_ms']:.4f}, of "
        f"which the update {with_clip['adam_device_ms']:.4f})")
    del k, grads
    torch.cuda.empty_cache()
    return sumsq, with_clip


def options_config(gpt_mod):
    """GPT-2 345M's widths at ``OPTIONS_LAYERS`` layers, dropout 0.1
    (attention dropout 0: no attention kernel takes one)."""
    return gpt_mod.gpt2_medium(num_layers=OPTIONS_LAYERS,
                               hidden_dropout=OPTIONS_DROPOUT,
                               attention_dropout=0.0)


def options_model(gpt_mod, dev):
    """``options_config``'s GPT from seed 4, in f32."""
    return gpt_mod.GPTForCausalLM(options_config(gpt_mod), device=dev,
                                  dtype=torch.float32, seed=4)


def options_optimizer(model, AdamW, lr_mod, ClipGradByGlobalNorm):
    """AdamW as Megatron-LM's pretrain_gpt.sh runs it: weight decay 0.01
    except LayerNorm weights and biases, global-norm clip, the warm-up and
    cosine schedule (cut), f32 masters."""
    sched = lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(OPTIONS_PEAK_LR, T_max=OPTIONS_T_MAX,
                                    eta_min=OPTIONS_MIN_LR),
        warmup_steps=OPTIONS_WARMUP, start_lr=0.0, end_lr=OPTIONS_PEAK_LR)
    opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                apply_decay_param_fun=lambda n: not (
                    n.endswith("bias") or ".ln_" in n),
                grad_clip=ClipGradByGlobalNorm(OPTIONS_CLIP),
                multi_precision=True)
    return opt, sched


def busy_per_step(step, batch, n_steps=2):
    """(wall ms, device busy ms) per training step over ``n_steps`` steps
    under ``torch.profiler`` (device activity only): the busy time is the
    sum of the kernels' durations, the wall time ends in a synchronize.
    The busy time is None when the profiler recorded no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, (busy / 1e3 / n_steps if busy > 0 else None)


@contextlib.contextmanager
def captured_norms(opt_mod, norms):
    """Append the (norm, scale) device tensor of each ``fused_adam_step``
    call that the optimizers of ``opt_mod`` make to ``norms``. Only their
    view of ``ops.fused`` is swapped: the kernel wrapper and its launch
    counter stay as they are."""
    real = opt_mod.fused

    def capture(*a, **k):
        out = real.fused_adam_step(*a, **k)
        norms.append(out)
        return out

    opt_mod.fused = types.SimpleNamespace(fused_adam_step=capture)
    try:
        yield
    finally:
        opt_mod.fused = real


def train_with_options(dev, gen, counted, launches, opt_mod, gpt_mod,
                       ParallelTrainStep, TrainStep, AdamW, lr_mod,
                       ClipGradByGlobalNorm):
    """Phases 12b and 12c (see the module's docstring); the launches of
    each run go into ``launches[kernel]["options_<run>"]``."""
    cfg = options_config(gpt_mod)

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(phase):
        for name, fn in counted.items():
            launches[name][phase] = fn.launches

    ids = torch.randint(0, cfg.vocab_size, TRAIN_SHAPE, device=dev,
                        generator=gen)
    labels = torch.roll(ids, -1, dims=1)
    batch = ((ids, labels), (labels,))
    n_ln = 2 * cfg.num_layers + 1
    first, policies = {}, {}
    # 'off' twice: whether two identical runs give the same bits here
    for run, policy in enumerate(("off",) + REMAT_POLICIES):
        model = options_model(gpt_mod, dev)
        opt, sched = options_optimizer(model, AdamW, lr_mod,
                                       ClipGradByGlobalNorm)
        step = ParallelTrainStep(model, lambda out, lbl: out, opt,
                                 compute_dtype=torch.bfloat16, remat=policy)
        norms = []
        with captured_norms(opt_mod, norms):
            loss1 = step(*batch)
            sched.step()
            torch.cuda.synchronize()
            key = policy if run else "off_first"
            first[key] = (loss1.clone(), norms[0][0].clone())
            if not run:
                del step, model, opt
                torch.cuda.empty_cache()
                continue
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(OPTIONS_STEPS + 1)]
            losses = [loss1]
            for i in range(OPTIONS_STEPS):
                marks[i].record()
                losses.append(step(*batch))
                sched.step()
            marks[-1].record()
            torch.cuda.synchronize()
        read_counts(f"options_{policy}")
        peak = torch.cuda.max_memory_allocated()
        step_ms = sorted(marks[i].elapsed_time(marks[i + 1])
                         for i in range(OPTIONS_STEPS))
        all_losses = [float(x) for x in torch.stack(losses)]
        recompute = policy != "off"
        want = {**{n: 0 for n in counted},
                # ln_f lies outside the recomputed blocks
                "layer_norm_fwd": (n_ln + recompute * 2 * cfg.num_layers)
                * OPTIONS_STEPS,
                "layer_norm_bwd": 2 * n_ln * OPTIONS_STEPS,
                "flash_attn_fwd": (1 + recompute) * cfg.num_layers
                * OPTIONS_STEPS,
                "flash_attn_bwd_dq": cfg.num_layers * OPTIONS_STEPS,
                "flash_attn_bwd_dkv": cfg.num_layers * OPTIONS_STEPS,
                "adam": 2 * OPTIONS_STEPS, "grad_sumsq": 2 * OPTIONS_STEPS}
        got = {n: launches[n][f"options_{policy}"] for n in counted}
        wall_ms, busy_ms = busy_per_step(step, batch)
        policies[policy] = {
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "step_ms_p50": step_ms[OPTIONS_STEPS // 2],
            "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
            "peak_memory_bytes": peak, "losses": all_losses,
            "grad_norm_step1": float(first[policy][1]),
            "lr_last": opt.get_lr()}
        log(f"[12b] remat={policy}: step p50 {step_ms[OPTIONS_STEPS // 2]:.2f}"
            f" ms (min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}), peak "
            f"memory {peak / 2**30:.2f} GiB, loss {all_losses[0]:.4f} -> "
            f"{all_losses[-1]:.4f}, step-1 grad norm "
            f"{float(first[policy][1]):.6g}, lr now {opt.get_lr():.4g}; "
            f"profiled step: wall {wall_ms:.2f} ms, device busy "
            + (f"{busy_ms:.2f} ms (share {busy_ms / wall_ms:.3f})"
               if busy_ms else "not measured") + f"; launches {got}")
        if not all(np.isfinite(all_losses)) or \
                not all_losses[-1] < all_losses[0]:
            raise AssertionError(f"remat={policy}: losses {all_losses}")
        if got != want:
            raise AssertionError(f"remat={policy} launched {got}, expected "
                                 f"{want}")
        del step, model, opt, losses
        torch.cuda.empty_cache()
    # step 1 (loss, gradient norm) under each policy against 'off'
    off_diff = [float((a - b).abs()) for a, b in zip(first["off_first"],
                                                     first["off"])]
    bitwise_off = off_diff == [0.0, 0.0]
    for policy in REMAT_POLICIES:
        diff = [float((a - b).abs()) for a, b in zip(first[policy],
                                                     first["off"])]
        log(f"[12b] step 1 under {policy} vs off: |loss diff| {diff[0]:.3g}, "
            f"|grad norm diff| {diff[1]:.3g} (off vs off: {off_diff})")
        if (diff != [0.0, 0.0]) if bitwise_off else \
                any(d > o for d, o in zip(diff, off_diff)):
            raise AssertionError(f"remat={policy}: step 1 differs from off "
                                 f"by {diff} (off vs off: {off_diff})")
    if not policies["full"]["peak_memory_bytes"] < \
            policies["off"]["peak_memory_bytes"]:
        raise AssertionError("remat='full' did not lower the peak memory")
    log("options " + json.dumps({"bitwise_off_vs_off": bitwise_off,
                                 "off_vs_off_diff": off_diff,
                                 "policies": policies}))

    # 12c: TrainStep and ParallelTrainStep take the same 3 steps; the
    # weights are rounded to bf16 first, so that both engines start from
    # the same f32 masters
    engine_losses = {}
    for name in ("train_step", "parallel"):
        model = options_model(gpt_mod, dev)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
        if name == "train_step":
            model.to(torch.bfloat16)
        opt, sched = options_optimizer(model, AdamW, lr_mod,
                                       ClipGradByGlobalNorm)
        if name == "train_step":
            step = TrainStep(model, lambda out, lbl: out, opt)
        else:
            step = ParallelTrainStep(model, lambda out, lbl: out, opt,
                                     compute_dtype=torch.bfloat16)
        reset_counts()
        losses = []
        for _ in range(3):
            losses.append(step(*batch))
            sched.step()
        torch.cuda.synchronize()
        read_counts(f"options_{name}")
        engine_losses[name] = [float(x) for x in losses]
        del step, model, opt, losses
        torch.cuda.empty_cache()
    log(f"[12c] 3 steps: TrainStep {engine_losses['train_step']}, "
        f"ParallelTrainStep {engine_losses['parallel']}")
    if engine_losses["train_step"] != engine_losses["parallel"]:
        raise AssertionError("TrainStep and ParallelTrainStep disagree")



def kernel_launches(fn, what, attempts=3):
    """{kernel name: launches} of one call of ``fn`` under
    ``torch.profiler``; a window in which it records no kernel is taken
    again, up to ``attempts`` windows, then the run fails naming ``what``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        found = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if found:
            return found
    raise RuntimeError(f"kernels of {what}: the profiler recorded no kernel "
                       f"in {attempts} windows")


def packed_worst(got, ref):
    """(max |got - ref|, whether it is within PACKED_REL_TOL of max|ref|)."""
    d = float((got.float() - ref.float()).abs().max())
    return d, d <= PACKED_REL_TOL * float(ref.float().abs().max())


def time_bert_kernels(dev, rnd, gen, fused, flash_tpu, dkv_mod, bert_cfg):
    """Phase 3c timings (bf16): the full-attention kernels at BERT's shape
    (also with a key-padding bias) and at GPT's, the packed dK/dV at its
    experiment's shape, the AdamW mode at BERT-base's sizes."""
    F = torch.nn.functional
    timings = []
    # the padded batch's forward: SDPA takes the same bias as its mask
    q, k, v = (rnd(*BERT_ATTN_SHAPE, dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kb = padding_bias(*BERT_ATTN_SHAPE[:2], gen, dev)
    mask = kb[:, None, None, :].to(torch.bfloat16)
    fwd = lambda: flash_tpu._fwd(q, k, v, False, kb)
    lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
    bound, by = flash_bound(*BERT_ATTN_SHAPE, torch.bfloat16, causal=False)
    timings.append({
        "kernel": "flash_attn_fwd_full+key_bias",
        "shape": list(BERT_ATTN_SHAPE), "dtype": "bfloat16",
        "ms": time_ms(fwd, iters=20),
        "plain_ms": time_ms(lambda: flash_tpu._flash_reference(
            q, k, v, False, kb), iters=5, warmup=1),
        "library_ms": time_ms(lib_fwd, iters=20),
        "device_ms": device_ms(fwd, "flash_attn_fwd_full+key_bias"),
        "library_device_ms": device_ms(lib_fwd, "SDPA with a padding mask"),
        "bound_ms": bound, "bound_by": by,
        "note": "the bias's b x L f32 bytes are not in the bound"})
    del q, k, v, qt, kt, vt, kb, mask
    for shape in (BERT_ATTN_SHAPE, (8, 1024, 16, 64)):
        q, k, v, do = (rnd(*shape, dtype=torch.bfloat16) for _ in range(4))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fwd = lambda: flash_tpu._fwd(q, k, v, causal=False)
        lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        bound, by = flash_bound(*shape, torch.bfloat16, causal=False)
        timings.append({
            "kernel": "flash_attn_fwd_full", "shape": list(shape),
            "dtype": "bfloat16", "ms": time_ms(fwd, iters=20),
            "plain_ms": time_ms(lambda: flash_tpu._flash_reference(
                q, k, v, False), iters=5, warmup=1),
            "library_ms": time_ms(lib_fwd, iters=20),
            "device_ms": device_ms(fwd, f"flash_attn_fwd_full {shape}"),
            "library_device_ms": device_ms(lib_fwd, f"SDPA {shape}"),
            "bound_ms": bound, "bound_by": by})
        out, lse = fwd()
        _, delta = flash_tpu.flash_bwd_dq_full(q, k, v, do, lse, out)
        lt = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        ys = F.scaled_dot_product_attention(*lt)
        lib = lambda: torch.autograd.grad(ys, lt, do.transpose(1, 2),
                                          retain_graph=True)
        plain_ms = time_ms(lambda: flash_tpu._flash_bwd_reference(
            q, k, v, out, lse, do, causal=False, operand_dtype=torch.bfloat16),
            iters=5, warmup=1)
        lib_ms, lib_dev = time_ms(lib, iters=20), device_ms(
            lib, f"SDPA's backward {shape}")
        for name, kern in (
                ("dq", lambda: flash_tpu.flash_bwd_dq_full(q, k, v, do, lse,
                                                           out)),
                ("dkv", lambda: flash_tpu.flash_bwd_dkv_full(q, k, v, do,
                                                             lse, delta))):
            bound, by = flash_bound(*shape, torch.bfloat16, name,
                                    causal=False)
            timings.append({
                "kernel": f"flash_attn_bwd_{name}_full", "shape": list(shape),
                "dtype": "bfloat16", "ms": time_ms(kern, iters=20),
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "device_ms": device_ms(
                    kern, f"flash_attn_bwd_{name}_full {shape}"),
                "library_device_ms": lib_dev, "bound_ms": bound,
                "bound_by": by,
                "note": "plain and library times are the whole backward "
                        "(dQ, dK and dV)"})
        del q, k, v, do, qt, kt, vt, out, lse, delta, lt, ys

    for b, L, H, d in PACKED_TIMED:
        q, k, v, do = (rnd(b, L, H, d, dtype=torch.bfloat16)
                       for _ in range(4))
        out, lse = flash_tpu._fwd(q, k, v)
        delta = flash_tpu._delta(out, do)
        bhld = lambda t: t.transpose(1, 2).contiguous()
        args4 = (bhld(q), bhld(k), bhld(v), bhld(do), lse, delta)
        lt = [t.detach().requires_grad_() for t in args4[:3]]
        ys = F.scaled_dot_product_attention(*lt, is_causal=True)
        lib = lambda: torch.autograd.grad(ys, lt, args4[3],
                                          retain_graph=True)
        kern = lambda: dkv_mod.dkv_call(*args4)
        # the packed [dV | dK] output holds dK's and dV's bytes
        bound, by = flash_bound(b, L, H, d, torch.bfloat16, "dkv")
        shape = [b, L, H, d]
        timings.append({
            "kernel": "dkv_packed", "shape": shape, "dtype": "bfloat16",
            "ms": time_ms(kern, iters=20),
            "plain_ms": time_ms(
                lambda: dkv_mod._dkv_packed_reference(*args4), iters=5,
                warmup=1),
            "library_ms": time_ms(lib, iters=20),
            "device_ms": device_ms(kern, f"dkv_packed {shape}"),
            "library_device_ms": device_ms(lib, "SDPA's causal backward "
                                           f"{shape}"),
            # the causal dK/dV kernel (#3), the same four products on the
            # same values in [b, L, H, d]
            "dkv_device_ms": device_ms(
                lambda: flash_tpu.flash_bwd_dkv(q, k, v, do, lse, delta),
                f"flash_attn_bwd_dkv {shape}"),
            "bound_ms": bound, "bound_by": by,
            "note": "library time is SDPA's whole causal backward (dQ, dK "
                    "and dV); dkv_device_ms is the causal dK/dV kernel "
                    "(flash_attn_bwd_dkv) on the same inputs"})
        del q, k, v, do, out, lse, delta, args4, lt, ys

    numels = [int(np.prod(s)) for s in bert_param_shapes(bert_cfg)]
    decay = [0.01] * len(numels)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = [torch.randn(n, device=dev, generator=gen) for n in numels]
    grads = [torch.randn(n, device=dev, generator=gen) for n in numels]
    ms_ = [torch.zeros(n, device=dev) for n in numels]
    vs_ = [torch.zeros(n, device=dev) for n in numels]
    p1 = [torch.ones((), device=dev) for _ in numels]
    p2 = [torch.ones((), device=dev) for _ in numels]
    lr = torch.full((), TRAIN_LR, device=dev)
    args = (params, grads, ms_, vs_, p1, p2, lr)
    kern = lambda: fused.fused_adam_step(*args, decoupled_decay=decay)
    kern_ms = time_ms(kern, iters=10)
    kern_dev = device_ms(kern, f"adamw over {len(numels)} tensors", iters=5)
    plain_ms = time_ms(lambda: fused._adam_reference(
        *args, decoupled_decay=decay), iters=3, warmup=1)
    del params, grads, ms_, vs_
    torch.cuda.empty_cache()
    # torch.optim.AdamW(fused=True) over f32 params of the same sizes: a
    # time yardstick only (its eps is bias-corrected, the port's is not)
    lib_p = [torch.zeros(n, device=dev, requires_grad=True) for n in numels]
    for p in lib_p:
        p.grad = torch.randn(p.numel(), device=dev, generator=gen)
    opt = torch.optim.AdamW(lib_p, lr=TRAIN_LR, weight_decay=0.01,
                            fused=True)
    lib_ms = time_ms(opt.step, iters=10)
    lib_dev = device_ms(opt.step, "torch.optim.AdamW(fused=True)", iters=5)
    del lib_p, opt
    torch.cuda.empty_cache()
    bound, by = adam_bound(numels, 4, 0)
    timings.append({
        "kernel": "adamw", "shape": [len(numels), sum(numels)],
        "dtype": "f32 params, no masters", "ms": kern_ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": kern_dev,
        "library_device_ms": lib_dev, "bound_ms": bound, "bound_by": by})
    for t in timings:
        log(f"[3c] time {t['kernel']} {t['shape']}: kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
    for t in timings:
        if t["kernel"] == "dkv_packed":
            dev_ms = t["device_ms"]
            log(f"[3c] dkv_packed {t['shape']}: device {dev_ms:.4f} ms, "
                f"{t['bound_ms'] / dev_ms:.3f} of its bound "
                f"({t['bound_by']}), {dev_ms / t['library_device_ms']:.2f}x "
                f"SDPA's whole causal backward "
                f"({t['library_device_ms']:.4f} ms), "
                f"{dev_ms / t['dkv_device_ms']:.2f}x the causal dK/dV kernel "
                f"({t['dkv_device_ms']:.4f} ms)")
    return timings


def bert_batch(cfg, b, L, gen, dev):
    """ids, MLM labels on 15% of the positions (-100 elsewhere) and NSP
    labels, as ``bench_all.bench_bert_dp`` makes them, from ``gen``."""
    ids = torch.randint(0, cfg.vocab_size, (b, L), device=dev, generator=gen)
    pick = torch.rand(b, L, device=dev, generator=gen) < 0.15
    mlm = torch.where(pick, ids, torch.full_like(ids, -100))
    nsp = torch.randint(0, 2, (b,), device=dev, generator=gen)
    return ids, mlm, nsp


def profile_bert_training(step, batch, n_layers):
    """Device busy share and device time a step of two BERT steps under
    ``torch.profiler`` (the device time by kernel and the forward kernel by
    name are printed and checked; a session short of the launches is
    taken again, as in ``profile_training``)."""
    ids, mlm, nsp = batch

    def two_steps():
        for _ in range(2):
            step((ids,), (mlm, nsp))

    for attempt in range(PROFILE_ATTEMPTS):
        kernels, wall_us = profiled_session(
            two_steps, lambda: step((ids,), (mlm, nsp)))
        dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
        busy_us = sum(dev_us(e) for e in kernels)
        if busy_us <= 0:
            log("[10] profile: the profiler saw no device time (device busy "
                "share not measured)")
            return {"busy_share": None, "device_ms_per_step": None}
        log(f"[10] profile (2 steps): wall {wall_us / 1e3:.1f} ms, device "
            f"busy {busy_us / 1e3:.1f} ms, busy share "
            f"{busy_us / wall_us:.4f}")
        for e in sorted(kernels, key=dev_us, reverse=True)[:14]:
            log(f"[10] profile: {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:90]}")
        try:
            check_attention_in_profile(kernels, 10, 2 * n_layers)
            check_layer_norm_in_profile(kernels, 10,
                                        2 * (2 * n_layers + 2))
            break
        except AssertionError as e:
            if attempt + 1 == PROFILE_ATTEMPTS:
                raise
            log(f"[10] profile session {attempt + 1}: {e}; profiling again")
    return {"busy_share": busy_us / wall_us,
            "device_ms_per_step": busy_us / 1e3 / 2}


def l2_rel(got, ref):
    return float((got.double() - ref.double()).norm()
                 / ref.double().norm().clamp(min=1e-30))


def max_rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp(min=1e-30))


def check_adam_on_lenet(dev, gen, fused, err):
    """13a's kernel check: #7 on LeNet's 10 tensors (54, 6, 2400, 16,
    48000, 120, 10080, 84, 840 and 10 values: tails of 2 past the
    vector), three steps against ``_adam_reference``, then timed beside
    its plain version and ``torch.optim.Adam(fused=True)``."""
    from paddle_tpu_torch.vision.models import LeNet

    numels = [p.numel() for p in LeNet(device=dev).parameters()]
    got = dict(
        P=[torch.randn(n, device=dev, generator=gen) for n in numels],
        G=[torch.randn(n, device=dev, generator=gen) for n in numels],
        M=[torch.zeros(n, device=dev) for n in numels],
        V=[torch.zeros(n, device=dev) for n in numels],
        P1=[torch.ones((), device=dev) for _ in numels],
        P2=[torch.ones((), device=dev) for _ in numels])
    want = {k: [t.clone() for t in v] for k, v in got.items()}
    want["G"] = got["G"]
    lr = torch.full((), 1e-3, device=dev)
    for _ in range(3):
        fused.fused_adam_step(got["P"], got["G"], got["M"], got["V"],
                              got["P1"], got["P2"], lr)
        fused._adam_reference(want["P"], want["G"], want["M"], want["V"],
                              want["P1"], want["P2"], lr)
    torch.cuda.synchronize()
    errs = {}
    for key in ("P", "M", "V", "P1", "P2"):
        res = [worst(a, b, *ADAM_TOL) for a, b in zip(got[key], want[key])]
        errs[key] = max(e for e, _ in res)
        if not all(ok for _, ok in res):
            raise AssertionError(f"adam kernel disagrees on LeNet's {key}")
    err["adam"] = max(err["adam"], *errs.values())
    args = [got[k] for k in ("P", "G", "M", "V", "P1", "P2")] + [lr]
    kern = lambda: fused.fused_adam_step(*args)
    lib_p = [torch.nn.Parameter(torch.randn(n, device=dev, generator=gen))
             for n in numels]
    for q in lib_p:
        q.grad = torch.randn(q.numel(), device=dev, generator=gen)
    lib = torch.optim.Adam(lib_p, lr=1e-3, fused=True)
    bound, by = adam_bound(numels, 4, 0)
    t = {"kernel": "adam", "shape": [len(numels), sum(numels)],
         "dtype": "float32", "ms": time_ms(kern),
         "device_ms": device_ms(kern, "adam over LeNet's tensors"),
         "plain_ms": time_ms(lambda: fused._adam_reference(*args)),
         "library_ms": time_ms(lib.step),
         "library_device_ms": device_ms(lib.step, "torch.optim.Adam(fused="
                                        "True) over LeNet's tensors"),
         "bound_ms": bound, "bound_by": by}
    log(f"[13a] adam on LeNet's {len(numels)} tensors ({sum(numels)} "
        f"values), 3 steps: max err " + ", ".join(
            f"{k} {e:.3g}" for k, e in errs.items()) + f" (tol {ADAM_TOL}); "
        f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
        f"{t['plain_ms']:.4f} ms, torch.optim.Adam(fused=True) "
        f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f}), "
        f"bound {bound:.6f} ms ({by})")
    return t


def profile_step(phase, step, batch, n_steps=2, top=12, keys=None,
                 warmup=False):
    """Wall and device busy time per step of ``n_steps`` steps under
    ``torch.profiler`` and the ``top`` device operations by time; fails if
    the profiler saw no device time. Given a list, ``keys`` receives every
    device operation's (name, count). ``warmup``: one more step first, in
    a discarded window of the session (``profiled_session``)."""
    from torch.profiler import ProfilerActivity, profile

    def steps():
        for _ in range(n_steps):
            step(*batch)

    if warmup:
        kernels, wall_us = profiled_session(steps, lambda: step(*batch))
    else:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    if keys is not None:
        keys.extend((e.key, e.count) for e in kernels)
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0:
        raise AssertionError(f"[{phase}] the profiler saw no device time")
    by_kind = {}
    for e in kernels:
        kind = next((k for k, words in DEVICE_OP_KINDS
                     if any(w in e.key for w in words)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + dev_us(e) / 1e3 / n_steps
    out = {"wall_ms_per_step": wall_us / 1e3 / n_steps,
           "device_ms_per_step": busy_us / 1e3 / n_steps,
           "busy_share": busy_us / wall_us, "top": [],
           "device_ms_by_kind": by_kind,
           "launches_per_step": sum(e.count for e in kernels) / n_steps}
    log(f"[{phase}] profile ({n_steps} steps): wall "
        f"{out['wall_ms_per_step']:.2f} ms a step, device busy "
        f"{out['device_ms_per_step']:.2f} ms a step, busy share "
        f"{out['busy_share']:.4f}; by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        out["top"].append({"kernel": e.key[:120], "count": e.count,
                           "ms_per_step": dev_us(e) / 1e3 / n_steps})
        log(f"[{phase}] profile: {dev_us(e) / 1e3 / n_steps:9.3f} ms a step"
            f"  x{e.count / n_steps:<6g} {e.key[:90]}")
    return out


def timed_steps(step, batch, n_steps):
    """(losses, sorted step times in ms, wall seconds) of ``n_steps``
    steps, each step's time from CUDA events between steps."""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(n_steps + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(n_steps):
        marks[i].record()
        losses.append(step(*batch))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (losses, sorted(marks[i].elapsed_time(marks[i + 1])
                           for i in range(n_steps)), wall)


def train_lenet(dev, gen, counted, launches, fused, plain, err):
    """Phase 13a: LeNet as BASELINE config #1 runs it."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit.train_step import EvalStep, TrainStep
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    adam_t = check_adam_on_lenet(dev, gen, fused, err)
    rng = np.random.RandomState(0)  # bench_all.py's config #1 inputs
    xs = torch.from_numpy(rng.randn(LENET_BATCH, 1, 28, 28).astype(
        np.float32)).to(dev)
    ys = torch.from_numpy(rng.randint(0, 10, LENET_BATCH).astype(
        np.int64)).to(dev)

    # one step through #7 and one through the plain update, same weights
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = []
        for use_plain in (False, True):
            model = LeNet(device=dev)
            opt = Adam(1e-3, parameters=model.parameters())
            loss = cross_entropy(model(xs), ys)
            loss.backward()
            grads = [p.grad.clone() for p in model.parameters()]
            with plain() if use_plain else contextlib.nullcontext():
                opt.step()
            torch.cuda.synchronize()
            res.append((loss.detach(), grads,
                        [p.detach().clone() for p in model.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = det
    (l_k, g_k, p_k), (l_p, g_p, p_p) = res
    e_loss = float((l_k - l_p).abs())
    e_grad = max(max_rel(a, b) for a, b in zip(g_k, g_p))
    par = [worst(a, b, *ADAM_TOL) for a, b in zip(p_k, p_p)]
    e_par = max(e for e, _ in par)
    log(f"[13a] LeNet step through #7 against the plain update: loss "
        f"{float(l_k):.6f} (err {e_loss:.3g}), gradients max rel err "
        f"{e_grad:.3g} (tol {LENET_GRAD_RTOL}), parameters max err "
        f"{e_par:.3g} (tol {ADAM_TOL})")
    if e_loss > LENET_GRAD_RTOL * abs(float(l_p)) or e_grad > \
            LENET_GRAD_RTOL or not all(ok for _, ok in par):
        raise AssertionError("LeNet's step through #7 disagrees with the "
                             "plain update")
    err["adam"] = max(err["adam"], e_par)

    # config #1: TrainStep(LeNet(), CrossEntropyLoss(), Adam(1e-3))
    model = LeNet(device=dev)
    step = TrainStep(model, CrossEntropyLoss(),
                     Adam(1e-3, parameters=model.parameters()))
    batch = ((xs,), (ys,))
    warm = [step(*batch) for _ in range(3)]
    for fn in counted.values():
        fn.launches = 0
    losses, step_ms, wall = timed_steps(step, batch, LENET_STEPS)
    for name, fn in counted.items():
        launches[name]["lenet_training"] = fn.launches
    got = {n: launches[n]["lenet_training"] for n in counted}
    want = {**{n: 0 for n in counted}, "adam": 2 * LENET_STEPS}
    prof = profile_step("13a", step, batch, n_steps=10, top=8)
    all_losses = [float(x) for x in torch.stack(warm + losses)]
    out = {"samples_per_s": LENET_BATCH * LENET_STEPS / wall,
           "step_ms_p50": step_ms[LENET_STEPS // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "busy_share": prof["busy_share"],
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_over_step_p50": prof["device_ms_per_step"]
           / step_ms[LENET_STEPS // 2],
           "adam_launches_per_step": got["adam"] / LENET_STEPS,
           "losses": all_losses}
    log(f"[13a] LeNet config #1 (batch {LENET_BATCH}, Adam 1e-3): "
        f"{out['samples_per_s']:.1f} samples/s over {LENET_STEPS} steps, "
        f"step p50 {out['step_ms_p50']:.3f} ms (min {step_ms[0]:.3f}, max "
        f"{step_ms[-1]:.3f}), device {out['device_ms_per_step']:.4f} ms a "
        f"step, busy share {out['busy_share']:.4f}; loss "
        f"{all_losses[0]:.4f} -> {all_losses[-1]:.4f}; launches {got}")
    if got != want:
        raise AssertionError(f"13a launched {got}, expected {want}")
    if not all(np.isfinite(all_losses)) or not all_losses[-1] < \
            all_losses[0]:
        raise AssertionError(f"13a: LeNet's loss did not fall: {all_losses}")

    # one epoch of the synthetic MNIST through the DataLoader
    np.random.seed(0)
    model = LeNet(device=dev)
    step = TrainStep(model, CrossEntropyLoss(),
                     Adam(1e-3, parameters=model.parameters()))
    loader = DataLoader(MNIST(mode="train"), batch_size=LENET_BATCH,
                        shuffle=True, drop_last=True)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pinned = True
    epoch = []
    for img, lbl in loader:
        pinned = pinned and img.is_pinned() and lbl.is_pinned()
        epoch.append(step((img,), (lbl,)))
    epoch = [float(x) for x in torch.stack(epoch)]
    epoch_s = time.perf_counter() - t0
    for name, fn in counted.items():
        launches[name]["lenet_mnist"] = fn.launches
    acc = Accuracy()
    evaluate = EvalStep(model)
    for img, lbl in DataLoader(MNIST(mode="test"), batch_size=128):
        acc.update(acc.compute(evaluate(img), lbl))
    out.update(mnist_epoch_s=epoch_s, mnist_losses=epoch,
               mnist_test_accuracy=float(acc.accumulate()))
    log(f"[13a] one epoch of MNIST (synthetic, {len(epoch)} batches of "
        f"{LENET_BATCH}, pinned {pinned}) in {epoch_s:.2f} s: loss "
        f"{np.mean(epoch[:4]):.4f} -> {np.mean(epoch[-4:]):.4f} (means of "
        f"the first and last 4); test accuracy {acc.accumulate():.4f}; "
        f"adam launches {launches['adam']['lenet_mnist']}")
    if not pinned:
        raise AssertionError("13a: the DataLoader's batches are not pinned")
    if not np.mean(epoch[-4:]) < np.mean(epoch[:4]):
        raise AssertionError(f"13a: the MNIST loss did not fall: {epoch}")
    if not acc.accumulate() > 0.1:
        raise AssertionError("13a: test accuracy at chance")
    if launches["adam"]["lenet_mnist"] != 2 * len(epoch):
        raise AssertionError("13a: the epoch did not run #7 twice a step")
    return out, adam_t


def resnet_card_against_cpu(dev):
    """Phase 13b: one f32 Momentum step of ResNet-50 on the card (TF32
    off) and on the CPU from the same weights and buffers."""
    from paddle_tpu_torch.jit.functionalize import (get_buffers, get_params,
                                                    load_jax_params)
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*R50_CHECK_SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, (R50_CHECK_SHAPE[0], 1)))
    cpu = resnet50(device="cpu", seed=1)
    for b in cpu.buffers():  # running statistics away from 0 and 1
        b.copy_(torch.rand(b.shape, generator=torch.Generator()
                           .manual_seed(b.numel())) + 0.5)
    params0 = {k: v.clone() for k, v in get_params(cpu).items()}
    card = load_jax_params(
        resnet50(device=dev, seed=2),
        {k: v.numpy() for k, v in params0.items()},
        buffers={k: v.numpy() for k, v in get_buffers(cpu).items()})
    res = {}
    for where, model in (("cpu", cpu), ("card", card)):
        opt = Momentum(0.01, 0.9, parameters=model.parameters())
        loss = cross_entropy(model(x.to(model.conv1.weight.device)),
                             y.to(model.conv1.weight.device))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        opt.step()
        res[where] = (float(loss.detach()), grads,
                      {n: v.cpu() for n, v in get_params(model).items()},
                      {n: v.cpu() for n, v in get_buffers(model).items()})
    (l_c, g_c, p_c, b_c), (l_g, g_g, p_g, b_g) = res["cpu"], res["card"]
    e_loss = abs(l_g - l_c) / abs(l_c)
    e_fc = max_rel(g_g["fc.weight"], g_c["fc.weight"])
    e_grad = max(l2_rel(g_g[n], g_c[n]) for n in g_c)
    e_upd = max(l2_rel(p_g[n] - params0[n], p_c[n] - params0[n])
                for n in p_c)
    e_buf = max(max_rel(b_g[n], b_c[n]) for n in b_c)
    out = {"loss_card": l_g, "loss_cpu": l_c, "loss_rel_err": e_loss,
           "fc_grad_max_rel_err": e_fc, "grad_l2_rel_err": e_grad,
           "update_l2_rel_err": e_upd, "buffer_max_rel_err": e_buf}
    log(f"[13b] ResNet-50 f32 {R50_CHECK_SHAPE}, one Momentum step, card "
        f"against CPU (TF32 off): loss {l_g:.6f} / {l_c:.6f} (rel err "
        f"{e_loss:.3g}, tol {R50_FWD_TOL}), fc grad max rel err {e_fc:.3g} "
        f"(tol {R50_FC_GRAD_TOL}), worst gradient L2 rel err {e_grad:.3g} "
        f"and update {e_upd:.3g} (tol {R50_GRAD_L2_TOL}), running "
        f"statistics max rel err {e_buf:.3g} (tol {R50_FWD_TOL})")
    if not (e_loss <= R50_FWD_TOL and e_fc <= R50_FC_GRAD_TOL
            and e_grad <= R50_GRAD_L2_TOL and e_upd <= R50_GRAD_L2_TOL
            and e_buf <= R50_FWD_TOL):
        raise AssertionError("13b: ResNet-50 on the card disagrees with "
                             "the CPU")
    return out


def train_resnet(dev, counted, launches):
    """Phase 13c: ResNet-50 at config #2's model, batch and AMP policy."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit.train_step import EvalStep, TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    rng = np.random.RandomState(0)  # bench_all.py's config #2 inputs
    x = torch.from_numpy(rng.randn(RESNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, (RESNET_BATCH, 1)).astype(
        np.int64)).to(dev)
    model = resnet50(num_classes=1000, device=dev)
    train = TrainStep(model, CrossEntropyLoss(),
                      Momentum(0.01, 0.9, parameters=model.parameters()))

    def step(inputs, labels):
        with amp.auto_cast(dtype="bfloat16"):
            return train(inputs, labels)

    batch = ((x,), (y,))
    warm = [step(*batch) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    losses, step_ms, wall = timed_steps(step, batch, RESNET_STEPS)
    for name, fn in counted.items():
        launches[name]["resnet_training"] = fn.launches
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step("13c", step, batch)
    all_losses = [float(v) for v in torch.stack(warm + losses)]
    with amp.auto_cast(dtype="bfloat16"):
        logits = EvalStep(model)(x)
    out = {"samples_per_s": RESNET_BATCH * RESNET_STEPS / wall,
           "step_ms_p50": step_ms[RESNET_STEPS // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "peak_memory_bytes": peak, "losses": all_losses,
           "eval_logits_dtype": str(logits.dtype),
           "device_over_step_p50": prof["device_ms_per_step"]
           / step_ms[RESNET_STEPS // 2], **prof}
    log(f"[13c] ResNet-50 bf16 AMP O1 at {RESNET_BATCH} x 3 x "
        f"{RESNET_SIZE}^2, Momentum(0.01, 0.9): {out['samples_per_s']:.1f} "
        f"samples/s over {RESNET_STEPS} steps, step p50 "
        f"{out['step_ms_p50']:.2f} ms (min {step_ms[0]:.2f}, max "
        f"{step_ms[-1]:.2f}), peak memory {peak / 2**30:.2f} GiB; loss "
        f"{all_losses[0]:.4f} -> {all_losses[-1]:.4f}; eval logits "
        f"{tuple(logits.shape)} {logits.dtype}")
    if not all(np.isfinite(all_losses)) or not all_losses[-1] < \
            all_losses[0]:
        raise AssertionError(f"13c: the loss is not finite and falling: "
                             f"{all_losses}")
    if tuple(logits.shape) != (RESNET_BATCH, 1000) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("13c: the eval-mode forward is not finite")
    if any(launches[n]["resnet_training"] for n in counted):
        raise AssertionError("13c: a Pallas-kernel counterpart launched in "
                             "ResNet-50's step")
    return out


def _cleared(counted):
    for fn in counted.values():
        fn.launches = 0


def _read_launches(counted, launches, phase):
    for name, fn in counted.items():
        launches[name][phase] = fn.launches
    return {n: launches[n][phase] for n in counted}


def _bitwise(a, b, what):
    """Fail unless the two dicts hold the same keys and the same bits."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: the keys differ")
    for k in a:
        x, y = a[k], b[k]
        same = (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
                else x == y)
        if not same:
            raise AssertionError(f"{what}: {k} differs")


class _LossLog:
    """A hapi callback that keeps each train batch's loss."""

    def __init__(self, callback_cls):
        self.cb = type("LossLog", (callback_cls,), {
            "on_train_batch_end": lambda cb, step, logs=None:
                self.losses.append(logs["loss"])})()
        self.losses = []


def span_split(events):
    """Host milliseconds of ``Model.fit``'s spans by name, and the loader's
    share: each epoch's time outside its steps and checkpoints."""
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e["dur"] / 1e3)
    tot = {k: sum(v) for k, v in by.items()}
    loader = tot.get("epoch", 0.0) - tot.get("step", 0.0) \
        - tot.get("checkpoint", 0.0)
    steps = sorted(by.get("step", [0.0]))
    return {"step_ms_p50": steps[len(steps) // 2], "n_steps": len(steps),
            "train_step_ms": tot.get("compute", 0.0) + tot.get("h2d", 0.0),
            "metric_ms": tot.get("metric", 0.0),
            "callback_ms": tot.get("callback", 0.0),
            "checkpoint_ms": tot.get("checkpoint", 0.0),
            "loader_and_epoch_ms": loader, "fit_ms": tot.get("fit", 0.0)}


def train_hapi_lenet(dev, counted, launches, lenet_13a, workdir):
    """Phase 14a: BASELINE config #1 through ``Model``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import callbacks as cbs
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.profiler import spans
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    train, test = MNIST(mode="train"), MNIST(mode="test")

    def build(seed=0):
        net = LeNet(device=dev, seed=seed)
        return pt.Model(net).prepare(
            Adam(1e-3, parameters=net.parameters()), CrossEntropyLoss(),
            Accuracy())

    def state(model):
        opt = model._optimizer.state_dict()
        return ({k: v.detach().clone()
                 for k, v in model.network.state_dict().items()},
                {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in opt.items()})

    # the run: fit, evaluate, predict, save, load
    np.random.seed(0)
    model = build()
    log_cb = _LossLog(cbs.Callback)
    save_dir, mc_dir = workdir / "fit", workdir / "mc"
    torch.cuda.synchronize()
    _cleared(counted)
    spans.open_window()
    t0 = time.perf_counter()
    model.fit(train, batch_size=LENET_BATCH, epochs=FIT_EPOCHS,
              prefetch_depth=2, save_dir=str(save_dir), verbose=0,
              callbacks=[cbs.EarlyStopping(patience=5), cbs.LRScheduler(),
                         cbs.ModelCheckpoint(save_dir=str(mc_dir)),
                         log_cb.cb])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    spans.close_window()
    got = _read_launches(counted, launches, "hapi_lenet")
    split = span_split(spans.chrome_events())
    n_steps = len(log_cb.losses)
    want = {**{n: 0 for n in counted}, "adam": 2 * n_steps}
    logs = model.evaluate(test, batch_size=128, verbose=0)
    (preds,) = model.predict(test, batch_size=128, stack_outputs=True)
    model.save(str(workdir / "final"))
    loaded = pt.load(str(workdir / "final.pdparams"))
    _bitwise({k: v.detach() for k, v in loaded.items()},
             {k: v.detach().cpu() for k, v in
              model.network.state_dict().items()}, "14a: .pdparams")
    model.load(str(workdir / "final"))
    written = {d.name: sorted(f.name for f in d.iterdir())
               for d in (save_dir, mc_dir)}
    profiled = build()
    prof = profile_step("14a", lambda: profiled.fit(
        train, batch_size=LENET_BATCH, epochs=1, num_iters=PROFILE_ITERS,
        verbose=0, prefetch_depth=2), (), n_steps=1, top=6)
    samples = n_steps * LENET_BATCH
    out = {"samples_per_s": samples / fit_s, "fit_s": fit_s,
           "steps": n_steps, **split,
           "busy_share": prof["busy_share"],
           "device_ms_per_step": prof["device_ms_per_step"] / PROFILE_ITERS,
           "train_step_13a_samples_per_s": lenet_13a["samples_per_s"],
           "train_step_13a_step_ms_p50": lenet_13a["step_ms_p50"],
           "adam_launches_per_step": got["adam"] / n_steps,
           "eval": {k: float(v) for k, v in logs.items()},
           "losses_first_last": [log_cb.losses[0], log_cb.losses[-1]],
           "files": written}
    log(f"[14a] Model.fit(LeNet, MNIST, batch {LENET_BATCH}, {FIT_EPOCHS} "
        f"epochs, prefetch 2): {out['samples_per_s']:.1f} samples/s over "
        f"{n_steps} steps ({fit_s:.2f} s, saves included), step p50 "
        f"{split['step_ms_p50']:.3f} ms; jit.TrainStep in 13a: "
        f"{lenet_13a['samples_per_s']:.1f} samples/s, step p50 "
        f"{lenet_13a['step_ms_p50']:.3f} ms; busy share "
        f"{prof['busy_share']:.4f}, device {out['device_ms_per_step']:.4f} "
        f"ms a step")
    log(f"[14a] host split over the fit (ms): train step "
        f"{split['train_step_ms']:.1f}, metric forward "
        f"{split['metric_ms']:.1f}, callbacks {split['callback_ms']:.1f}, "
        f"checkpoints {split['checkpoint_ms']:.1f}, loader and epoch "
        f"{split['loader_and_epoch_ms']:.1f} (fit {split['fit_ms']:.1f})")
    log(f"[14a] loss {log_cb.losses[0]:.4f} -> {log_cb.losses[-1]:.4f}; "
        f"evaluate {out['eval']}; predict {preds.shape}; files {written}; "
        f"launches {got}")
    if got != want:
        raise AssertionError(f"14a launched {got}, expected {want}")
    if preds.shape != (len(test), 10) or not np.isfinite(preds).all():
        raise AssertionError("14a: predict's outputs are not finite")
    if not out["eval"]["acc"] > 0.1 or not np.isfinite(out["eval"]["loss"]):
        raise AssertionError(f"14a: evaluate at chance: {out['eval']}")
    if written[save_dir.name] != [f"{e}.{x}" for e in range(FIT_EPOCHS)
                                  for x in ("pdopt", "pdparams")] or \
            "final.pdparams" not in written[mc_dir.name]:
        raise AssertionError(f"14a: checkpoint files {written}")

    # the bit-for-bit checks, with deterministic cuDNN
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for depth in (0, 2):
            np.random.seed(0)
            m = build()
            rec = _LossLog(cbs.Callback)
            m.fit(train, batch_size=LENET_BATCH, epochs=1, verbose=0,
                  prefetch_depth=depth, callbacks=[rec.cb])
            runs.append((rec.losses, state(m)))
        if runs[0][0] != runs[1][0]:
            raise AssertionError("14a: prefetch_depth=2 changed the losses")
        _bitwise(runs[0][1][0], runs[1][1][0], "14a: prefetch, parameters")
        _bitwise(runs[0][1][1], runs[1][1][1], "14a: prefetch, Adam state")
        kw = dict(batch_size=LENET_BATCH, verbose=0, shuffle=False)
        whole = build()
        whole.fit(train, epochs=2, **kw)
        first = build()
        first.fit(train, epochs=1, **kw)
        first.save(str(workdir / "resume"))
        resumed = build(seed=5)
        resumed.load(str(workdir / "resume"))
        resumed.fit(train, epochs=1, **kw)
        (wp, wo), (rp, ro) = state(whole), state(resumed)
        _bitwise(wp, rp, "14a: resume, parameters")
        _bitwise(wo, ro, "14a: resume, Adam state")
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"[14a] prefetch_depth=2 = prefetch_depth=0 over "
        f"{len(runs[0][0])} steps, and 1 epoch + save + load into a fresh "
        f"Model + 1 epoch = 2 epochs: the same bits (losses, parameters, "
        f"moments, beta powers; global_step {wo['global_step']})")
    return out


def _no_pallas_counterparts(counted, launches, phase):
    got = _read_launches(counted, launches, phase)
    if any(got.values()):
        raise AssertionError(f"{phase}: a Pallas-kernel counterpart "
                             f"launched: {got}")


def train_mobilenet_fp16(dev, counted, launches):
    """Phase 14b: MobileNetV2 at ImageNet width in fp16 with loss
    scaling, fed by FakeData, the ImageNet transforms, 4 loader workers
    and the device prefetcher."""
    import multiprocessing

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.io import DataLoader, DevicePrefetcher
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.profiler import goodput
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import FakeData
    from paddle_tpu_torch.vision.models import mobilenet_v2

    model = mobilenet_v2(num_classes=1000, device=dev)
    opt = Momentum(0.1, 0.9, parameters=model.parameters(),
                   weight_decay=L2Decay(4e-5))
    scaler = amp.GradScaler(init_loss_scaling=2.0**15)
    loss_fn = CrossEntropyLoss()
    tf = T.Compose([T.RandomCrop(MOBILE_SIZE), T.RandomHorizontalFlip(),
                    T.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                data_format="HWC"), T.Transpose()])
    n_batches = 3 + MOBILE_STEPS + 2 + 2
    data = FakeData(num_samples=MOBILE_BATCH * n_batches,
                    image_shape=(256, 256, 3), num_classes=1000,
                    transform=tf)
    np.random.seed(0)
    loader = DataLoader(data, batch_size=MOBILE_BATCH, shuffle=True,
                        drop_last=True, num_workers=4, places=dev)
    pf = DevicePrefetcher(loader, depth=2, device=dev)
    scales = []

    def step(poison=False):
        img, lbl = next(pf)
        with amp.auto_cast(dtype="float16"):
            out = model(img)
        loss = loss_fn(out, lbl)
        scaled = scaler.scale(loss)
        scaled.backward()
        if poison:
            model.classifier[1].weight.grad[0, 0] = float("inf")
        scaler.minimize(opt, scaled)
        scales.append(scaler._scale)
        return loss.detach()

    try:
        t0 = time.perf_counter()
        warm = [step() for _ in range(3)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _cleared(counted)
        g0 = goodput.snapshot()["categories"]["input_wait"]
        times, losses = [], []
        t_all = time.perf_counter()
        for _ in range(MOBILE_STEPS):
            t = time.perf_counter()
            losses.append(step())
            times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
        wait = goodput.snapshot()["categories"]["input_wait"] - g0
        _no_pallas_counterparts(counted, launches, "mobilenet_fp16")
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step("14b", step, (), n_steps=2, top=12)

        # a step with a gradient made non-finite: nothing moves
        snap = lambda: ([p.detach().clone() for p in model.parameters()],
                        [opt.state_for(p)["velocity"].clone()
                         for p in model.parameters()], opt._global_step)
        before = snap()
        scale_before = scaler._scale
        step(poison=True)
        after = snap()
        skipped = (scaler._found_inf and scaler._scale == scale_before / 2
                   and after[2] == before[2]
                   and all(torch.equal(a, b) for a, b in
                           zip(before[0] + before[1], after[0] + after[1])))
        step()
        moved = snap()
        resumed = (not scaler._found_inf and moved[2] == before[2] + 1
                   and not torch.equal(moved[0][0], before[0][0]))
    finally:
        pf.close()
        del pf, loader
    for child in multiprocessing.active_children():
        child.join(timeout=30)
    if multiprocessing.active_children():
        raise AssertionError("14b: loader workers outlived the phase")
    times.sort()
    all_losses = [float(v) for v in torch.stack(warm + losses)]
    out = {"samples_per_s": MOBILE_BATCH * MOBILE_STEPS / wall,
           "step_ms_p50": times[len(times) // 2], "step_ms_min": times[0],
           "step_ms_max": times[-1], "first_3_steps_s": first_s,
           "input_wait_share": wait / wall, "peak_memory_bytes": peak,
           "losses": all_losses, "scales": scales, **prof}
    log(f"[14b] MobileNetV2 fp16 O1 + GradScaler at {MOBILE_BATCH} x 3 x "
        f"{MOBILE_SIZE}^2 (FakeData 256^2, RandomCrop, flip, Normalize, "
        f"Transpose, 4 workers, prefetch 2): {out['samples_per_s']:.1f} "
        f"samples/s over {MOBILE_STEPS} steps, step p50 "
        f"{out['step_ms_p50']:.2f} ms (min {times[0]:.2f}, max "
        f"{times[-1]:.2f}), input wait share {out['input_wait_share']:.4f}, "
        f"peak memory {peak / 2**30:.2f} GiB; device "
        f"{prof['device_ms_per_step']:.2f} ms a step, busy share "
        f"{prof['busy_share']:.4f}")
    log(f"[14b] loss {all_losses[0]:.4f} -> {all_losses[-1]:.4f}; scale a "
        f"step {scales}; forced overflow skipped cleanly {skipped}, next "
        f"step updated {resumed}")
    if not np.isfinite(all_losses).all():
        raise AssertionError(f"14b: a loss is not finite: {all_losses}")
    if not skipped or not resumed:
        raise AssertionError("14b: the forced non-finite step was not "
                             "skipped cleanly, or the next did not update")
    return out


def train_vgg_fp16(dev, counted, launches):
    """Phase 14c: VGG-16 at 224^2 in fp16 O1 with GradScaler."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import vgg16

    model = vgg16(num_classes=1000, device=dev)
    opt = Momentum(0.01, 0.9, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0**15)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(VGG_BATCH, 3, VGG_SIZE, VGG_SIZE, device=dev,
                    generator=gen)
    y = torch.randint(0, 1000, (VGG_BATCH, 1), device=dev, generator=gen)

    def step():
        with amp.auto_cast(dtype="float16"):
            out = model(x)
        loss = CrossEntropyLoss()(out, y)
        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.minimize(opt, scaled)
        return loss.detach()

    warm = [step() for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    losses, step_ms, wall = timed_steps(step, (), VGG_STEPS)
    _no_pallas_counterparts(counted, launches, "vgg_fp16")
    peak = torch.cuda.max_memory_allocated()
    all_losses = [float(v) for v in torch.stack(warm + losses)]
    out = {"samples_per_s": VGG_BATCH * VGG_STEPS / wall,
           "step_ms_p50": step_ms[VGG_STEPS // 2],
           "peak_memory_bytes": peak, "losses": all_losses,
           "scale": scaler._scale}
    log(f"[14c] VGG-16 fp16 O1 + GradScaler at {VGG_BATCH} x 3 x "
        f"{VGG_SIZE}^2: "
        f"{out['samples_per_s']:.1f} samples/s over {VGG_STEPS} steps, step "
        f"p50 {out['step_ms_p50']:.2f} ms, peak memory {peak / 2**30:.2f} "
        f"GiB; loss {all_losses}; scale {scaler._scale}")
    if not np.isfinite(all_losses).all() or not scaler._scale > 0:
        raise AssertionError(f"14c: loss {all_losses}, scale "
                             f"{scaler._scale}")
    return out


# --- phase 15: guarded and fingerprinted training ------------------------
# an lr at the top of f32's range: an Adam step moves an element by about
# lr, so a bf16-cast new master (GPT) or an AdamW-decayed f32 value (BERT)
# overflows while every gradient stays finite
LR_OVERFLOW = 3.4e38
# the fold's f32 sums, kernel against plain: the same values summed in
# another order; the signed sum within this share of the abs-sum
FOLD_SUM_RTOL = 1e-5
GUARD_STEPS = 5  # timed steps a mode, guard on and off


def state_bits(step):
    """The engine's state as one flat dict of on-device copies."""
    snap = step.snapshot_state()
    flat = {f"{g}/{n}": t for g in ("params", "buffers")
            for n, t in snap[g].items()}
    flat.update({f"opt/{n}/{k}": t for n, st in snap["opt_state"].items()
                 for k, t in st.items()})
    return flat


def same_bits(a, b, what):
    """Fail unless two flat state dicts hold the same bits (on the card)."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: the state's keys differ")
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} moved")


class ScaledByInput(torch.nn.Module):
    """``model``'s output times a float input: the float leaf of the batch
    that ``FaultInjector.corrupt_batch`` poisons (token ids cannot hold a
    NaN). Its first output (the loss, or the MLM logits) is scaled."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args):
        out = self.model(*args[:-1])
        if isinstance(out, tuple):
            return (out[0] * args[-1],) + tuple(out[1:])
        return out * args[-1]


def adam_lists(opt, params):
    """``Adam._fused_step``'s arguments for ``params`` (with gradients)."""
    states = [opt.state_for(p) for p in params]
    return ((
        [p.data for p in params], [p.grad for p in params],
        [s["moment1"] for s in states], [s["moment2"] for s in states],
        [s["beta1_pow"] for s in states], [s["beta2_pow"] for s in states],
        opt.lr_device_scalar(params[0].device)),
        dict(masters=[s.get("master") for s in states], beta1=opt._beta1,
             beta2=opt._beta2, eps=opt._epsilon,
             weight_decay=[opt._l2_coeff(p) for p in params],
             decoupled_decay=[opt._decoupled_coeff(p) for p in params]))


def pipeline_phase(counted, launches):
    """Phase 15a: ``bench_input_pipeline``'s twin at its full size."""
    from paddle_tpu_torch import bench

    # the same weights twice: one pass without the prefetcher, one with
    _cleared(counted)
    off_losses = bench.InputPipeline().epoch(False)
    on_run = bench.InputPipeline()
    on_losses = on_run.epoch(True)
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, "pipeline")
    n = 2 * on_run.n_batches
    want = {**{k: 0 for k in counted}, "adam": 2 * n}
    if got != want:
        raise AssertionError(f"15a launched {got}, expected {want}")
    if off_losses != on_losses:
        raise AssertionError(f"15a: the prefetcher changed the losses: "
                             f"{off_losses} vs {on_losses}")
    off = on_run.rate(False)
    on = on_run.rate(True)
    out = {"value": on, "prefetch_off_samples_per_sec": off,
           "speedup": on / off, "adam_launches_per_step": 2,
           "losses": on_losses}
    log(f"[15a] input pipeline (MLP 1024-1024-1024-10, Adam, batch 256, 30 "
        f"batches of 30 ms + decode): prefetch on {on:.1f} samples/s, off "
        f"{off:.1f}, speedup {on / off:.3f}; per-step losses on and off "
        f"the same bits; Adam 2 launches a step")
    return out


def fold_kernel_check(step, tree_reduce, sanitizer, leaves_fn, err):
    """Kernel B on an engine's state against its plain version, timed."""
    leaves = leaves_fn(step._state_tree())
    fp = tree_reduce.tree_reduce(leaves, "fold")
    again = tree_reduce.tree_reduce(leaves, "fold")
    ref = sanitizer.tree_fingerprint(leaves)
    torch.cuda.synchronize()
    x_k, x_p = int(fp["xor"]), int(ref["xor"])
    e_sum = abs(float(fp["sum"]) - float(ref["sum"]))
    e_abs = abs(float(fp["abs_sum"]) - float(ref["abs_sum"]))
    scale = float(ref["abs_sum"])
    err["tree_reduce"] = max(err["tree_reduce"], e_sum, e_abs)
    log(f"[15b] fold of {len(leaves)} leaves "
        f"({sum(t.numel() for t in leaves)} values): xor {x_k:#010x} "
        f"(plain {x_p:#010x}), sum err {e_sum:.4g}, abs-sum err "
        f"{e_abs:.4g} (tol {FOLD_SUM_RTOL} x {scale:.6g})")
    if x_k != x_p:
        raise AssertionError("15b: the fold's XOR word differs from the "
                             "plain version's")
    if max(e_sum, e_abs) > FOLD_SUM_RTOL * scale:
        raise AssertionError("15b: the fold's sums disagree")
    if not all(torch.equal(fp[k], again[k]) for k in fp):
        raise AssertionError("15b: two folds of one state differ")
    floats = [t for t in leaves if t.is_floating_point()]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * sum(t.numel() for t in floats) / F32_CORE_FLOPS
    kern = lambda: tree_reduce.tree_reduce(leaves, "fold")
    lib = lambda: torch._foreach_norm(floats, 1)
    return {"kernel": "tree_reduce", "shape": [len(leaves),
                                               sum(t.numel() for t in leaves)],
            "dtype": "mixed", "ms": time_ms(kern, iters=20),
            "device_ms": device_ms(kern, "tree_reduce fold"),
            "plain_ms": time_ms(lambda: sanitizer.tree_fingerprint(leaves),
                                iters=2, warmup=1),
            "library_ms": time_ms(lib, iters=20),
            "library_device_ms": device_ms(lib, "_foreach_norm(ord=1)"),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bert_fingerprint_phase(counted, launches, tree_reduce, sanitizer,
                           leaves_fn, corrupt_param_bit, fingerprint_digest,
                           err):
    """Phase 15b: BERT-base at bench_bert_dp's configuration with
    ``fingerprint_every=1``."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.text.models.bert import bert_base

    cfg = bert_base(hidden_dropout=0.0, attention_dropout=0.0)
    ids, mlm, nsp = bench.bert_batch(cfg)
    digests = []
    for run in range(2):
        step = bench.bert_engine(cfg, fingerprint_every=1)
        _cleared(counted)
        for _ in range(3):
            step((ids,), (mlm, nsp))
        torch.cuda.synchronize()
        got = _read_launches(counted, launches, f"bert_fingerprint_{run}")
        want = {**{k: 0 for k in counted}, "adam": 6, "tree_reduce": 6,
                "layer_norm_fwd": 3 * 26, "layer_norm_bwd": 3 * 52,
                "flash_attn_fwd_full": 36, "flash_attn_bwd_dq_full": 36,
                "flash_attn_bwd_dkv_full": 36}
        if got != want:
            raise AssertionError(f"15b launched {got}, expected {want}")
        digests.append([(s, fingerprint_digest(fp))
                        for s, fp in step.fingerprint_history()])
        if run == 0:
            del step
    log(f"[15b] two 3-step runs, fingerprints: {digests[0]} / {digests[1]}")
    if digests[0] != digests[1] or [s for s, _ in digests[0]] != [0, 1, 2]:
        raise AssertionError("15b: two identical runs gave other digests")
    timing = fold_kernel_check(step, tree_reduce, sanitizer, leaves_fn, err)
    # the fold's share of a step's device time, which the host's pace
    # does not move (bench_bert's columns below divide two host-timed
    # legs)
    plain = bench.bert_engine(cfg)
    dev_ms = {}
    for what, e in (("plain", plain), ("fingerprint", step),
                    ("fingerprint", step), ("plain", plain)):
        t = device_ms(lambda: e((ids,), (mlm, nsp)),
                      f"15b BERT step ({what})", iters=5)
        dev_ms[what] = min(t, dev_ms.get(what, t))
    del plain
    log(f"[15b] device time a step: {dev_ms['plain']:.3f} ms, "
        f"{dev_ms['fingerprint']:.3f} ms fingerprinting every step "
        f"(+{100 * (dev_ms['fingerprint'] / dev_ms['plain'] - 1):.2f}%)")
    before = int(step.state_fingerprint()["xor"])
    name = corrupt_param_bit(step)
    after = int(step.state_fingerprint()["xor"])
    log(f"[15b] corrupt_param_bit({name}): xor {before:#010x} -> "
        f"{after:#010x}")
    if before == after:
        raise AssertionError("15b: a flipped bit left the XOR word")
    del step
    torch.cuda.empty_cache()
    _cleared(counted)
    res = bench.bench_bert()
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, "bert_fingerprint_bench")
    n_fp = 2 + 3 * 30  # bench.bench_bert's fingerprinting leg
    if got["tree_reduce"] != 2 * n_fp or got["adam_check"]:
        raise AssertionError(f"15b: bench_bert launched {got}")
    log(f"[15b] bench_bert: {json.dumps(res)}")
    return {"digests": digests[0], "bench": res,
            "device_ms_step": dev_ms}, timing


def guard_phase(dev, counted, launches, model, make_opt, batch, loss_fn,
                label, fused, err, compute_dtype=torch.bfloat16):
    """Phase 15c on one model: StepGuard over a guarded engine — an
    injected NaN batch and an overflowing update kept out bit for bit, a
    rollback after two bad steps in a row, the step p50 with the guard on
    and off, and the check pass against its plain version."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.profiler.telemetry import get_telemetry
    from paddle_tpu_torch.resilience import (FaultInjector, RecoveryPolicy,
                                             StepGuard)

    wrapped = ScaledByInput(model)
    opt = make_opt(wrapped)
    inputs, labels = batch
    one = torch.ones((), device=dev)
    step = ParallelTrainStep(wrapped, loss_fn, opt,
                             compute_dtype=compute_dtype, guard_updates=True)
    guard = StepGuard(step, RecoveryPolicy(
        max_consecutive_bad=2, snapshot_every=1000, quarantine_dir=None),
        injector=FaultInjector(nan_steps=[2, 6, 7]))
    tel = get_telemetry()
    rollbacks = tel.counter_value("resilience/rollbacks")
    _cleared(counted)
    report = {}
    n_steps = 8  # bad: 2 (NaN), 4 (overflow), 6 and 7 (NaN: a rollback)
    for i in range(n_steps):
        if i == 4:
            opt.set_lr(LR_OVERFLOW)
        before = state_bits(step) if i in (2, 4) else None
        guard(inputs + (one,), labels)
        ok, bad = step.last_step_finite()
        if i in (2, 4):
            kind = "NaN batch" if i == 2 else f"lr {LR_OVERFLOW:g}"
            log(f"[15c] {label}: step {i} ({kind}) kept out: {len(bad)} "
                f"leaves named, e.g. {bad[:3]}")
            if ok or (i == 2 and "loss" not in bad) or (
                    i == 4 and any(b.startswith("grad") for b in bad)):
                raise AssertionError(f"15c {label}: step {i}: {ok} {bad}")
            same_bits(state_bits(step), before,
                      f"15c {label} bad step {i}")
            report[f"bad_{i}"] = len(bad)
            del before
            opt.set_lr(TRAIN_LR)
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, f"guard_{label}")
    if got["adam"] != 2 * n_steps or got["adam_check"] != 2 * n_steps:
        raise AssertionError(f"15c {label}: launches {got}")
    # steps 6 and 7 were bad in a row: the guard rolled back to its
    # snapshot, the state it loaded with
    if tel.counter_value("resilience/rollbacks") != rollbacks + 1:
        raise AssertionError(f"15c {label}: no rollback")
    flat = {}
    for g, tree in guard._snap.items():
        for n, t in tree.items():
            if isinstance(t, dict):
                flat.update({f"opt/{n}/{k}": v for k, v in t.items()})
            else:
                flat[f"{g}/{n}"] = t
    same_bits(state_bits(step), flat, f"15c {label} rollback")
    del flat
    log(f"[15c] {label}: 2 bad steps in a row rolled back to the "
        f"snapshot's bits; launches {got}")
    # the check pass against its plain version, on a real step's grads
    loss = loss_fn(step._apply(*inputs, one), *labels).float()
    loss.backward()
    params = [p for p in wrapped.parameters() if p.grad is not None]
    args, kw = adam_lists(opt, params)
    flags, _ = fused.adam_finite_check(*args, **kw, loss=loss.detach())
    ref = fused._adam_check_reference(*args, **kw, loss=loss.detach())
    if not torch.equal(flags, ref):
        raise AssertionError(f"15c {label}: the check pass's flags differ")
    numels = [p.numel() for p in params]
    g_size = params[0].grad.element_size()
    nbytes = sum(numels) * (g_size + 12)  # g, and p (or master), m, v
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 20 * sum(numels) / F32_CORE_FLOPS
    kern = lambda: fused.adam_finite_check(*args, **kw, loss=loss.detach())
    timing = {"kernel": "adam_check", "shape": [len(params), sum(numels)],
              "dtype": str(params[0].dtype)[6:],
              "ms": time_ms(kern, iters=20),
              "device_ms": device_ms(kern, f"adam_check {label}"),
              "plain_ms": time_ms(lambda: fused._adam_check_reference(
                  *args, **kw, loss=loss.detach()), iters=2, warmup=1),
              "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    opt.clear_grad()
    # the step time with the guard and without it, on one model
    plain = ParallelTrainStep(wrapped, loss_fn, opt,
                              compute_dtype=compute_dtype)
    clean = FaultInjector()
    guard._injector = clean
    p50 = {}
    # in turns (off, engine, guard, guard, engine, off): the guarded engine
    # alone (the check pass, no host read) and through StepGuard (one flag
    # read a step, which waits for the step to end)
    modes = {"off": lambda: plain(inputs + (one,), labels),
             "engine": lambda: step(inputs + (one,), labels),
             "guard": lambda: guard(inputs + (one,), labels)}
    for mode in ("off", "engine", "guard", "guard", "engine", "off"):
        modes[mode]()
        _, ms, _ = timed_steps(modes[mode], (), GUARD_STEPS)
        p50.setdefault(mode, []).append(ms[GUARD_STEPS // 2])
    p50 = {k: sorted(v)[0] for k, v in p50.items()}
    # the device's share: kernel time a step, which the host's pace does
    # not move
    dev_ms = {mode: device_ms(modes[mode], f"15c {label} step ({mode})",
                              iters=5) for mode in ("off", "engine")}
    log(f"[15c] {label}: step p50 (the better of two turns) "
        f"{p50['off']:.2f} ms without the guard, {p50['engine']:.2f} ms "
        f"with the guarded engine alone, {p50['guard']:.2f} ms through "
        f"StepGuard; device time a step {dev_ms['off']:.3f} ms without "
        f"the guard, {dev_ms['engine']:.3f} ms with it; check pass "
        f"{timing['device_ms']:.4f} ms device, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    report.update(step_ms_p50_off=p50["off"],
                  step_ms_p50_engine=p50["engine"],
                  step_ms_p50_guard=p50["guard"],
                  device_ms_off=dev_ms["off"],
                  device_ms_engine=dev_ms["engine"], check=timing)
    return report, timing


# --- phase 16: long-context training -----------------------------------
# GPT-small's attention at bench_gpt_long_context's L = 8192, b = 1
LONGCTX_ATTN_SHAPE = (1, 8192, 12, 64)
LONGCTX_STEPS = 3  # the counted window of the headline and forced legs
# the tiers on bf16 inputs against the f32 plain path, each output and
# gradient within a share of its largest magnitude: blockwise computes in
# f32 and rounds each result once (2^-8 of an element); the chunked tier
# stores its scores, exp weights and dS in bf16 as the reference does (a
# few roundings compound: 0.7% measured at L = 4096 on the CPU)
TIER_REL_TOL = {"xla": 2.0 ** -5, "blockwise": 2.0 ** -6}


def check_longctx_attention(rnd, flash_tpu, attention, err):
    """Phase 16a: #1-#3 at the long-context shape against their plain
    versions; the xla (chunked) and blockwise tiers' outputs and gradients
    against the plain materialized path; times of #1-#3 and SDPA's causal
    forward and backward. Returns the timing entries."""
    F = torch.nn.functional
    shape = LONGCTX_ATTN_SHAPE
    q, k, v, do = attn_operands(rnd, shape, torch.bfloat16)
    out, lse = flash_tpu.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_tpu._flash_reference(q, k, v)
    e_o, ok_o = worst(out, ref_out, *FLASH_OUT_TOL[torch.bfloat16])
    e_l, ok_l = worst(lse, ref_lse, *FLASH_LSE_TOL[torch.bfloat16])
    del ref_out, ref_lse
    err["flash_attn_fwd"] = max(err["flash_attn_fwd"], e_o, e_l)
    res, res32, res_d = check_flash_backward(flash_tpu, q, k, v, do, out,
                                             lse, True, None)
    for name, (e, _) in zip(("flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                             "flash_attn_bwd_dkv"), res):
        err[name] = max(err[name], e)
    log(f"[16a] flash bf16 (b,L,H,d)={shape}: out err {e_o:.3g} (tol "
        f"{FLASH_OUT_TOL[torch.bfloat16]}), lse err {e_l:.3g}; "
        + bwd_report(res, res32, res_d))
    if not (ok_o and ok_l and all(ok for _, ok in res + res32)
            and res_d[1]):
        raise AssertionError("a flash kernel disagrees at L = 8192")
    torch.cuda.empty_cache()

    # the tiers against the f32 plain path, forward and backward
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention._materialized(*leaves, causal=True, layout="blhd")
    refs = [ref.detach(), *torch.autograd.grad(ref, leaves, do.float())]
    del ref, leaves
    torch.cuda.empty_cache()
    tr = lambda t: t.transpose(1, 2)
    tiers = {"xla": lambda a, b, c: attention.xla_attention(
                 a, b, c, causal=True, layout="blhd"),
             "blockwise": lambda a, b, c: tr(attention.blockwise_attention(
                 tr(a), tr(b), tr(c), causal=True))}
    for tier, fn in tiers.items():
        lv = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*lv)
        got = [o.detach(), *torch.autograd.grad(o, lv, do)]
        errs = [float((a.float() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, refs)]
        log(f"[16a] tier {tier} bf16 {shape}: out/dq/dk/dv max err "
            + "/".join(f"{e:.4f}" for e in errs)
            + f" of max|ref| (tol {TIER_REL_TOL[tier]:.4g})")
        if max(errs) > TIER_REL_TOL[tier]:
            raise AssertionError(f"the {tier} tier disagrees at L = 8192")
        del lv, o, got
    del refs
    torch.cuda.empty_cache()

    # times, as phases 3 and 3b take them
    timings = []
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bound, by = flash_bound(*shape, torch.bfloat16)
    timings.append({
        "kernel": "flash_attn_fwd", "shape": list(shape),
        "dtype": "bfloat16",
        "ms": time_ms(lambda: flash_tpu.flash_attention_blhd(q, k, v),
                      iters=20),
        "plain_ms": time_ms(lambda: flash_tpu._flash_reference(q, k, v),
                            iters=5, warmup=1),
        "library_ms": time_ms(sdpa, iters=20),
        "device_ms": device_ms(lambda: flash_tpu.flash_attention_blhd(
            q, k, v), f"flash_attn_fwd {shape}"),
        "library_device_ms": device_ms(sdpa, f"SDPA {shape}"),
        "bound_ms": bound, "bound_by": by})
    _, delta = flash_tpu.flash_bwd_dq(q, k, v, do, lse, out)
    lt = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    ys = F.scaled_dot_product_attention(*lt, is_causal=True)
    lib = lambda: torch.autograd.grad(ys, lt, do.transpose(1, 2),
                                      retain_graph=True)
    plain_ms = time_ms(lambda: flash_tpu._flash_bwd_reference(
        q, k, v, out, lse, do, operand_dtype=torch.bfloat16), iters=3, warmup=1)
    lib_ms, lib_dev = time_ms(lib, iters=20), device_ms(
        lib, f"SDPA's causal backward {list(shape)}")
    for name, kern in (
            ("dq", lambda: flash_tpu.flash_bwd_dq(q, k, v, do, lse, out)),
            ("dkv", lambda: flash_tpu.flash_bwd_dkv(q, k, v, do, lse,
                                                    delta))):
        bound, by = flash_bound(*shape, torch.bfloat16, name)
        timings.append({
            "kernel": f"flash_attn_bwd_{name}", "shape": list(shape),
            "dtype": "bfloat16", "ms": time_ms(kern, iters=20),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_ms": device_ms(kern, f"flash_attn_bwd_{name} {shape}"),
            "library_device_ms": lib_dev, "bound_ms": bound, "bound_by": by,
            "note": "plain and library times are the whole backward "
                    "(dQ, dK and dV)"})
    for t in timings:
        log(f"[16a] time {t['kernel']} {t['shape']} bf16: device "
            f"{t['device_ms']:.4f} ms (events {t['ms']:.4f}), "
            f"{t['bound_ms'] / t['device_ms']:.3f} of its bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}); plain "
            f"{t['plain_ms']:.3f} ms; SDPA device "
            f"{t['library_device_ms']:.4f} ms "
            f"(events {t['library_ms']:.4f})")
    del q, k, v, do, out, lse, delta, lt, ys
    torch.cuda.empty_cache()
    return timings


def longctx_phase(counted, launches, bench_mod):
    """Phase 16b: ``bench_gpt_long_context``'s twin at full size
    (``bench.bench_longctx``); its legs' launches go to
    ``launches[kernel]["longctx_bench"]``, the headline engine's counted
    window to ``["longctx"]``, a leg forced onto ``flash_tpu`` (when the
    verdict is another tier) to ``["longctx_flash"]``. Returns the bench's
    result and the phase that ran #1-#3."""
    from paddle_tpu_torch.profiler.telemetry import get_telemetry

    config, b, L, _ = bench_mod.longctx_config()
    n_layers = config.num_layers
    window = {}

    def counted_steps(engine, ids, labels, phase):
        _cleared(counted)
        losses = [float(engine((ids,), (labels,)))
                  for _ in range(LONGCTX_STEPS)]
        torch.cuda.synchronize()
        per_step = {n: c / LONGCTX_STEPS for n, c in
                    _read_launches(counted, launches, phase).items()}
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{phase}: losses {losses} not finite "
                                 "and falling")
        return losses, per_step

    def hook(engine, ids, labels):
        _read_launches(counted, launches, "longctx_bench")
        torch.cuda.reset_peak_memory_stats()
        window["losses"], window["per_step"] = counted_steps(
            engine, ids, labels, "longctx")
        window["peak_bytes"] = torch.cuda.max_memory_allocated()
        window["profile"] = profile_step("16b", engine, ((ids,), (labels,)))

    _cleared(counted)
    t0 = time.perf_counter()
    result = bench_mod.bench_longctx(headline_hook=hook)
    seconds = time.perf_counter() - t0
    tier = result["attn_tier_selected"]
    log(f"[16b] longctx bench ({seconds:.1f} s): tier verdict {tier}, "
        f"timings (ms, fwd+bwd at [1, 12, 8192, 64] bf16) "
        f"{result['tier_timings_ms']}; tokens/s {result['value']} "
        f"(forced blockwise {result['tokens_per_sec_forced_blockwise']}, "
        f"speedup {result['tier_ablation_speedup']}), mfu "
        f"{result['mfu_pct']}%")
    log(f"[16b] remat probe: off peak {result['remat_off_peak_hbm_bytes']:.0f}"
        f" B, budget {result['remat_budget_bytes']:.0f} B, chosen "
        f"{result['remat_auto_policy']!r} at "
        f"{result['remat_auto_peak_hbm_bytes']:.0f} B")
    if not (result["remat_auto_peak_hbm_bytes"]
            <= result["remat_off_peak_hbm_bytes"]):
        raise AssertionError("remat='auto' chose a peak above the off peak")
    fallbacks = get_telemetry().counter_value("attn/tier_fallbacks")
    if fallbacks:
        raise AssertionError(f"{fallbacks} attention calls were rerouted")
    per_step = window["per_step"]
    flash_steps = 1 if tier == "flash_tpu" else 0
    want = {"flash_attn_fwd": n_layers * flash_steps,
            "flash_attn_bwd_dq": n_layers * flash_steps,
            "flash_attn_bwd_dkv": n_layers * flash_steps,
            "layer_norm_fwd": 2 * n_layers + 1, "adam": 2}
    log(f"[16b] headline leg ({tier}): losses {window['losses']}, peak "
        f"{window['peak_bytes']} B, launches a step {per_step}")
    result["headline_profile"] = window["profile"]
    result["headline_peak_bytes"] = window["peak_bytes"]
    for name, n in want.items():
        if per_step[name] != n:
            raise AssertionError(f"longctx: {name} launched {per_step[name]}"
                                 f" a step, expected {n}")
    flash_phase = "longctx"
    if tier != "flash_tpu":
        # the verdict went elsewhere: #1-#3 still run in this training step
        flash_phase = "longctx_flash"
        ids, labels = bench_mod.longctx_batch(config, b, L)
        with forced_attention_policy("flash_tpu"):
            engine = bench_mod.longctx_engine(config)
            losses, per_step = counted_steps(engine, ids, labels,
                                             flash_phase)
        del engine
        log(f"[16b] forced flash_tpu leg: losses {losses}, launches a step "
            f"{per_step}")
        for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                     "flash_attn_bwd_dkv"):
            if per_step[name] != n_layers:
                raise AssertionError(f"forced flash_tpu: {name} launched "
                                     f"{per_step[name]} a step")
        torch.cuda.empty_cache()
    return result, flash_phase


@contextlib.contextmanager
def forced_attention_policy(policy):
    saved = os.environ.get("PADDLE_TPU_ATTN_POLICY")
    os.environ["PADDLE_TPU_ATTN_POLICY"] = policy
    try:
        yield
    finally:
        if saved is None:
            del os.environ["PADDLE_TPU_ATTN_POLICY"]
        else:
            os.environ["PADDLE_TPU_ATTN_POLICY"] = saved


@contextlib.contextmanager
def step_grad_norms(engine, norms):
    """Append to ``norms`` the global norm (f32, a device scalar) of the
    gradients that each of ``engine``'s optimizer steps is about to apply;
    the step itself is left as it is."""
    opt = engine._optimizer
    real = opt.step
    params = [p for p in engine._layer.parameters() if p.requires_grad]

    def step(*a, **k):
        norms.append(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad.float()) for p in params
             if p.grad is not None])))
        return real(*a, **k)

    opt.step = step
    try:
        yield
    finally:
        del opt.step


def longctx_remat_phase(counted, launches, bench_mod):
    """Phase 16c: remat 'offload' and 'auto' at the long-context shape,
    held against 'off' as phase 12b holds the other policies — step 1's
    loss, the global norm of step 1's gradients (what 'offload''s copies
    out to pinned host memory and back feed) and step 2's loss, all the
    bits of 'off' when two 'off' runs agree bit for bit, else no further
    from 'off' than they are from each other. 'auto' resolves with the
    card's memory pinned to 60% of 'off''s measured peak, so that it takes
    a recompute rung. Offload's measured peak must lie below
    'dots_no_batch''s."""
    config, b, L, _ = bench_mod.longctx_config()
    ids, labels = bench_mod.longctx_batch(config, b, L)
    runs, peaks = {}, {}
    saved = os.environ.get("PADDLE_TPU_DEVICE_HBM_BYTES")
    try:
        for run, policy in enumerate(("off", "off", "dots_no_batch",
                                      "offload", "auto")):
            engine = bench_mod.longctx_engine(config, remat=policy)
            if run == 0:
                for p in ("off", "dots_no_batch", "offload"):
                    peaks[p] = engine.lower_cost(p, (ids,), (labels,))[
                        "peak_hbm_bytes"]
                pinned = int(0.6 * peaks["off"])
            if policy == "auto":
                os.environ["PADDLE_TPU_DEVICE_HBM_BYTES"] = str(pinned)
            norms = []
            with step_grad_norms(engine, norms):
                _cleared(counted)
                losses = [engine((ids,), (labels,)) for _ in range(2)]
                torch.cuda.synchronize()
            _read_launches(counted, launches, f"longctx_remat_{policy}")
            name = f"{policy}#2" if (policy == "off" and run) else policy
            runs[name] = torch.stack([losses[0], norms[0], losses[1]])
            if policy == "auto":
                chosen = engine.remat_policy_chosen
            del engine
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_DEVICE_HBM_BYTES", None)
        else:
            os.environ["PADDLE_TPU_DEVICE_HBM_BYTES"] = saved
    noise = (runs["off"] - runs["off#2"]).abs()
    bitwise_off = not bool(noise.any())
    got = {k: [float(x) for x in v] for k, v in runs.items()}
    log(f"[16c] (step 1 loss, step 1 grad norm, step 2 loss): {got}; two "
        f"'off' runs differ by {[float(x) for x in noise]}; auto chose "
        f"{chosen!r} with the memory pinned to {pinned} B; peaks off "
        f"{peaks['off']:.0f} B, offload {peaks['offload']:.0f} B, "
        f"dots_no_batch {peaks['dots_no_batch']:.0f} B")
    for name, v in runs.items():
        if (not torch.equal(v, runs["off"])) if bitwise_off else \
                bool(((v - runs["off"]).abs() > noise).any()):
            raise AssertionError(f"16c: {name} gives {got[name]}, 'off' "
                                 f"{got['off']} (off vs off "
                                 f"{[float(x) for x in noise]})")
    if chosen == "off":
        raise AssertionError("16c: 'auto' took no recompute with the "
                             "memory pinned below 'off''s peak")
    if not peaks["offload"] < peaks["dots_no_batch"]:
        raise AssertionError("16c: offload's peak is not below "
                             "dots_no_batch's")
    return {"runs": got, "bitwise_off_vs_off": bitwise_off,
            "auto_chosen": chosen, "auto_pinned_memory_bytes": pinned,
            "peak_off_bytes": peaks["off"],
            "peak_offload_bytes": peaks["offload"],
            "peak_dots_no_batch_bytes": peaks["dots_no_batch"]}


# --- phase 17: the static graph ---------------------------------------------
# 17a: ResNet-50 f32 at 13b's shape recorded into a Program, one exe.run
# against one eager step of a dygraph copy (same weights and buffers), with
# 13b's bounds: both run the same torch ops on the card, so the loss within
# R50_FWD_TOL relative and every update p' - p within R50_GRAD_L2_TOL of
# its L2 norm; the running statistics keep their record-time bits (the
# update runs at record time only); then the same program at a second batch
STATIC_SECOND_BATCH = 3
# 17b: config #2 as bench resnet50 runs it, windows of 20 steps
STATIC_WINDOW = 20
STATIC_WINDOWS = 2
# the replay's host cost: a batch at which the host bounds the step
STATIC_HOST_BATCH = 2
STATIC_HOST_STEPS = 10
# step 1's loss against 13c's TrainStep loss from the same weights and
# batch: the same bf16 AMP O1 ops, but cuDNN may pick other algorithms for
# another call order, and the bf16 logits' roundings move the mean loss by
# a few 2^-9 of its value
STATIC_R50_LOSS_RTOL = 2.0 ** -6
# 17c: GPT-2 345M at depth 2 (full width), 8 x 1024, bf16 parameters with
# Adam's f32 masters; kernels against plain within phase 7's bf16 loss
# tolerance (LOSS_BF16_RTOL)
STATIC_GPT_LAYERS = 2
STATIC_GPT_RUNS = 3


def static_resnet_check(dev):
    """Phase 17a: a recorded ResNet-50 step on the card against an eager
    step of a copy, then a run at another batch."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    b0, c, h, w = R50_CHECK_SHAPE
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.randn(b, c, h, w).astype(
        np.float32)).to(dev), torch.from_numpy(rng.randint(
            0, 1000, (b, 1))).to(dev)) for b in (b0, STATIC_SECOND_BATCH)]
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, c, h, w], "float32", device=dev)
        y = static.data("y", [None, 1], "int64", device=dev)
        model = resnet50(num_classes=1000, seed=3, device=dev)
        loss = cross_entropy(model(x), y.reshape(-1))
        Momentum(0.01, 0.9).minimize(loss)
    eager = resnet50(num_classes=1000, seed=4, device=dev)
    eager.load_state_dict(model.state_dict())
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    recorded = {n: b.detach().clone() for n, b in model.named_buffers()}
    exe = static.Executor(dev)
    (l_s,) = exe.run(main, feed={"x": batches[0][0], "y": batches[0][1]},
                     fetch_list=[loss])
    opt = Momentum(0.01, 0.9, parameters=eager.parameters())
    l_e = cross_entropy(eager(batches[0][0]), batches[0][1].reshape(-1))
    l_e.backward()
    opt.step()
    l_s, l_e = float(l_s), float(l_e.detach())
    e_loss = abs(l_s - l_e) / abs(l_e)
    eager_p = dict(eager.named_parameters())
    e_upd = max(l2_rel(p.detach() - params0[n], eager_p[n].detach()
                       - params0[n]) for n, p in model.named_parameters())
    kept = all(torch.equal(b, recorded[n])
               for n, b in model.named_buffers())
    (l_s2,) = exe.run(main, feed={"x": batches[1][0], "y": batches[1][1]},
                      fetch_list=[loss])
    with torch.no_grad():
        l_e2 = float(cross_entropy(eager(batches[1][0]),
                                   batches[1][1].reshape(-1)))
    e_loss2 = abs(float(l_s2) - l_e2) / abs(l_e2)
    out = {"ops": len(main.ops), "params": len(main.parameters),
           "loss_static": l_s, "loss_eager": l_e, "loss_rel_err": e_loss,
           "update_l2_rel_err": e_upd, "running_stats_as_recorded": kept,
           "second_batch": STATIC_SECOND_BATCH,
           "loss_static_second": float(l_s2), "loss_eager_second": l_e2,
           "loss_rel_err_second": e_loss2}
    log(f"[17a] ResNet-50 f32 {R50_CHECK_SHAPE} recorded ({out['ops']} ops, "
        f"{out['params']} parameters), one exe.run against one eager "
        f"Momentum step (TF32 off): loss {l_s:.6f} / {l_e:.6f} (rel err "
        f"{e_loss:.3g}, tol {R50_FWD_TOL}), worst update L2 rel err "
        f"{e_upd:.3g} (tol {R50_GRAD_L2_TOL}), running statistics as "
        f"recorded: {kept}; at batch {STATIC_SECOND_BATCH}: loss "
        f"{float(l_s2):.6f} / {l_e2:.6f} (rel err {e_loss2:.3g})")
    if not (e_loss <= R50_FWD_TOL and e_upd <= R50_GRAD_L2_TOL and kept
            and e_loss2 <= R50_FWD_TOL):
        raise AssertionError("17a: the recorded ResNet-50 step disagrees "
                             "with the eager one")
    return out


def static_resnet_bench(counted, launches, bench_mod, trainstep_loss0):
    """Phase 17b: config #2 through bench resnet50's own function."""
    t0 = time.perf_counter()
    step, b, parts = bench_mod.build_resnet50_train(window=STATIC_WINDOW)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    warm = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(STATIC_WINDOWS + 1)]
    windows = []
    t0 = time.perf_counter()
    for i in range(STATIC_WINDOWS):
        marks[i].record()
        windows.append(step())
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_launches(counted, launches, "static_resnet")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(marks[i].elapsed_time(marks[i + 1]) / STATIC_WINDOW
                     for i in range(STATIC_WINDOWS))
    prof = profile_step("17b", step, (), n_steps=1)
    host = static_host_cost(parts)
    losses = [[float(v) for v in w] for w in [warm] + windows]
    flat = [v for w in losses for v in w]
    sps = b * STATIC_WINDOW * STATIC_WINDOWS / wall
    e_first = abs(flat[0] - trainstep_loss0) / abs(trainstep_loss0)
    exe = parts["executor"]
    plan_ops = max(len(p.ops) for p in exe._plans.values())
    out = {"samples_per_s": sps, "step_ms_p50": step_ms[len(step_ms) // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "peak_memory_bytes": peak, "record_s": record_s,
           "ops": len(parts["program"].ops), "plan_ops": plan_ops,
           "window_losses": losses,
           "device_ms_per_step": prof["device_ms_per_step"] / STATIC_WINDOW,
           "wall_ms_per_step": prof["wall_ms_per_step"] / STATIC_WINDOW,
           "busy_share": prof["busy_share"],
           "device_ms_by_kind": {k: v / STATIC_WINDOW for k, v in
                                 prof["device_ms_by_kind"].items()},
           "mfu_pct": 100.0 * sps * bench_mod.RESNET50_FLOPS_PER_SAMPLE
           / bench_mod.H100_BF16_DENSE_FLOPS,
           "step1_loss": flat[0], "trainstep_step1_loss": trainstep_loss0,
           "step1_loss_rel_err": e_first, "host_bound_b2": host}
    log(f"[17b] config #2 through static.Executor.run_steps(window="
        f"{STATIC_WINDOW}): recorded in {record_s:.2f} s ({out['ops']} ops, "
        f"{plan_ops} in the replay plan); {sps:.1f} samples/s over "
        f"{STATIC_WINDOWS} windows, step p50 {out['step_ms_p50']:.2f} ms "
        f"(window / {STATIC_WINDOW}; min {step_ms[0]:.2f}, max "
        f"{step_ms[-1]:.2f}), peak memory {peak / 2**30:.2f} GiB; profiled "
        f"window: {out['device_ms_per_step']:.2f} ms of device time and "
        f"{out['wall_ms_per_step']:.2f} ms of wall a step, busy share "
        f"{out['busy_share']:.4f}; MFU {out['mfu_pct']:.2f}%; step 1 loss "
        f"{flat[0]:.6f} against 13c's TrainStep {trainstep_loss0:.6f} (rel "
        f"err {e_first:.3g}, tol {STATIC_R50_LOSS_RTOL})")
    log(f"[17b] at b = {STATIC_HOST_BATCH} (host-bound): a step "
        f"{host['static_ms']:.2f} ms through exe.run, {host['eager_ms']:.2f} "
        f"ms as an eager step of the same model (medians of "
        f"{2 * STATIC_HOST_STEPS} steps each, alternated); the replay adds "
        f"{host['static_ms'] - host['eager_ms']:.2f} ms")
    for i, w in enumerate(losses):
        log(f"[17b] window {i} losses: {w[0]:.4f} ... {w[-1]:.4f}")
    if not all(np.isfinite(flat)) or not flat[-1] < flat[0]:
        raise AssertionError(f"17b: the loss is not finite and falling: "
                             f"{losses}")
    if any(got.values()):
        raise AssertionError(f"17b: a Pallas-kernel counterpart launched "
                             f"in config #2's step: {got}")
    if e_first > STATIC_R50_LOSS_RTOL:
        raise AssertionError("17b: step 1's loss disagrees with 13c's")
    return out


def static_host_cost(parts):
    """Per-step wall at a batch small enough that the host bounds the
    step: ``exe.run`` of the recorded program against an eager step
    (forward under the same AMP, backward, Momentum) of the same model,
    alternated, each step synchronized."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum

    exe, main, loss = parts["executor"], parts["program"], parts["loss"]
    feed = {k: v[:STATIC_HOST_BATCH] for k, v in parts["feed"].items()}
    model = parts["model"]
    opt = Momentum(0.01, 0.9, parameters=model.parameters())

    def static_step():
        return exe.run(main, feed=feed, fetch_list=[loss],
                       return_numpy=False)[0]

    def eager_step():
        with amp.auto_cast(dtype="bfloat16"):
            out = cross_entropy(model(feed["x"]), feed["y"].reshape(-1))
        out.backward()
        opt.step()
        opt.clear_grad()
        return out

    times = {"static": [], "eager": []}
    for fn in (static_step, eager_step):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for _ in range(2):
        for name, fn in (("static", static_step), ("eager", eager_step)):
            for _ in range(STATIC_HOST_STEPS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {f"{k}_ms": float(np.median(v)) for k, v in times.items()}


def static_gpt_kernels(dev, gen, counted, launches, gpt_mod, plain, dense):
    """Phase 17c: the kernels through the program machinery — a recorded
    GPT-2 345M training step (depth 2) with the kernels and, recorded
    again, inside ``plain``; then ``jit.to_static`` of the dense forward
    against phase 4's logits."""
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.optimizer import Adam

    cfg = gpt_mod.gpt2_medium(num_layers=STATIC_GPT_LAYERS,
                              hidden_dropout=0.0, attention_dropout=0.0)
    ids = torch.randint(0, cfg.vocab_size, TRAIN_SHAPE, device=dev,
                        generator=gen)
    labels = torch.roll(ids, -1, dims=1)
    feed = {"ids": ids, "labels": labels}

    def record():
        main = static.Program()
        with static.program_guard(main):
            x = static.data("ids", list(TRAIN_SHAPE), "int64", device=dev)
            y = static.data("labels", list(TRAIN_SHAPE), "int64",
                            device=dev)
            model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.bfloat16,
                                           seed=5)
            loss = model(x, y)
            Adam(TRAIN_LR, multi_precision=True).minimize(loss)
        return main, loss

    exe = static.Executor(dev)
    main_k, loss_k = record()
    _cleared(counted)
    losses_k = [float(exe.run(main_k, feed=feed, fetch_list=[loss_k])[0])
                for _ in range(STATIC_GPT_RUNS)]
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, "static_gpt")
    n = STATIC_GPT_LAYERS
    n_ln = 2 * n + 1
    want = {name: 0 for name in counted}
    want.update({"flash_attn_fwd": n, "flash_attn_bwd_dq": n,
                 "flash_attn_bwd_dkv": n, "layer_norm_fwd": n_ln,
                 "layer_norm_bwd": 2 * n_ln, "adam": 2})
    want = {k: v * STATIC_GPT_RUNS for k, v in want.items()}
    with plain():
        main_p, loss_p = record()
        losses_p = [float(exe.run(main_p, feed=feed,
                                  fetch_list=[loss_p])[0])
                    for _ in range(STATIC_GPT_RUNS)]
    e_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    del main_k, main_p
    torch.cuda.empty_cache()
    # jit.to_static of the dense forward: phase 4's model and ids
    dense_ids, dense_logits = dense
    model = gpt_mod.GPTForCausalLM(gpt_mod.gpt2_medium(), dtype=torch.bfloat16,
                                   seed=0).eval()
    _cleared(counted)
    logits = jit.to_static(model)(dense_ids)
    torch.cuda.synchronize()
    got_st = _read_launches(counted, launches, "static_to_static")
    same = torch.equal(logits.cpu(), dense_logits)
    out = {"losses_kernels": losses_k, "losses_plain": losses_p,
           "loss_rel_err": e_loss, "launches_per_run": {
               k: v // STATIC_GPT_RUNS for k, v in got.items() if v},
           "to_static_same_bits": same,
           "to_static_launches": {k: v for k, v in got_st.items() if v},
           "to_static_requires_grad": logits.requires_grad}
    log(f"[17c] GPT-2 345M at depth {n}, {TRAIN_SHAPE}, bf16 with Adam's "
        f"f32 masters, {STATIC_GPT_RUNS} exe.run of a recorded program: "
        f"losses {losses_k} through the kernels, {losses_p} plain (rel err "
        f"{e_loss:.3g}, tol {LOSS_BF16_RTOL}); launches a run "
        f"{out['launches_per_run']}; jit.to_static dense forward [1, 1024]: "
        f"phase 4's bits {same}, launches {out['to_static_launches']}")
    if got != want:
        raise AssertionError(f"17c: the recorded step launched {got}, "
                             f"expected {want}")
    if not (e_loss <= LOSS_BF16_RTOL and all(np.isfinite(losses_k))):
        raise AssertionError("17c: the recorded step through the kernels "
                             "disagrees with the plain one")
    if not same or logits.requires_grad:
        raise AssertionError("17c: jit.to_static's logits are not phase "
                             "4's")
    if (got_st["layer_norm_fwd"], got_st["flash_attn_fwd"]) != (49, 24):
        raise AssertionError(f"17c: to_static launched {got_st}, expected "
                             "49 LayerNorm and 24 attention forwards")
    return out


# phase 18: serving breadth. The Predictor's batch for the timed forward,
# the draft of 18c (GPT-2 345M's vocabulary, hidden 512, 1 layer, 8 heads)
# and the prompts of 18c and 18d
PREDICTOR_BATCH = 8
# forwards off the clock, then single forwards whose median is the p50
PREDICTOR_WARMUP, PREDICTOR_SAMPLES = 3, 31
SPEC_K = 3
SPEC_DRAFT = dict(vocab_size=50304, hidden_size=512, num_layers=1,
                  num_heads=8, hidden_dropout=0.0, attention_dropout=0.0)
SPEC_PROMPTS = (40, 150)
SPEC_NEW_TOKENS = 8
INT8_PROMPTS = (32, 200, 77, 128)
INT8_NEW_TOKENS = 16
# int8 pages plus one f32 scale per token-head: (64 + 4) / 128 of a bf16
# pool at head dim 64 = 0.53
INT8_POOL_SHARE = 0.55
# tests/test_torch_quant_kv.py's (and the reference's
# test_int8_kv_close_to_bf16_reference) rule: the int8 pool's logits within
# 5% of the bf16 pool's logit range
INT8_LOGIT_SPAN_SHARE = 0.05


@contextlib.contextmanager
def kernel_shapes(fused, flash_tpu):
    """While open, records every call of the LayerNorm and flash forward
    wrappers (shape, dtype, strides, options): the shapes a main path gave
    the kernels, which ``check_kernel_shapes`` then holds against the
    plain versions. Launch counts are untouched."""
    seen = {"layer_norm_fwd": set(), "flash_attn_fwd": set()}
    ln_fwd, flash_fwd = fused._ln_fwd, flash_tpu._fwd

    def ln(x, weight, bias, eps):
        seen["layer_norm_fwd"].add(
            (x.numel() // x.shape[-1], x.shape[-1], x.dtype,
             fused._alignment(x, weight, bias) % 16 == 0, eps))
        return ln_fwd(x, weight, bias, eps)

    def flash(q, k, v, causal=True, key_bias=None):
        seen["flash_attn_fwd"].add(
            (tuple(q.shape), q.dtype, causal, key_bias is not None,
             q.stride(), k.stride(), v.stride()))
        return flash_fwd(q, k, v, causal, key_bias)

    fused._ln_fwd, flash_tpu._fwd = ln, flash
    try:
        yield seen
    finally:
        fused._ln_fwd, flash_tpu._fwd = ln_fwd, flash_fwd


def check_kernel_shapes(dev, gen, seen, fused, flash_tpu, err):
    """18: each call shape that ``kernel_shapes`` recorded, on fresh
    inputs of that shape, dtype and layout, through the kernel and the
    plain version (``LN_TOL``, ``FLASH_OUT_TOL`` / ``FLASH_LSE_TOL``)."""
    rnd = lambda *shape, dtype: torch.randn(
        *shape, device=dev, generator=gen).to(dtype)

    def strided(shape, stride, dtype):
        t = torch.empty_strided(shape, stride, dtype=dtype, device=dev)
        return t.copy_(rnd(*shape, dtype=dtype))

    worst_ln = worst_fl = 0.0
    bad = []
    for rows, hidden, dtype, aligned, eps in sorted(
            seen["layer_norm_fwd"], key=str):
        x = rnd(rows, hidden, dtype=dtype)
        x = x if aligned else misaligned(x)
        w, b = rnd(hidden, dtype=dtype), rnd(hidden, dtype=dtype)
        e, ok = worst(fused._ln_fwd(x, w, b, eps),
                      fused._ln_reference(x, w, b, eps), *LN_TOL[dtype])
        worst_ln = max(worst_ln, e)
        if not ok:
            bad.append(("layer_norm_fwd", rows, hidden, dtype, aligned, e))
    for shape, dtype, causal, biased, qs, ks, vs in sorted(
            seen["flash_attn_fwd"], key=str):
        q, k, v = (strided(shape, st, dtype) for st in (qs, ks, vs))
        kb = padding_bias(shape[0], shape[1], gen, dev) if biased else None
        out, lse = flash_tpu._fwd(q, k, v, causal, kb)
        ref_out, ref_lse = flash_tpu._flash_reference(q, k, v, causal, kb)
        e_o, ok_o = worst(out, ref_out, *FLASH_OUT_TOL[dtype])
        e_l, ok_l = worst(lse, ref_lse, *FLASH_LSE_TOL[dtype])
        worst_fl = max(worst_fl, e_o, e_l)
        if not (ok_o and ok_l):
            bad.append(("flash_attn_fwd", shape, dtype, causal, qs, e_o,
                        e_l))
    torch.cuda.synchronize()
    err["layer_norm_fwd"] = max(err["layer_norm_fwd"], worst_ln)
    err["flash_attn_fwd"] = max(err["flash_attn_fwd"], worst_fl)
    widths = sorted({(h, str(d)[6:]) for _, h, d, _, _ in
                     seen["layer_norm_fwd"]})
    rows = sorted({r for r, *_ in seen["layer_norm_fwd"]})
    lengths = {}  # (b, H, d, dtype) -> the sequence lengths seen
    for (b, L, H, d), dtype, *_ in seen["flash_attn_fwd"]:
        lengths.setdefault(f"b{b} H{H} d{d} {str(dtype)[6:]}", set()).add(L)
    flash_shapes = {k: f"L {min(v)}-{max(v)} ({len(v)})"
                    for k, v in sorted(lengths.items())}
    log(f"[18] the kernels at every shape phases 18b-18d gave them, against "
        f"the plain versions: layer_norm_fwd {len(seen['layer_norm_fwd'])} "
        f"shapes (widths {widths}, rows {rows}) max err {worst_ln:.3g} "
        f"(tol f32 {LN_TOL[torch.float32]}, bf16 {LN_TOL[torch.bfloat16]});"
        f" flash_attn_fwd {len(seen['flash_attn_fwd'])} shapes "
        f"{flash_shapes} max err {worst_fl:.3g} (f32 out and lse tol "
        f"{FLASH_OUT_TOL[torch.float32]}, bf16 out "
        f"{FLASH_OUT_TOL[torch.bfloat16]}, lse "
        f"{FLASH_LSE_TOL[torch.bfloat16]})")
    if bad:
        raise AssertionError(f"18: a kernel disagrees with its plain "
                             f"version at the main path's shapes: {bad}")
    return {"layer_norm_fwd_shapes": len(seen["layer_norm_fwd"]),
            "layer_norm_widths": [list(w) for w in widths],
            "flash_attn_fwd_shapes": flash_shapes,
            "layer_norm_max_err": worst_ln, "flash_max_err": worst_fl}


def check_registered_ops(dev, gen, fused, flash_tpu, err):
    """18a: the registered ops the exported program calls, at the
    Predictor's shapes ([8 x 1024, 1024] LayerNorm rows, [8, 1024, 16, 64]
    attention as views of the fused QKV), against their plain versions."""
    rows, hidden = PREDICTOR_BATCH * 1024, 1024
    x = torch.randn(rows, hidden, device=dev, generator=gen).bfloat16()
    w, b = (torch.randn(hidden, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    y = torch.ops.paddle_tpu_torch.layer_norm_fwd(x, w, b, 1e-5)
    e_ln, ok_ln = worst(y, fused._ln_reference(x, w, b),
                        *LN_TOL[torch.bfloat16])
    rnd = lambda *shape, dtype: torch.randn(
        *shape, device=dev, generator=gen).to(dtype)
    q, k, v, _ = attn_operands(rnd, (PREDICTOR_BATCH, 1024, 16, 64),
                               torch.bfloat16, fused_qkv=True)
    out, lse = torch.ops.paddle_tpu_torch.flash_attn_fwd(q, k, v)
    ref_out, ref_lse = flash_tpu._flash_reference(q, k, v)
    e_o, ok_o = worst(out, ref_out, *FLASH_OUT_TOL[torch.bfloat16])
    e_l, ok_l = worst(lse, ref_lse, *FLASH_LSE_TOL[torch.bfloat16])
    torch.cuda.synchronize()
    err["layer_norm_fwd"] = max(err["layer_norm_fwd"], e_ln)
    err["flash_attn_fwd"] = max(err["flash_attn_fwd"], e_o, e_l)
    log(f"[18a] registered ops at the Predictor's shapes: "
        f"paddle_tpu_torch::layer_norm_fwd [{rows}, {hidden}] bf16 max err "
        f"{e_ln:.3g} (tol {LN_TOL[torch.bfloat16]}); "
        f"paddle_tpu_torch::flash_attn_fwd {list(q.shape)} bf16 as "
        f"fused-QKV views: out err {e_o:.3g}, lse err {e_l:.3g}")
    if not (ok_ln and ok_o and ok_l):
        raise AssertionError("18a: a registered op disagrees with its "
                             "plain version")


def predictor_phase(dev, gen, counted, launches, gpt_mod, fused, flash_tpu,
                    dense, err, smi):
    """18a: GPT-2 345M (bf16, phase 4's weights) through a Predictor from
    ``set_layer`` and through the ``.pdexport`` that ``jit.save`` wrote,
    loaded by ``create_predictor_from_path``: both give phase 4's logits
    (the layer the same bits, the artifact within its bf16 tolerance) and
    launch #1 24 and #5 49 times a forward; the p50 of a forward at
    [8, 1024] on each (CUDA events around single calls, so it counts the
    host's dispatch where that is slower than the card) and its device
    time (``torch.profiler``)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import (Config, create_predictor,
                                            create_predictor_from_path)

    check_registered_ops(dev, gen, fused, flash_tpu, err)
    cfg = gpt_mod.gpt2_medium()
    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=0).eval()
    spec = [jit.InputSpec([None, 1024], "int64", "ids")]
    config = Config()
    config.set_layer(model, spec)
    layer_pred = create_predictor(config)
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_export"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    jit.save(model, str(workdir / "gpt2_medium"), input_spec=spec)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art_pred = create_predictor_from_path(str(workdir / "gpt2_medium"))
    load_s = time.perf_counter() - t0
    artifact_bytes = (workdir / "gpt2_medium.pdexport").stat().st_size
    dense_ids, dense_logits = dense
    ids8 = torch.randint(0, cfg.vocab_size, (PREDICTOR_BATCH, 1024),
                         device=dev, generator=gen)
    out, n_layers = {}, cfg.num_layers
    for path, pred in (("layer", layer_pred), ("export", art_pred)):
        fn = pred.serving_fn()
        _cleared(counted)
        (logits,) = fn(dense_ids)
        torch.cuda.synchronize()
        got = _read_launches(counted, launches, f"predictor_{path}")
        e = float((logits.float().cpu() - dense_logits.float()).abs().max())
        time_ms(lambda: fn(ids8), iters=1, warmup=PREDICTOR_WARMUP)
        p50 = float(np.median([time_ms(lambda: fn(ids8), iters=1, warmup=0)
                               for _ in range(PREDICTOR_SAMPLES)]))
        dev_t = device_ms(lambda: fn(ids8), f"the {path} Predictor's "
                          "forward", iters=5)
        out[path] = {"logits_max_err": e,
                     "same_bits": torch.equal(logits.cpu(), dense_logits),
                     "launches": {k: v for k, v in got.items() if v},
                     "forward_p50_ms": p50, "forward_device_ms": dev_t}
        log(f"[18a] Predictor ({path}) GPT-2 345M bf16 [1, 1024]: logits "
            f"max err {e:.4g} against phase 4 (same bits "
            f"{out[path]['same_bits']}), launches {out[path]['launches']}; "
            f"forward [{PREDICTOR_BATCH}, 1024] p50 {p50:.2f} ms over "
            f"{PREDICTOR_SAMPLES} calls, device time {dev_t:.2f} ms ({smi})")
        if got["layer_norm_fwd"] != 2 * n_layers + 1 \
                or got["flash_attn_fwd"] != n_layers \
                or sum(got.values()) != 3 * n_layers + 1:
            raise AssertionError(f"18a: the {path} Predictor launched {got}"
                                 f", expected 49 LayerNorm and 24 attention "
                                 "forwards")
    if not out["layer"]["same_bits"]:
        raise AssertionError("18a: the layer Predictor's logits are not "
                             "phase 4's bits")
    if out["export"]["logits_max_err"] > LOGITS_BF16_ATOL:
        raise AssertionError("18a: the exported program's logits disagree "
                             "with phase 4's")
    out.update(kernel_ops=art_pred.kernel_ops, save_s=save_s, load_s=load_s,
               artifact_bytes=artifact_bytes)
    if art_pred.kernel_ops != {"layer_norm_fwd": 2 * n_layers + 1,
                               "flash_attn_fwd": n_layers}:
        raise AssertionError(f"18a: the exported graph holds "
                             f"{art_pred.kernel_ops}")
    log(f"[18a] jit.save with the export {save_s:.1f} s, "
        f"create_predictor_from_path {load_s:.1f} s, .pdexport "
        f"{artifact_bytes / 2**20:.1f} MiB, graph ops {art_pred.kernel_ops}")
    shutil.rmtree(workdir, ignore_errors=True)
    return out, model


def serving_benches_phase(counted, launches, bench_mod, smi):
    """18b and 18c's first part: ``bench serving`` and ``bench decode`` at
    ``bench_all``'s full size (each raises on a lost or shed request or a
    leaked block)."""
    out = {}
    for name, fn in (("serving", bench_mod.bench_serving),
                     ("decode", bench_mod.bench_decode)):
        _cleared(counted)
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        got = _read_launches(counted, launches, f"bench_{name}")
        out[name]["wall_s"] = time.perf_counter() - t0
        log(f"[18{'b' if name == 'serving' else 'c'}] bench {name} ({smi}): "
            f"{json.dumps(out[name])}; launches "
            f"{ {k: v for k, v in got.items() if v} }")
    return out


def decode_profile_phase(counted, launches, bench_mod, smi):
    """18c: ``bench decode``'s plain leg (its models, prompts and engine
    config from ``bench.decode_setup``) once more, one request a prompt,
    under ``torch.profiler``: the device busy share and the top kernels.
    Its greedy tokens must equal ``dense_greedy_reference``'s (phase 6's
    rule), which runs the one-shot leg's dense forward."""
    from paddle_tpu_torch.inference.serving import (TokenServingEngine,
                                                    dense_greedy_reference,
                                                    run_generation_streams)

    w = bench_mod.decode_setup()
    model, prompts, T = w["model"], w["prompts"], w["T"]
    _cleared(counted)
    prof = profile_serving(model, w["serve_cfg"](), prompts,
                           TokenServingEngine, run_generation_streams,
                           tag="18c", new_tokens=T)
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, "decode_profile")
    reqs = prof.pop("requests")
    served = [[int(t) for t in r.outputs[0]] if r.outputs else []
              for r in reqs]
    refs = [dense_greedy_reference(model, p, T) for p in prompts]
    same = sum(a == b for a, b in zip(served, refs))
    log(f"[18c] bench decode's plain leg under the profiler ({smi}): "
        f"{len(prompts)} prompts of {w['P']}, {T} new tokens each; "
        f"{same} of {len(prompts)} requests give dense_greedy_reference's "
        f"tokens; launches { {k: v for k, v in got.items() if v} }")
    if same != len(prompts) or any(r.status != "ok" for r in reqs):
        raise AssertionError("18c: bench decode's paged decode differs from "
                             "dense_greedy_reference")
    del w, model
    torch.cuda.empty_cache()
    return prof


def spec_phase(dev, counted, launches, gpt_mod, smi):
    """18c: GPT-2 345M in f32 (phase 6's weights) served with ``spec_k=3``
    and a random 1-layer draft: the tokens equal
    ``dense_greedy_reference``'s, no block of either pool leaks."""
    from paddle_tpu_torch.inference.serving import (TokenServeConfig,
                                                    TokenServingEngine,
                                                    dense_greedy_reference)
    from paddle_tpu_torch.profiler.telemetry import get_telemetry

    cfg = gpt_mod.gpt2_medium()
    model32 = gpt_mod.GPTForCausalLM(cfg, dtype=torch.float32, seed=1).eval()
    draft = gpt_mod.GPTForCausalLM(gpt_mod.GPTConfig(**SPEC_DRAFT),
                                   dtype=torch.float32, seed=2).eval()
    block = 16
    engine = TokenServingEngine(model32, TokenServeConfig(
        decode_buckets=(1, 2), prefill_chunk=128,
        max_new_tokens=SPEC_NEW_TOKENS, kv_blocks=2 * 1024 // block + 1,
        kv_block_size=block, kv_dtype="float32", spec_k=SPEC_K),
        draft_model=draft)
    rng = np.random.RandomState(18)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in SPEC_PROMPTS]
    engine.start()
    tel = get_telemetry()
    tel.reset()
    _cleared(counted)
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=SPEC_NEW_TOKENS)
            for p in prompts]
    for r in reqs:
        if not r.wait(600):
            raise AssertionError(f"18c: request {r.id} did not finish")
    wall = time.perf_counter() - t0
    acct = engine.shutdown()
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, "serving_spec")
    kv = engine.kv_accounting()
    refs = [dense_greedy_reference(model32, p, SPEC_NEW_TOKENS)
            for p in prompts]
    served = [[int(t) for t in r.outputs[0]] for r in reqs]
    rate = tel.snapshot()["gauges"].get("serve/spec_accept_rate", 0.0)
    out = {"accept_rate": rate, "tokens_per_s":
           sum(map(len, served)) / wall, "wall_s": wall,
           "spec_proposed": tel.counter_value("serve/spec_proposed"),
           "spec_accepted": tel.counter_value("serve/spec_accepted"),
           "launches": {k: v for k, v in got.items() if v}}
    log(f"[18c] GPT-2 345M f32, spec_k={SPEC_K}, draft {SPEC_DRAFT}: served "
        f"{served}, dense reference {refs}; accept rate {rate:.4f}, "
        f"{out['tokens_per_s']:.1f} tokens/s ({smi}); leaked blocks "
        f"{kv['leaked_blocks']} + draft {kv['draft']['leaked_blocks']}; "
        f"launches {out['launches']}")
    if served != refs or any(r.status != "ok" for r in reqs):
        raise AssertionError("18c: speculative serving differs from "
                             "dense_greedy_reference")
    if kv["leaked_blocks"] or kv["draft"]["leaked_blocks"] \
            or acct["unaccounted"] or acct["double_terminal"]:
        raise AssertionError(f"18c: accounting broken: {acct} {kv}")
    if not out["spec_proposed"]:
        raise AssertionError("18c: no speculative round ran")
    del engine, model32, draft
    torch.cuda.empty_cache()
    return out


def first_decode_logits(model, kv_dtype, prompt, dev):
    """The logits of one decode step after a one-chunk prefill of
    ``prompt`` into a ``kv_dtype`` pool, and the token fed to it (the
    prefill's greedy next token)."""
    from paddle_tpu_torch.inference.serving import KVCacheConfig, KVCachePool
    from paddle_tpu_torch.jit.functionalize import get_params
    from paddle_tpu_torch.text.models.gpt import gpt_decode_fns

    c = model.config
    n, block = len(prompt), 16
    pool = KVCachePool(KVCacheConfig(
        c.num_layers, c.num_heads, c.hidden_size // c.num_heads,
        num_blocks=n // block + 3, block_size=block, dtype=kv_dtype))
    pool.ensure(1, n + 1)
    width = n // block + 2
    table = torch.from_numpy(pool.block_table(1, width)[None]).to(dev)
    ints = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    fwd, params = gpt_decode_fns(c, kv_dtype), get_params(model)
    with torch.no_grad():
        logits, _ = fwd(params, ints([list(prompt)]), ints([list(range(n))]),
                        pool.pages, table, ints([n]))
        tok = int(logits[0, -1].argmax())
        logits, _ = fwd(params, ints([[tok]]), ints([[n]]), pool.pages,
                        table, ints([n + 1]))
    return logits[0, 0].float()


def int8_phase(dev, counted, launches, model, smi):
    """18d: GPT-2 345M (bf16) served from an int8 pool beside a bf16 pool:
    the pools' bytes (int8 at most ``INT8_POOL_SHARE`` of bf16), the share
    of greedy tokens that agree, and the first decode step's logit error
    within ``INT8_LOGIT_SPAN_SHARE`` of the bf16 logits' range."""
    from paddle_tpu_torch.inference.serving import (TokenServeConfig,
                                                    TokenServingEngine,
                                                    run_generation_streams)

    cfg = model.config
    rng = np.random.RandomState(81)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in INT8_PROMPTS]
    block = 16
    out, served = {}, {}
    for kv_dtype in ("bfloat16", "int8"):
        serve_cfg = TokenServeConfig(
            capacity=16, decode_buckets=(1, 2, 4), prefill_chunk=128,
            max_new_tokens=INT8_NEW_TOKENS,
            kv_blocks=len(prompts) * 1024 // block + 1, kv_block_size=block,
            kv_dtype=kv_dtype)
        engine = TokenServingEngine(model, serve_cfg)
        engine.start()
        _cleared(counted)
        res = run_generation_streams(
            engine, n_streams=len(prompts), requests_per_stream=1,
            prompt_fn=lambda i: prompts[i], max_new_tokens=INT8_NEW_TOKENS)
        acct = engine.shutdown()
        torch.cuda.synchronize()
        _read_launches(counted, launches, f"serving_{kv_dtype}")
        kv = engine.kv_accounting()
        served[kv_dtype] = [[int(t) for t in r.outputs[0]]
                            for r in res["requests"]]
        out[kv_dtype] = {"pool_bytes": engine._pool.nbytes(),
                         "tokens_per_s": res["tokens_per_s"],
                         "by_status": res["by_status"]}
        if kv["leaked_blocks"] or acct["unaccounted"] \
                or res["by_status"] != {"ok": len(prompts)}:
            raise AssertionError(f"18d: {kv_dtype} serving broken: {acct} "
                                 f"{kv} {res['by_status']}")
        del engine
        out[kv_dtype]["profile"] = profile_serving(
            model, serve_cfg, prompts, TokenServingEngine,
            run_generation_streams, tag=f"18d {kv_dtype}",
            new_tokens=INT8_NEW_TOKENS)
        del out[kv_dtype]["profile"]["requests"]
        torch.cuda.empty_cache()
    pairs = [(a, b) for x, y in zip(served["bfloat16"], served["int8"])
             for a, b in zip(x, y)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    share = out["int8"]["pool_bytes"] / out["bfloat16"]["pool_bytes"]
    ref = first_decode_logits(model, "bfloat16", prompts[1], dev)
    got = first_decode_logits(model, "int8", prompts[1], dev)
    e = float((got - ref).abs().max())
    span = float(ref.max() - ref.min())
    out.update(pool_share=share, token_agreement=agree,
               first_step_logit_err=e, bf16_logit_span=span)
    log(f"[18d] GPT-2 345M bf16 served from an int8 pool: pool "
        f"{out['int8']['pool_bytes'] / 2**20:.1f} MiB vs bf16 "
        f"{out['bfloat16']['pool_bytes'] / 2**20:.1f} MiB (share "
        f"{share:.4f}, at most {INT8_POOL_SHARE}); greedy tokens agreeing "
        f"{agree:.4f}; first decode step logits max err {e:.4g} against "
        f"the bf16 pool's (bound {INT8_LOGIT_SPAN_SHARE} x span {span:.4g} "
        f"= {INT8_LOGIT_SPAN_SHARE * span:.4g}); tokens/s int8 "
        f"{out['int8']['tokens_per_s']:.1f}, bf16 "
        f"{out['bfloat16']['tokens_per_s']:.1f} ({smi})")
    if share > INT8_POOL_SHARE:
        raise AssertionError(f"18d: the int8 pool is {share:.3f} of bf16's")
    if not e < INT8_LOGIT_SPAN_SHARE * span:
        raise AssertionError("18d: int8 pages move the logits too far")
    return out


# --- phase 19: the parameter surface -------------------------------------------
def gpt_lr_scales(cfg):
    """19a's per-tensor learning-rate scales and AdamW coefficients over
    ``gpt_param_shapes``: 0.5 on the LayerNorms, 0 on wpe, 1 elsewhere,
    each times an ``lr_ratio`` of 2 on the matrices; decay 0.01 on the
    matrices."""
    shapes = gpt_param_shapes(cfg)
    ln = {0, 1, 6, 7}  # a layer's ln1 and ln2 weights and biases
    scales, decay = [], []
    for i, shape in enumerate(shapes):
        layer = i - 2
        if i == 1:
            s = 0.0  # wpe
        elif i >= len(shapes) - 2 or (layer >= 0 and layer % 12 in ln):
            s = 0.5
        else:
            s = 1.0
        scales.append(s * (2.0 if len(shape) == 2 else 1.0))
        decay.append(0.01 if len(shape) == 2 else 0.0)
    return scales, decay


def fp16_adam_check(dev, gen, fused, numels, scales, decay, err, what):
    """19a: three steps of #7's fp16 instance (fp16 gradients and resident
    copies, f32 masters, the lr-scale column) against the plain version:
    a plain step, one with the global-norm clip (the plain update given
    the kernel's scale; the norm against the plain norm, NORM_RTOL) and
    one through the check pass (the same flags). Every tensor to
    ADAM_TOL, the copy exactly the master's fp16 rounding."""
    f32 = [torch.randn(n, device=dev, generator=gen) for n in numels]
    got = dict(
        P=[t.half() for t in f32],
        M=[torch.zeros(n, device=dev) for n in numels],
        V=[torch.zeros(n, device=dev) for n in numels],
        P1=[torch.ones((), device=dev) for _ in numels],
        P2=[torch.ones((), device=dev) for _ in numels], MS=f32)
    want = {k: [t.clone() for t in v] for k, v in got.items()}
    grads = [(torch.randn(n, device=dev, generator=gen) * 0.05).half()
             for n in numels]
    lr = torch.full((), TRAIN_LR, device=dev)
    opts = dict(decoupled_decay=decay, lr_scale=scales)
    keys = ("P", "M", "V", "P1", "P2")
    norm_rel = 0.0
    for step in range(3):
        args_k = [got[k] for k in keys[:1]] + [grads] + \
            [got[k] for k in keys[1:]] + [lr]
        args_p = [want[k] for k in keys[:1]] + [grads] + \
            [want[k] for k in keys[1:]] + [lr]
        if step == 1:
            norm = fused.fused_adam_step(*args_k, masters=got["MS"],
                                         clip_norm=OPTIONS_CLIP, **opts)
            ref = fused._global_norm_reference(grads, OPTIONS_CLIP)
            norm_rel = float(((norm - ref).abs() / ref.abs()).max())
            err["grad_sumsq"] = max(err["grad_sumsq"],
                                    float((norm - ref).abs()[0]))
            if not norm_rel <= NORM_RTOL:
                raise AssertionError(f"19a {what}: the fp16 sum-of-squares "
                                     f"pass is off by {norm_rel:.3g}")
            fused._adam_reference(*args_p, masters=want["MS"],
                                  grad_scale=norm[1], **opts)
        elif step == 2:
            ck, cp = fused.FiniteCheck(), fused.FiniteCheck()
            fused.fused_adam_step(*args_k, masters=got["MS"], check=ck,
                                  **opts)
            fused._fused_adam_reference(*args_p, masters=want["MS"],
                                        check=cp, **opts)
            if not torch.equal(ck.flags, cp.flags) or int(ck.ok) != 1:
                raise AssertionError(f"19a {what}: the fp16 check pass "
                                     "disagrees")
        else:
            fused.fused_adam_step(*args_k, masters=got["MS"], **opts)
            fused._adam_reference(*args_p, masters=want["MS"], **opts)
    torch.cuda.synchronize()
    errs = {}
    for key in ("P", "MS", "M", "V", "P1", "P2"):
        res = [worst(a, b, *ADAM_TOL) for a, b in zip(got[key], want[key])]
        errs[key] = max(e for e, _ in res)
        if not all(ok for _, ok in res):
            raise AssertionError(f"19a {what}: the fp16 adam kernel "
                                 f"disagrees on {key}")
    if not all(torch.equal(p, m.half()) for p, m in zip(got["P"],
                                                         got["MS"])):
        raise AssertionError(f"19a {what}: an fp16 copy is not its master's "
                             "fp16 rounding")
    err["adam"] = max(err["adam"], *errs.values())
    log(f"[19a] adam fp16 ({what}: {len(numels)} tensors, {sum(numels)} "
        f"params, scales {sorted(set(scales))}), 3 steps (plain, clipped, "
        "checked): max err " + ", ".join(f"{k} {e:.3g}" for k, e in
                                         errs.items())
        + f" (tol {ADAM_TOL}); clip norm rel err {norm_rel:.3g} (tol "
        f"{NORM_RTOL}); copies == fp16(master)")
    return got, grads, lr


def param_adam_phase(dev, cfg, fused, err):
    """19a: #7's fp16 instance and lr-scale column on GPT-2 345M's and
    ResNet-50's tensors; the timing at GPT-2 345M's."""
    from paddle_tpu_torch.vision.models import resnet50

    gen = torch.Generator(device=dev).manual_seed(19)
    numels = [int(np.prod(s)) for s in gpt_param_shapes(cfg)]
    scales, decay = gpt_lr_scales(cfg)
    got, grads, lr = fp16_adam_check(dev, gen, fused, numels, scales,
                                     decay, err, "GPT-2 345M")
    # wpe (scale 0) kept its master and copy: a zero step, decay included
    p_wpe, m_wpe = got["P"][1].clone(), got["MS"][1].clone()
    args = (got["P"], grads, got["M"], got["V"], got["P1"], got["P2"], lr)
    kern = lambda: fused.fused_adam_step(*args, masters=got["MS"],
                                         decoupled_decay=decay,
                                         lr_scale=scales)
    kern()
    torch.cuda.synchronize()
    if not (torch.equal(got["P"][1], p_wpe)
            and torch.equal(got["MS"][1], m_wpe)):
        raise AssertionError("19a: a tensor at scale 0 moved")
    kern_ms = time_ms(kern, iters=10)
    kern_dev = device_ms(kern, "fp16 adam over GPT-2 345M", iters=5,
                         per_call=2)
    plain = lambda: fused._adam_reference(*args, masters=got["MS"],
                                          decoupled_decay=decay,
                                          lr_scale=scales)
    plain_ms = time_ms(plain, iters=3, warmup=1)
    lib_p = [torch.nn.Parameter(m.clone()) for m in got["MS"]]
    for q in lib_p:
        q.grad = torch.randn(q.numel(), device=dev, generator=gen)
    del got, grads, args
    torch.cuda.empty_cache()
    opt = torch.optim.Adam(lib_p, lr=TRAIN_LR, fused=True)
    lib_ms = time_ms(opt.step, iters=10)
    lib_dev = device_ms(opt.step, "torch.optim.Adam(fused=True)", iters=5)
    del lib_p, opt
    torch.cuda.empty_cache()
    bound, by = adam_bound(numels, 2, 2)
    out = {"kernel": "adam_fp16", "shape": [len(numels), sum(numels)],
           "dtype": "float16 grads and copies, f32 masters, lr scales",
           "ms": kern_ms, "device_ms": kern_dev, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_device_ms": lib_dev,
           "bound_ms": bound, "bound_by": by}
    log(f"[19a] adam fp16 over GPT-2 345M's {len(numels)} tensors: kernel "
        f"{kern_ms:.3f} ms (device {kern_dev:.3f}, {bound / kern_dev:.3f} "
        f"of its bound {bound:.3f} ms, {by}), plain {plain_ms:.3f} ms, "
        f"torch.optim.Adam(fused=True) over the f32 masters {lib_ms:.3f} "
        f"ms (device {lib_dev:.3f})")
    shapes = [tuple(p.shape) for p in resnet50(num_classes=1000,
                                               device="cpu").parameters()]
    res = fp16_adam_check(dev, gen, fused,
                          [int(np.prod(s)) for s in shapes],
                          [1.0] * len(shapes), [0.0] * len(shapes), err,
                          "ResNet-50 O2")
    del res
    torch.cuda.empty_cache()
    return out


def o2_resnet_phase(dev, counted, launches):
    """19b: ResNet-50 at config #2's batch in pure fp16: decorate O2,
    Adam with f32 masters, GradScaler, through the eager loop and through
    TrainStep."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit.train_step import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import resnet50

    rng = np.random.RandomState(0)  # config #2's inputs
    x = torch.from_numpy(rng.randn(RESNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, (RESNET_BATCH, 1)).astype(
        np.int64)).to(dev)
    model = resnet50(num_classes=1000, device=dev)
    ce = CrossEntropyLoss()
    # the f32 loss of step 1 on the same weights and batch (train mode,
    # the running statistics put back)
    saved = [b.clone() for b in model.buffers()]
    with torch.no_grad():
        loss32 = float(ce(model(x), y))
    with torch.no_grad():
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)
    del saved
    amp.decorate(model, level="O2", dtype="float16")
    opt = Adam(1e-3, parameters=model.parameters(), multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=O2_INIT_LOSS_SCALE)
    skipped = []

    def eager(inputs, labels):
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = ce(model(*inputs), *labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped.append(scaler._found_inf)
        scaler.update()
        opt.clear_grad()
        return loss.detach()

    batch = ((x,), (y,))
    warm = [eager(*batch)]
    while len(warm) < O2_WARMUP_MAX and (len(warm) < 3 or all(skipped)):
        warm.append(eager(*batch))
    loss16 = float(warm[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    n_skip0 = sum(skipped)
    losses, step_ms, wall = timed_steps(eager, batch, RESNET_STEPS)
    launched = _read_launches(counted, launches, "param_resnet_o2")
    peak = torch.cuda.max_memory_allocated()
    stepped = RESNET_STEPS - (sum(skipped) - n_skip0)
    prof = profile_step("19b", eager, batch)
    rel = abs(loss16 - loss32) / abs(loss32)
    all_losses = [float(v) for v in torch.stack(warm + losses)]
    out = {"samples_per_s": RESNET_BATCH * RESNET_STEPS / wall,
           "step_ms_p50": step_ms[RESNET_STEPS // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "peak_memory_bytes": peak, "losses": all_losses,
           "loss_step1_fp16": loss16, "loss_step1_f32": loss32,
           "loss_step1_rel_err": rel, "skipped_steps": int(sum(skipped)),
           "skipped_in_warmup": int(n_skip0),
           "loss_scale": scaler._scale, "adam_launches": launched["adam"],
           "device_over_step_p50": prof["device_ms_per_step"]
           / step_ms[RESNET_STEPS // 2], **prof}
    log(f"[19b] ResNet-50 pure fp16 (O2, Adam f32 masters, GradScaler) at "
        f"{RESNET_BATCH} x 3 x {RESNET_SIZE}^2: {out['samples_per_s']:.1f} "
        f"samples/s over {RESNET_STEPS} steps, step p50 "
        f"{out['step_ms_p50']:.2f} ms, peak memory {peak / 2**30:.2f} GiB; "
        f"step 1 loss fp16 {loss16:.5f} vs f32 {loss32:.5f} (rel "
        f"{rel:.3g}, tol {O2_LOSS_RTOL}); skipped {sum(skipped)} of "
        f"{len(skipped)} steps ({n_skip0} in the warm-up), scale now "
        f"{scaler._scale:g}; adam launches {launched['adam']} for "
        f"{stepped} steps; losses {all_losses[0]:.4f} -> "
        f"{all_losses[-1]:.4f}")
    if rel > O2_LOSS_RTOL:
        raise AssertionError("19b: the fp16 step-1 loss is off the f32 one")
    if launched["adam"] != 2 * stepped or stepped == 0:
        raise AssertionError(f"19b: {launched['adam']} adam launches for "
                             f"{stepped} steps taken (2 a step)")
    if not all(np.isfinite(all_losses[n_skip0:])):
        raise AssertionError(f"19b: a loss after the scaler settled is not "
                             f"finite: {all_losses}")
    # TrainStep on the decorated model (no loss scale: the engine takes
    # none, as the reference's): the masters are the optimizer's
    train = TrainStep(model, ce, opt, device=dev)

    def engine(inputs, labels):
        with amp.auto_cast(level="O2", dtype="float16"):
            return train(inputs, labels)

    [engine(*batch) for _ in range(2)]
    _cleared(counted)
    t_losses, t_ms, t_wall = timed_steps(engine, batch, 4)
    t_launched = _read_launches(counted, launches, "param_trainstep_o2")
    t_losses = [float(v) for v in torch.stack(t_losses)]
    out["trainstep"] = {"samples_per_s": RESNET_BATCH * 4 / t_wall,
                        "step_ms_p50": t_ms[2], "losses": t_losses,
                        "adam_launches": t_launched["adam"]}
    log(f"[19b] TrainStep on the decorated model: "
        f"{out['trainstep']['samples_per_s']:.1f} samples/s, step p50 "
        f"{t_ms[2]:.2f} ms, losses {t_losses}, adam launches "
        f"{t_launched['adam']} for 4 steps")
    if t_launched["adam"] != 8 or not all(np.isfinite(t_losses)):
        raise AssertionError("19b: TrainStep's fp16 steps")
    if any(p.dtype != torch.float16 for p in model.parameters()):
        raise AssertionError("19b: a parameter left fp16")
    return out


def sparse_phase(dev, counted, launches):
    """19c: a row-sparse table at GPT-2 345M's wte width against the same
    model with a dense one, 3 steps of each optimizer setup."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, Adam

    vocab, h = SPARSE_VOCAB, SPARSE_DIM
    gen = torch.Generator(device=dev).manual_seed(193)
    w0 = torch.randn(vocab, h, device=dev, generator=gen) * 0.02
    head0 = torch.randn(h, 8, device=dev, generator=gen) * 0.05
    batches = [torch.randint(0, vocab // 8, TRAIN_SHAPE, device=dev,
                             generator=gen) for _ in range(SPARSE_STEPS)]
    for b in batches:
        b[:, ::97] = 0  # padding lookups

    def model(sparse):
        emb = tnn.Embedding(vocab, h, padding_idx=0, sparse=sparse,
                            device=dev)
        head = tnn.Linear(h, 8, device=dev)
        with torch.no_grad():
            emb.weight.copy_(w0)
            head.weight.copy_(head0)
        return emb, head

    setups = {
        "sgd": lambda ps: SGD(0.5, parameters=ps),
        "adam": lambda ps: Adam(1e-3, parameters=ps),
        "adam_lazy": lambda ps: Adam(1e-3, parameters=ps, lazy_mode=True),
        "adam_global_clip": lambda ps: Adam(
            1e-3, parameters=ps, grad_clip=ClipGradByGlobalNorm(0.1)),
    }
    out = {}
    for name, make in setups.items():
        res = {}
        for kind in ("dense", "sparse"):
            emb, head = model(kind == "sparse")
            opt = make([*emb.parameters(), *head.parameters()])
            times = []
            _cleared(counted)
            for ids in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = (head(emb(ids)) ** 2).mean()
                loss.backward()
                if emb.weight.grad.is_sparse != (kind == "sparse"):
                    raise AssertionError("19c: the table's gradient is not "
                                         f"{kind}")
                opt.step()
                opt.clear_grad()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launched = _read_launches(counted, launches,
                                      f"param_sparse_{name}_{kind}")
            res[kind] = (emb, head, opt, sorted(times), launched)
        (emb_d, head_d, opt_d, t_d, l_d), (emb_s, head_s, opt_s, t_s, l_s) = \
            res["dense"], res["sparse"]
        rows = torch.unique(torch.cat([b.reshape(-1) for b in batches]))
        rows = rows[rows != 0]
        entry = {"dense_ms_p50": t_d[1], "sparse_ms_p50": t_s[1],
                 "touched_rows": int(rows.numel()),
                 "adam_launches_dense": l_d["adam"],
                 "adam_launches_sparse": l_s["adam"],
                 "sumsq_launches_sparse": l_s["grad_sumsq"]}
        if name == "adam_lazy":
            w = emb_s.weight.detach()
            m1 = opt_s._accumulators[id(emb_s.weight)]["moment1"]
            untouched = torch.ones(vocab, dtype=torch.bool, device=dev)
            untouched[rows] = False
            untouched[0] = True
            keep_w = torch.equal(w[untouched], w0[untouched])
            keep_m = not bool(m1[untouched].any())
            entry.update(untouched_rows_kept=keep_w,
                         untouched_moments_zero=keep_m)
            if not (keep_w and keep_m) or torch.equal(w[rows], w0[rows]):
                raise AssertionError("19c: lazy Adam touched an untouched "
                                     "row (or no row moved)")
        else:
            e, ok = worst(emb_s.weight, emb_d.weight, *SPARSE_TOL)
            e2, ok2 = worst(head_s.weight, head_d.weight, *SPARSE_TOL)
            entry["max_err_table"], entry["max_err_head"] = e, e2
            if not (ok and ok2):
                raise AssertionError(f"19c {name}: the sparse update is off "
                                     f"the dense one ({e:.3g}, {e2:.3g}, "
                                     f"tol {SPARSE_TOL})")
        if not torch.equal(emb_s.weight.detach()[0], w0[0]):
            raise AssertionError(f"19c {name}: the padding row moved")
        if name.startswith("adam") and (l_d["adam"] != 2 * SPARSE_STEPS
                                        or l_s["adam"] != 2 * SPARSE_STEPS):
            raise AssertionError(f"19c {name}: the dense parameters did not "
                                 "go through #7 once a step")
        log(f"[19c] {name} Embedding({vocab}, {h}, padding_idx=0) + head, "
            f"{TRAIN_SHAPE} ids, {SPARSE_STEPS} steps: ms a step p50 dense "
            f"{t_d[1]:.2f}, sparse {t_s[1]:.2f}; "
            + ", ".join(f"{k} {v}" if not isinstance(v, float)
                        else f"{k} {v:.3g}" for k, v in entry.items()
                        if not k.endswith("ms_p50")))
        out[name] = entry
        del res, emb_d, emb_s, head_d, head_s, opt_d, opt_s
        torch.cuda.empty_cache()
    return out


def param_lr_phase(dev, gen, counted, launches, gpt_mod, norm_mod, plain):
    """19d: one eager Adam step of GPT-2 345M (bf16, f32 masters) with
    learning-rate scales (0.5 on the LayerNorms, 0 on wpe) through #7 and
    through the plain update from the same state."""
    from paddle_tpu_torch.optimizer import Adam

    cfg = gpt_mod.gpt2_medium()
    model = gpt_mod.GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                   seed=0)
    for mod in model.modules():
        if isinstance(mod, norm_mod.LayerNorm):
            for p in mod.parameters():
                p.optimize_attr = {"learning_rate": 0.5}
    wpe = model.gpt.wpe.weight
    wpe.optimize_attr = {"learning_rate": 0.0}
    opt = Adam(TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), device=dev,
                        generator=gen)
    logits = model(ids)
    loss = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, cfg.vocab_size), ids.reshape(-1))
    loss.backward()
    params = list(model.parameters())
    for p in params:
        opt.state_for(p)
    snap = ([p.detach().clone() for p in params],
            [{k: v.clone() for k, v in opt.state_for(p).items()}
             for p in params])
    _cleared(counted)
    opt.step()
    torch.cuda.synchronize()
    launched = _read_launches(counted, launches, "param_lr")
    got = ([p.detach().clone() for p in params],
           [{k: v.clone() for k, v in opt.state_for(p).items()}
            for p in params])
    with torch.no_grad():
        for p, v, st in zip(params, *snap):
            p.copy_(v)
            for k, t in opt.state_for(p).items():
                t.copy_(st[k])
    with plain():
        opt.step()
    torch.cuda.synchronize()
    worst_err = 0.0
    for p, v, st in zip(params, *got):
        e, ok = worst(v, p.detach(), *ADAM_TOL)
        worst_err = max(worst_err, e)
        for k, t in opt.state_for(p).items():
            e, ok2 = worst(st[k], t, *ADAM_TOL)
            worst_err = max(worst_err, e)
            ok = ok and ok2
        if not ok:
            raise AssertionError("19d: the kernel's scaled step is off the "
                                 "plain one")
    i_wpe = next(i for i, p in enumerate(params) if p is wpe)
    kept = (torch.equal(got[0][i_wpe], snap[0][i_wpe])
            and torch.equal(got[1][i_wpe]["master"],
                            snap[1][i_wpe]["master"]))
    ln_moved = [not torch.equal(g, s) for g, s, p in zip(
        got[0], snap[0], params) if getattr(p, "optimize_attr", {}).get(
        "learning_rate") == 0.5]
    log(f"[19d] GPT-2 345M eager Adam step, lr scales 0.5 on "
        f"{len(ln_moved)} LayerNorm tensors and 0 on wpe: kernel vs plain "
        f"max err {worst_err:.3g} (tol {ADAM_TOL}); wpe and its master "
        f"kept their bits {kept}; adam launches {launched['adam']}")
    if not kept or launched["adam"] != 2 or not any(ln_moved):
        raise AssertionError("19d: scale 0 moved wpe, or #7 was not the "
                             "step")
    del model, opt, snap, got, logits
    torch.cuda.empty_cache()
    return {"max_abs_err": worst_err, "wpe_kept": kept,
            "adam_launches": launched["adam"]}


# --- phase 20: the rest of nn/ -----------------------------------------------
# 20a: Transformer-base, Vaswani et al. (2017), Table 3 "base" (nn.Transformer's
# defaults: N = 6 + 6, d_model 512, 8 heads, d_ff 2048, dropout 0.1,
# post-norm), one 37,000-token BPE vocabulary shared by source and target
# (§5.1) with the embedding scaled by √512 and tied to the output projection,
# sinusoidal positions, label smoothing 0.1, Adam(0.9, 0.98, 1e-9) under
# NoamDecay(512, 4000); 32 sentence pairs of 128 tokens a side (4,096
# tokens each side: about one card's share of the paper's 25,000-token
# batches over 8 GPUs), source lengths drawn in 64-128 and masked
NMT_VOCAB, NMT_D, NMT_FF, NMT_LAYERS = 37000, 512, 2048, 6
NMT_BATCH, NMT_LEN, NMT_MIN_SRC = 32, 128, 64
NMT_LABEL_SMOOTHING, NMT_DROPOUT = 0.1, 0.1
NMT_WARMUP, NMT_TIMED = 3, 5
# the LayerNorms of one step: 2 per encoder layer, 3 per decoder layer
NMT_LN_PER_STEP = 2 * NMT_LAYERS + 3 * NMT_LAYERS
# 20a's parity leg, f32 with TF32 off and dropout 0: the card's step against
# the CPU's plain step from the same weights and batch. Both sum f32
# products in other orders through 12 layers: the loss to 1e-5 relative,
# the global gradient norm to 1e-4 relative, and each weight after the
# update within 2 lr of the CPU's (Noam's step-1 rate is 1.75e-7; an
# element whose gradient is within f32 noise of 0 may step the other way).
# That bound cannot see #7 (Adam's step 1 moves each element by about lr),
# so #7 is held on its own: the plain version, run on the card from copies
# of the kernel's inputs (the card's gradients, zero moments), must give
# the kernel's bits in every parameter, moment and beta power
NMT_LOSS_RTOL = 1e-5
NMT_GNORM_RTOL = 1e-4
# 20b: beam search over 8 of the batch's source sentences, beam 4, start
# token 0, end token 1, at most 64 steps, f32 in eval mode. The incremental
# logits within 1e-4 of the step's largest |logit| of the full causal
# forward's (f32 products of other shapes); each beam's score within
# 1e-5·|score| + 1e-3 of the full forward's sum of log-probabilities; the
# greedy decode may leave beam size 1's tokens only where the full
# forward's two candidates are within that logit tolerance (a near tie)
NMT_BEAM_SOURCES, NMT_BEAM, NMT_MAX_STEPS = 8, 4, 64
NMT_START, NMT_END = 0, 1
NMT_INCR_REL_TOL = 1e-4
NMT_SCORE_RTOL, NMT_SCORE_ATOL = 1e-5, 1e-3
# 20c: Zaremba et al. (2014), "medium": an LSTM language model of 2 layers
# of 650 units unrolled 35 steps at batch 20 over PTB's 10,000 words,
# dropout 0.5, SGD at lr 1.0 with the gradients' global norm clipped to 5;
# a GRU at the same shape. Step 1 at dropout 0 against the CPU's: the loss
# to 1e-5 relative, the global gradient norm to 1e-4 relative, and each
# parameter after the clipped update within 1e-3 of its tensor's largest
# |update| on the CPU beyond one f32 ulp of its value (each side rounds
# p - u once; a skipped or wrongly scaled update is off by a whole
# update); the clip's norm and scale from the sum-of-squares kernel
# against its plain version on the card step's own gradients, NORM_RTOL
RNN_UPDATE_RTOL = 1e-3
RNN_VOCAB, RNN_HIDDEN, RNN_LAYERS = 10000, 650, 2
RNN_STEPS, RNN_BATCH, RNN_DROPOUT = 35, 20, 0.5
RNN_LR, RNN_CLIP, RNN_TRAIN_STEPS = 1.0, 5.0, 3
# 20d: each function and layer of the slice on the card against the same
# call on CPU tensors, the tolerances of its CPU test: f32 values to
# 1e-5 (+1e-5), gradients to 1e-4 (+1e-4); an infeasible CTC sequence's
# gradient to 2e-3 (its paths sit near -1e5, where an f32 ulp is 0.0078)
BREADTH_TOL, BREADTH_GRAD_TOL = (1e-5, 1e-5), (1e-4, 1e-4)
CTC_INFEASIBLE_GRAD_ATOL = 2e-3


@contextlib.contextmanager
def calls_kept(module, name, kept):
    """While inside, record every call of ``module.name`` in ``kept``: the
    arguments as passed (tensors the call updates in place stay live),
    copies of them taken before the call, the keywords and the result. A
    wrapper that counts its launches under its module name counts them on
    the stand-in; they are carried over to the wrapper's own count."""
    fn = getattr(module, name)

    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        if isinstance(a, (list, tuple)):
            return type(a)(copy(x) for x in a)
        return a

    def keeping(*args, **kw):
        before = copy(args)
        keeping.launches = start = getattr(fn, "launches", 0)
        out = fn(*args, **kw)
        if hasattr(fn, "launches"):
            fn.launches += keeping.launches - start
        kept.append((args, before, kw, out))
        return out

    setattr(module, name, keeping)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def sinusoid_table(n, d):
    """Vaswani et al.'s positional encodings [n, d] (numpy, f32)."""
    pos = np.arange(n)[:, None] / np.power(10000.0, np.arange(0, d, 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2], table[:, 1::2] = np.sin(pos), np.cos(pos)
    return torch.from_numpy(table)


class NMTModel(torch.nn.Module):
    """Transformer-base as the paper trains it: ``nn.Transformer`` between
    a shared embedding (scaled by √d, plus sinusoidal positions, then
    dropout) and an output projection tied to it (through ``linear``, so
    that AMP casts it)."""

    def __init__(self, tnn, dev, dropout, generator=None):
        super().__init__()
        self.transformer = tnn.Transformer(
            d_model=NMT_D, num_encoder_layers=NMT_LAYERS,
            num_decoder_layers=NMT_LAYERS, dim_feedforward=NMT_FF,
            dropout=dropout, device=dev, generator=generator)
        self.embedding = tnn.Embedding(NMT_VOCAB, NMT_D, device=dev)
        self.drop = tnn.Dropout(dropout, generator=generator)
        self.register_buffer("pos", sinusoid_table(NMT_LEN, NMT_D).to(dev),
                             persistent=False)
        self.register_buffer(
            "causal", self.transformer.generate_square_subsequent_mask(
                NMT_LEN), persistent=False)

    def embed(self, ids, start=0):
        x = self.embedding(ids) * math.sqrt(NMT_D)
        return self.drop(x + self.pos[start:start + ids.shape[1]])

    def head(self, out):
        from paddle_tpu_torch.nn.functional import linear

        return linear(out, self.embedding.weight.t())

    def forward(self, src, tgt, src_keep):
        out = self.transformer(self.embed(src), self.embed(tgt), src_keep,
                               self.causal[:tgt.shape[1], :tgt.shape[1]],
                               src_keep)
        return self.head(out)

    def decode_logits(self, memory, memory_keep, tokens):
        """The full causal forward of the decoder over ``tokens``."""
        n = tokens.shape[1]
        out = self.transformer.decoder(self.embed(tokens), memory,
                                       self.causal[:n, :n], memory_keep)
        return self.head(out)


def nmt_batch(gen, dev):
    """Source and target ids (the special tokens 0 and 1 left out), the
    source lengths in [64, 128] as a [B, 1, 1, S] keep-mask, the decoder's
    input (start token, then the target shifted) and its labels."""
    src = torch.randint(2, NMT_VOCAB, (NMT_BATCH, NMT_LEN), device=dev,
                        generator=gen)
    tgt = torch.randint(2, NMT_VOCAB, (NMT_BATCH, NMT_LEN), device=dev,
                        generator=gen)
    lengths = torch.randint(NMT_MIN_SRC, NMT_LEN + 1, (NMT_BATCH,),
                            device=dev, generator=gen)
    keep = (torch.arange(NMT_LEN, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    tgt_in = torch.cat([torch.full_like(tgt[:, :1], NMT_START),
                        tgt[:, :-1]], 1)
    return src, tgt_in, keep, tgt


def nmt_loss(logits, labels):
    from paddle_tpu_torch.nn.functional import cross_entropy

    return cross_entropy(logits.reshape(-1, NMT_VOCAB), labels.reshape(-1),
                         label_smoothing=NMT_LABEL_SMOOTHING)


def nmt_flops_per_step():
    """Training FLOPs of one step (2 per multiply-add forward, twice that
    backward), attention over the padded lengths as it is computed."""
    d, ff, nl, b, s = NMT_D, NMT_FF, NMT_LAYERS, NMT_BATCH, NMT_LEN
    tok = b * s
    layer = tok * (4 * d * d + 2 * d * ff) + 2 * b * s * s * d
    cross = tok * 4 * d * d + 2 * b * s * s * d
    macs = nl * layer + nl * (layer + cross) + tok * d * NMT_VOCAB
    return 3 * 2 * macs


def nmt_engine(tnn, dev, dropout, seed_state, lr_mod, Adam,
               ParallelTrainStep, generator=None):
    """A model from ``seed_state`` (a CPU state dict), Adam under Noam and
    the engine over them."""
    model = NMTModel(tnn, dev, dropout, generator)
    model.load_state_dict(seed_state)
    sched = lr_mod.NoamDecay(d_model=NMT_D, warmup_steps=4000)
    opt = Adam(sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
               parameters=model.parameters())
    return model, opt, sched, ParallelTrainStep(model, nmt_loss, opt,
                                                device=dev)


def nmt_parity(dev, tnn, fused, batch, seed_state, lr_mod, Adam,
               ParallelTrainStep, counted, launches):
    """20a's parity leg: one f32 step (dropout 0) on the card and on the
    CPU's plain path from the same weights and batch."""
    def one_step(device, inputs, adam_calls):
        model, opt, sched, step = nmt_engine(
            tnn, device, 0.0, seed_state, lr_mod, Adam, ParallelTrainStep)
        grads = {}
        update = opt.step

        def keep_grads_then_update():
            grads.update({n: p.grad.detach().clone()
                          for n, p in model.named_parameters()})
            update()

        opt.step = keep_grads_then_update
        before = {n: p.detach().clone() for n, p in
                  model.named_parameters()}
        with (calls_kept(fused, "fused_adam_step", adam_calls)
              if adam_calls is not None else contextlib.nullcontext()):
            loss = float(step(inputs[:3], inputs[3:]))
        gnorm = float(torch.sqrt(sum(g.double().square().sum()
                                     for g in grads.values())))
        delta = {n: (p.detach() - before[n]).cpu()
                 for n, p in model.named_parameters()}
        return loss, gnorm, delta, sched()

    _cleared(counted)
    adam_calls = []
    loss_k, gnorm_k, delta_k, lr1 = one_step(dev, batch, adam_calls)
    torch.cuda.synchronize()
    got = _read_launches(counted, launches, "nmt_parity")
    # #7 against its plain version on the card, from copies of its inputs
    (live, copies, kw, _), = adam_calls
    if kw.get("clip_norm") is not None or kw.get("check") is not None:
        raise AssertionError("20a: the step's Adam took a clip or a check")
    fused._adam_reference(*copies, **{k: v for k, v in kw.items()
                                      if k not in ("clip_norm", "check")})
    slots = {"params": 0, "moment1": 2, "moment2": 3, "beta1_pow": 4,
             "beta2_pow": 5}
    adam_same = {k: all(torch.equal(a, b) for a, b in
                        zip(live[i], copies[i])) for k, i in slots.items()}
    adam_err = max(float((a - b).abs().max())
                   for a, b in zip(live[0], copies[0]))
    del live, copies, adam_calls
    loss_p, gnorm_p, delta_p, _ = one_step(
        torch.device("cpu"), tuple(t.cpu() for t in batch), None)
    last, mid = NMT_LAYERS - 1, NMT_LAYERS // 2
    kinds = ("embedding.weight",
             "transformer.encoder.layers.0.self_attn.q_proj.weight",
             f"transformer.decoder.layers.{last}.cross_attn.v_proj.bias",
             f"transformer.decoder.layers.{mid}.linear1.weight",
             f"transformer.encoder.layers.{mid}.norm2.weight",
             "transformer.decoder.layers.0.norm3.bias")
    w_err = max(float((delta_k[n] - delta_p[n]).abs().max()) for n in kinds)
    l_err = abs(loss_k - loss_p) / abs(loss_p)
    g_err = abs(gnorm_k - gnorm_p) / gnorm_p
    log(f"[20a] Transformer-base f32 step 1 (dropout 0, TF32 off) at "
        f"{NMT_BATCH} x {NMT_LEN} a side: loss {loss_k:.7f} (card) vs "
        f"{loss_p:.7f} (CPU), rel err {l_err:.3g} (tol {NMT_LOSS_RTOL}); "
        f"grad norm {gnorm_k:.6f} vs {gnorm_p:.6f}, rel err {g_err:.3g} "
        f"(tol {NMT_GNORM_RTOL}); update of {len(kinds)} weights (one of "
        f"each kind) max err {w_err:.3g} (tol 2 lr = {2 * lr1:.3g}); #7 "
        f"over the {len(delta_k)} tensors against its plain version on the "
        f"card, same bits: {adam_same} (params max diff {adam_err:.3g}, "
        f"{adam_err / lr1:.3g} lr); launches #5 {got['layer_norm_fwd']} #6 "
        f"{got['layer_norm_bwd']} #7 {got['adam']}")
    if (got["layer_norm_fwd"], got["layer_norm_bwd"], got["adam"]) != (
            NMT_LN_PER_STEP, 2 * NMT_LN_PER_STEP, 2):
        raise AssertionError(f"20a parity step launched {got}")
    if not all(adam_same.values()):
        raise AssertionError(f"20a: #7 at Transformer-base's tensors is off "
                             f"its plain version: {adam_same}")
    if not (l_err <= NMT_LOSS_RTOL and g_err <= NMT_GNORM_RTOL
            and w_err <= 2 * lr1):
        raise AssertionError("20a: the card's Transformer step is off the "
                             "CPU's")
    torch.cuda.empty_cache()
    return {"loss_card": loss_k, "loss_cpu": loss_p, "loss_rel_err": l_err,
            "grad_norm_rel_err": g_err, "update_max_err": w_err,
            "lr_step1": lr1, "adam_same_bits_as_plain": adam_same,
            "adam_params_max_diff": adam_err}


@contextlib.contextmanager
def plain_layer_norm_counted(fused):
    """Count every call of the LayerNorm's plain versions while inside."""
    calls = [0]
    saved = fused._ln_reference, fused._ln_bwd_reference

    def counted(fn):
        def wrapped(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapped

    fused._ln_reference = counted(saved[0])
    fused._ln_bwd_reference = counted(saved[1])
    try:
        yield calls
    finally:
        fused._ln_reference, fused._ln_bwd_reference = saved


def nmt_timed_leg(dev, tnn, fused, amp, batch, seed_state, lr_mod, Adam,
                  ParallelTrainStep, counted, launches, bf16, smi):
    """20a's timed legs: dropout 0.1 from a generator, 3 warm-up and 10
    timed steps (f32, or bf16 O1 under ``amp.auto_cast``), launches a
    step, no LayerNorm on its plain path, and a 2-step profile."""
    from paddle_tpu_torch.profiler.xla_cost import chip_peaks

    phase = "nmt_bf16" if bf16 else "nmt_f32"
    gen = torch.Generator(device=dev).manual_seed(20)
    model, opt, sched, engine = nmt_engine(
        tnn, dev, NMT_DROPOUT, seed_state, lr_mod, Adam, ParallelTrainStep,
        gen)
    ln_calls = [0]
    for mod in model.modules():
        if isinstance(mod, tnn.LayerNorm):
            mod.register_forward_hook(
                lambda *_: ln_calls.__setitem__(0, ln_calls[0] + 1))

    def step(inputs, labels):
        ctx = (amp.auto_cast(dtype="bfloat16") if bf16
               else contextlib.nullcontext())
        with ctx:
            loss = engine(inputs, labels)
        sched.step()
        return loss

    data = (batch[:3], batch[3:])
    for _ in range(NMT_WARMUP):
        step(*data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_calls[0] = 0
    _cleared(counted)
    with plain_layer_norm_counted(fused) as plain_calls:
        losses, times, wall = timed_steps(step, data, NMT_TIMED)
    got = _read_launches(counted, launches, phase)
    ln_per_step = ln_calls[0] / NMT_TIMED
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(f"20a {'bf16' if bf16 else 'f32'}", step, data)
    per_step = {k: got[k] / NMT_TIMED for k in
                ("layer_norm_fwd", "layer_norm_bwd", "adam")}
    losses = [float(x) for x in losses]
    p50 = times[len(times) // 2]
    flops = nmt_flops_per_step()
    peaks = chip_peaks(dev)
    out = {
        "dtype": "bf16 O1" if bf16 else "f32 (TF32 off)",
        "tokens_per_s": 2 * NMT_BATCH * NMT_LEN * NMT_TIMED / wall,
        "target_tokens_per_s": NMT_BATCH * NMT_LEN * NMT_TIMED / wall,
        "step_p50_ms": p50, "device_ms_per_step":
            prof["device_ms_per_step"], "busy_share": prof["busy_share"],
        "peak_memory_gb": peak / 1e9,
        "flops_per_step": flops,
        "mfu_pct": 100.0 * flops / (p50 / 1e3) / peaks["flops"],
        "launches_per_step": per_step, "layer_norm_calls_per_step":
            ln_per_step, "plain_layer_norm_calls":
            plain_calls[0], "losses": losses, "top": prof["top"][:8],
        "device_ms_by_kind": prof["device_ms_by_kind"], "card": smi}
    if not bf16:
        out["mfu_f32_peak_pct"] = (100.0 * flops / (p50 / 1e3)
                                   / PEAK_FLOPS[torch.float32])
    log(f"[20a] {out['dtype']}: {out['tokens_per_s']:.1f} tokens/s (source "
        f"+ target, {out['target_tokens_per_s']:.1f} target), step p50 "
        f"{p50:.2f} ms, device {out['device_ms_per_step']:.2f} ms a step, "
        f"busy share {out['busy_share']:.4f}, peak {out['peak_memory_gb']:.2f}"
        f" GB, MFU {out['mfu_pct']:.2f}% of {peaks['flops'] / 1e12:.0f} "
        f"TFLOP/s ({flops / 1e12:.3f} TFLOP a step); launches a step #5 "
        f"{per_step['layer_norm_fwd']:g} #6 {per_step['layer_norm_bwd']:g} "
        f"#7 {per_step['adam']:g}; LayerNorm calls a step "
        f"{out['layer_norm_calls_per_step']:g}, on the plain path "
        f"{plain_calls[0]}; losses {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({smi})")
    want = {"layer_norm_fwd": NMT_LN_PER_STEP,
            "layer_norm_bwd": 2 * NMT_LN_PER_STEP, "adam": 2}
    if per_step != want or plain_calls[0] or ln_per_step != NMT_LN_PER_STEP:
        raise AssertionError(f"20a {phase}: launches a step {per_step} "
                             f"(want {want}), plain LayerNorm calls "
                             f"{plain_calls[0]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"20a {phase}: a loss is not finite: {losses}")
    del engine, opt
    model.eval()
    return model, out


class NMTBeamCell:
    """The beam-search cell over a trained ``NMTModel``: ids of the beams'
    last tokens in, logits out; the state holds the decoder's caches
    (``TransformerDecoder.gen_cache``: a ``Cache`` per self-attention, a
    ``StaticCache`` per cross-attention) and the tokens so far. With
    ``check`` it also runs the full causal forward over those tokens and
    appends how far the incremental logits are from it (relative to the
    step's largest |logit|, a device scalar)."""

    def __init__(self, model, check=None):
        self.model, self.check = model, check

    def __call__(self, ids, states, memory=None, memory_keep=None):
        model, seen = self.model, states["tokens"]
        x = model.embed(ids[:, None], start=seen.shape[1])
        out, caches = model.transformer.decoder(x, memory, None,
                                                memory_keep,
                                                states["caches"])
        logits = model.head(out)[:, 0]
        tokens = torch.cat([seen, ids[:, None]], 1)
        if self.check is not None:
            full = model.decode_logits(memory, memory_keep, tokens)[:, -1]
            self.check.append((full - logits).abs().max()
                              / full.abs().max())
        return logits, {"caches": caches, "tokens": tokens}


def nmt_beam_search(tnn, model, src, keep, beam, check=None):
    """``dynamic_decode`` of ``BeamSearchDecoder`` over ``NMTBeamCell``:
    (ids [B, beam, T], final states, lengths)."""
    memory = model.transformer.encoder(model.embed(src), keep)
    tile = tnn.BeamSearchDecoder.tile_beam_merge_with_batch
    init = {"caches": model.transformer.decoder.gen_cache(memory),
            "tokens": src.new_zeros(src.shape[0], 0)}
    decoder = tnn.BeamSearchDecoder(NMTBeamCell(model, check), NMT_START,
                                    NMT_END, beam)
    return tnn.dynamic_decode(decoder, inits=init,
                              max_step_num=NMT_MAX_STEPS, return_length=True,
                              memory=tile(memory, beam),
                              memory_keep=tile(keep, beam))


def nmt_beam_phase(dev, tnn, model, batch, counted, launches, smi):
    """20b: beam search over the trained f32 model, with its checks."""
    src = batch[0][:NMT_BEAM_SOURCES]
    keep = batch[2][:NMT_BEAM_SOURCES]
    with torch.no_grad():
        check = []
        ids_c, _, _ = nmt_beam_search(tnn, model, src, keep, NMT_BEAM,
                                      check)
        incr_err = float(torch.stack(check).max())
        torch.cuda.synchronize()
        _cleared(counted)
        t0 = time.perf_counter()
        ids, states, lengths = nmt_beam_search(tnn, model, src, keep,
                                               NMT_BEAM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_launches(counted, launches, "nmt_beam")
        steps = ids.shape[2]
        # each beam's score against the full forward's log-probabilities
        memory = model.transformer.encoder(model.embed(src), keep)
        tile = tnn.BeamSearchDecoder.tile_beam_merge_with_batch
        flat = ids.reshape(-1, steps)
        inputs = torch.cat([torch.full_like(flat[:, :1], NMT_START),
                            flat[:, :-1]], 1)
        logp = torch.log_softmax(model.decode_logits(
            tile(memory, NMT_BEAM), tile(keep, NMT_BEAM), inputs).float(),
            -1).gather(-1, flat[..., None])[..., 0]
        ended = (flat == NMT_END).long().cumsum(1)
        upto = (ended == 0) | ((ended == 1) & (flat == NMT_END))
        recomputed = (logp * upto).sum(1).reshape(ids.shape[:2])
        scores = states.log_probs
        score_err = float(((scores - recomputed).abs()
                           - NMT_SCORE_RTOL * recomputed.abs()).max())
        ordered = bool((scores[:, :-1] >= scores[:, 1:]).all())
        # beam size 1 against the full forward's greedy argmax
        ids1, _, _ = nmt_beam_search(tnn, model, src, keep, 1)
        seq = torch.full((src.shape[0], 1), NMT_START, device=dev)
        for _ in range(ids1.shape[2]):
            nxt = model.decode_logits(memory, keep, seq)[:, -1]
            seq = torch.cat([seq, nxt.argmax(-1, keepdim=True)], 1)
        greedy, near_ties = seq[:, 1:], 0
        for b in range(src.shape[0]):
            ends = (ids1[b, 0] == NMT_END).nonzero()
            upto = int(ends[0]) + 1 if len(ends) else ids1.shape[2]
            diff = (ids1[b, 0, :upto] != greedy[b, :upto]).nonzero()
            if len(diff) == 0:
                continue
            t = int(diff[0])
            prefix = torch.cat([seq[b:b + 1, :1], ids1[b:b + 1, 0, :t]], 1)
            row = model.decode_logits(memory[b:b + 1], keep[b:b + 1],
                                      prefix)[0, -1]
            gap = float(row.max() - row[ids1[b, 0, t]])
            if gap > NMT_INCR_REL_TOL * float(row.abs().max()):
                raise AssertionError(
                    f"20b: beam size 1 left the greedy decode of source {b} "
                    f"at step {t} by a logit gap of {gap:.4g}")
            near_ties += 1
    out = {"steps": steps, "tokens_per_s": src.shape[0] * steps / wall,
           "beam_tokens_per_s": src.shape[0] * NMT_BEAM * steps / wall,
           "decode_s": wall, "incremental_rel_err": incr_err,
           "score_err": score_err, "sorted": ordered,
           "same_ids_with_checks": bool(torch.equal(ids, ids_c)),
           "greedy_near_ties": near_ties,
           "finished": int(states.finished.sum()),
           "layer_norm_launches": got["layer_norm_fwd"], "card": smi}
    log(f"[20b] beam search, {src.shape[0]} sources x beam {NMT_BEAM}, "
        f"{steps} steps in {wall:.3f} s: {out['tokens_per_s']:.1f} tokens/s "
        f"({out['beam_tokens_per_s']:.1f} beam tokens/s), #5 launches "
        f"{got['layer_norm_fwd']}; incremental vs full logits "
        f"{incr_err:.3g} of max|logit| (tol {NMT_INCR_REL_TOL}); beam "
        f"score - recomputed log-prob beyond {NMT_SCORE_RTOL}|score| "
        f"{score_err:.3g} (tol {NMT_SCORE_ATOL}); sorted {ordered}; beam 1 "
        f"= greedy ({near_ties} near ties); {out['finished']} beams ended "
        f"({smi})")
    if got["layer_norm_fwd"] != 2 * NMT_LAYERS + 3 * NMT_LAYERS * steps:
        raise AssertionError(f"20b launched {got}")
    if not (incr_err <= NMT_INCR_REL_TOL and score_err <= NMT_SCORE_ATOL
            and ordered and out["same_ids_with_checks"]):
        raise AssertionError("20b: the beam search is off its full forward")
    return out


class RNNLM(torch.nn.Module):
    """Zaremba et al.'s language model: embedding, dropout, a 2-layer
    recurrent network (dropout between its layers), dropout, a linear
    head over the vocabulary."""

    def __init__(self, tnn, cls, dev, dropout, generator=None):
        super().__init__()
        self.embedding = tnn.Embedding(RNN_VOCAB, RNN_HIDDEN, device=dev)
        self.drop_in = tnn.Dropout(dropout, generator=generator)
        self.rnn = getattr(tnn, cls)(RNN_HIDDEN, RNN_HIDDEN, RNN_LAYERS,
                                     dropout=dropout, device=dev,
                                     generator=generator)
        self.drop_out = tnn.Dropout(dropout, generator=generator)
        self.decoder = tnn.Linear(RNN_HIDDEN, RNN_VOCAB, device=dev)

    def forward(self, ids):
        y, _ = self.rnn(self.drop_in(self.embedding(ids)))
        return self.decoder(self.drop_out(y))


def rnn_phase(dev, tnn, cls, counted, launches, smi):
    """20c: step 1 (dropout 0) on the card against the CPU, then 1 warm-up
    and 3 timed steps at dropout 0.5 from a generator, a 1-step
    profile."""
    from paddle_tpu_torch.nn import clip as clip_mod
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.optimizer import SGD

    gen = torch.Generator().manual_seed(21)
    ids = torch.randint(0, RNN_VOCAB, (RNN_BATCH, RNN_STEPS + 1),
                        generator=gen)
    batch = (ids[:, :-1], ids[:, 1:])
    seed_state = RNNLM(tnn, cls, "cpu", 0.0).state_dict()

    def make(device, dropout, generator=None):
        model = RNNLM(tnn, cls, device, dropout, generator)
        model.load_state_dict(seed_state)
        opt = SGD(RNN_LR, parameters=model.parameters(),
                  grad_clip=tnn.ClipGradByGlobalNorm(RNN_CLIP))
        return model, opt

    def step(model, opt, x, y, norms=None):
        loss = cross_entropy(model(x).reshape(-1, RNN_VOCAB), y.reshape(-1))
        loss.backward()
        if norms is not None:
            norms.append(float(torch.sqrt(sum(
                p.grad.double().square().sum()
                for p in model.parameters()))))
        opt.step()
        opt.clear_grad()
        return loss.detach()

    def first(device, clip_calls):
        model, opt = make(device, 0.0)
        norms = []
        with (calls_kept(clip_mod, "grad_global_norm", clip_calls)
              if clip_calls is not None else contextlib.nullcontext()):
            loss = float(step(model, opt, *(t.to(device) for t in batch),
                              norms))
        return loss, norms[0], {n: p.detach().cpu()
                                for n, p in model.named_parameters()}

    clip_calls = []
    loss_k, norm_k, after_k = first(dev, clip_calls)
    loss_p, norm_p, after_p = first(torch.device("cpu"), None)
    l_err, g_err = abs(loss_k - loss_p) / loss_p, abs(norm_k - norm_p) / norm_p
    # the clip's sum-of-squares kernel against its plain version on the
    # card step's own gradients: [norm, scale]
    (_, before, _, got_clip), = clip_calls
    want_clip = fused._global_norm_reference(before[0], RNN_CLIP)
    clip_err = float(((got_clip - want_clip).abs() / want_clip.abs()).max())
    norm_clip = [float(x) for x in want_clip]
    del clip_calls, before
    # each parameter after the clipped update against the CPU's, beyond
    # one ulp of its value, over the tensor's largest update
    def update_err(n):
        value = after_p[n].abs()
        ulp = torch.nextafter(value, torch.tensor(math.inf)) - value
        excess = ((after_k[n] - after_p[n]).abs() - ulp).clamp(min=0)
        return float(excess.max()) / max(
            float((after_p[n] - seed_state[n]).abs().max()), 1e-30)

    upd_err = max(update_err(n) for n in after_p)
    model, opt = make(dev, RNN_DROPOUT,
                      torch.Generator(device=dev).manual_seed(22))
    data = tuple(t.to(dev) for t in batch)
    run = lambda x, y: step(model, opt, x, y)  # noqa: E731
    run(*data)
    _cleared(counted)
    losses, times, wall = timed_steps(run, data, RNN_TRAIN_STEPS)
    got = _read_launches(counted, launches, f"rnn_{cls.lower()}")
    prof = profile_step(f"20c {cls}", run, data, n_steps=1, top=6)
    p50 = times[len(times) // 2]
    out = {"step1_loss_card": loss_k, "step1_loss_cpu": loss_p,
           "loss_rel_err": l_err, "grad_norm_rel_err": g_err,
           "clip_norm_scale": norm_clip, "clip_rel_err": clip_err,
           "update_rel_err": upd_err,
           "tokens_per_s": RNN_BATCH * RNN_STEPS * RNN_TRAIN_STEPS / wall,
           "step_p50_ms": p50, "device_ms_per_step":
               prof["device_ms_per_step"], "busy_share": prof["busy_share"],
           "kernel_launches_per_step": prof["launches_per_step"],
           "grad_sumsq_launches": got["grad_sumsq"],
           "losses": [float(x) for x in losses], "card": smi}
    log(f"[20c] {cls} LM ({RNN_LAYERS} x {RNN_HIDDEN}, {RNN_STEPS} steps, "
        f"batch {RNN_BATCH}, vocab {RNN_VOCAB}): step 1 "
        f"loss {loss_k:.6f} (card) vs {loss_p:.6f} (CPU), rel err "
        f"{l_err:.3g} (tol {NMT_LOSS_RTOL}), grad norm rel err {g_err:.3g} "
        f"(tol {NMT_GNORM_RTOL}); the clip's [norm, scale] "
        f"[{norm_clip[0]:.6g}, {norm_clip[1]:.6g}] from the sum-of-squares "
        f"kernel vs plain, rel err {clip_err:.3g} (tol {NORM_RTOL}); "
        f"parameters after the update vs the CPU's, err beyond an ulp / "
        f"max|update| {upd_err:.3g} (tol {RNN_UPDATE_RTOL}); dropout "
        f"{RNN_DROPOUT}: "
        f"{out['tokens_per_s']:.1f} tokens/s, step p50 {p50:.2f} ms, "
        f"device {out['device_ms_per_step']:.2f} ms a step, busy share "
        f"{out['busy_share']:.4f}, {out['kernel_launches_per_step']} kernel "
        f"launches a step (the per-step loop: launch-bound); the clip's "
        f"sum-of-squares launches {got['grad_sumsq']} ({smi})")
    if not (l_err <= NMT_LOSS_RTOL and g_err <= NMT_GNORM_RTOL
            and upd_err <= RNN_UPDATE_RTOL):
        raise AssertionError(f"20c {cls}: step 1 is off the CPU's")
    if not clip_err <= NORM_RTOL:
        raise AssertionError(f"20c {cls}: the clip's sum-of-squares kernel "
                             f"is off its plain version by {clip_err:.3g}")
    if got["grad_sumsq"] != 2 * RNN_TRAIN_STEPS or not all(
            math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"20c {cls}: launches {got}, losses "
                             f"{out['losses']}")
    return out


def breadth_cases(tnn, F):
    """name -> (callable(tensors..., device), inputs maker(rng) -> numpy
    args, kwargs, differentiable positions). Layers are built on the
    device the call runs on, from the CPU layer's state."""
    f32 = lambda r, *s: r.randn(*s).astype(np.float32)  # noqa: E731
    probs = lambda r, *s: (r.rand(*s) * 0.9 + 0.05).astype(  # noqa: E731
        np.float32)
    signs = lambda r, *s: np.where(r.rand(*s) > 0.5, 1.0,  # noqa: E731
                                   -1.0).astype(np.float32)
    ints = lambda r, hi, *s: r.randint(0, hi, s).astype(np.int64)  # noqa

    def ctc(r, ll=(4, 3, 2), il=(12, 10, 8)):
        return (f32(r, 12, 3, 6), r.randint(1, 6, (3, 5)).astype(np.int64),
                np.array(il, np.int64), np.array(ll, np.int64))

    def hsig(r):
        return (f32(r, 5, 4), ints(r, 6, 5, 1), 6, f32(r, 5, 4),
                f32(r, 5, 1))

    table = np.array([[0, 2, -1], [1, 3, 4], [0, -1, -1], [4, 2, 1],
                      [3, 0, -1]], np.int64)
    fn = lambda name: lambda *a, **k: getattr(F, name)(*a, **k)  # noqa
    cases = {
        "softmax_with_cross_entropy": (fn("softmax_with_cross_entropy"),
                                       lambda r: (f32(r, 6, 5),
                                                  ints(r, 5, 6, 1)),
                                       {}, (0,)),
        "mse_loss": (fn("mse_loss"), lambda r: (f32(r, 4, 3), f32(r, 4, 3)),
                     {}, (0, 1)),
        "l1_loss": (fn("l1_loss"), lambda r: (f32(r, 4, 3), f32(r, 4, 3)),
                    dict(reduction="sum"), (0, 1)),
        "square_error_cost": (fn("square_error_cost"), lambda r: (
            f32(r, 4, 3), f32(r, 4, 3)), {}, (0,)),
        "nll_loss": (fn("nll_loss"), lambda r: (
            np.log(probs(r, 8, 5)), np.array([0, 3, -100, 4, 1, 1, 2, 0]),
            probs(r, 5)), {}, (0,)),
        "binary_cross_entropy": (fn("binary_cross_entropy"), lambda r: (
            probs(r, 4, 3), probs(r, 4, 3)), {}, (0,)),
        "binary_cross_entropy_with_logits": (
            fn("binary_cross_entropy_with_logits"), lambda r: (
                f32(r, 4, 3), probs(r, 4, 3), probs(r, 3)), {}, (0,)),
        "kl_div": (fn("kl_div"), lambda r: (np.log(probs(r, 4, 5)),
                                            probs(r, 4, 5)),
                   dict(reduction="batchmean"), (0, 1)),
        "smooth_l1_loss": (fn("smooth_l1_loss"), lambda r: (
            f32(r, 5, 4), f32(r, 5, 4)), dict(delta=0.5), (0,)),
        "margin_ranking_loss": (fn("margin_ranking_loss"), lambda r: (
            f32(r, 8), f32(r, 8), signs(r, 8)), dict(margin=0.3), (0, 1)),
        "hinge_embedding_loss": (fn("hinge_embedding_loss"), lambda r: (
            f32(r, 4, 5), signs(r, 4, 5)), {}, (0,)),
        "cosine_embedding_loss": (fn("cosine_embedding_loss"), lambda r: (
            f32(r, 6, 4), f32(r, 6, 4), signs(r, 6)), {}, (0, 1)),
        "log_loss": (fn("log_loss"), lambda r: (probs(r, 5, 1),
                                                probs(r, 5, 1)), {}, (0,)),
        "sigmoid_focal_loss": (fn("sigmoid_focal_loss"), lambda r: (
            f32(r, 6, 3), probs(r, 6, 3), np.array([3.0], np.float32)), {},
            (0,)),
        "triplet_margin_loss": (fn("triplet_margin_loss"), lambda r: (
            f32(r, 5, 4), f32(r, 5, 4), f32(r, 5, 4)), dict(swap=True),
            (0, 1, 2)),
        "ctc_loss": (fn("ctc_loss"), ctc, {}, (0,)),
        "ctc_loss_infeasible": (fn("ctc_loss"), lambda r: ctc(
            r, (5, 3, 2), (3, 10, 8)), dict(reduction="none"), (0,)),
        "edit_distance": (fn("edit_distance"), lambda r: (
            ints(r, 5, 4, 7), ints(r, 5, 4, 6), False, [0, 3],
            np.array([7, 5, 0, 3]), np.array([6, 2, 4, 0])), {}, ()),
        "hsigmoid_loss": (fn("hsigmoid_loss"), hsig, {}, (0, 3, 4)),
        "hsigmoid_loss_custom": (
            lambda x, lbl, n, w, b, t, c: F.hsigmoid_loss(
                x, lbl, n, w, b, path_table=t, path_code=c),
            lambda r: (f32(r, 5, 4), ints(r, 6, 5, 1), 6, f32(r, 6, 4),
                       f32(r, 6, 1), table, ints(r, 2, 5, 3)), {},
            (0, 3, 4)),
        "dice_loss": (fn("dice_loss"), lambda r: (probs(r, 4, 3, 5),
                                                  ints(r, 5, 4, 3, 1)), {},
                      (0,)),
        "npair_loss": (fn("npair_loss"), lambda r: (
            f32(r, 6, 4), f32(r, 6, 4), np.array([0, 1, 0, 2, 1, 3])), {},
            (0, 1)),
        "layer_norm": (fn("layer_norm"), lambda r: (
            f32(r, 6, 64), 64, f32(r, 64) + 1, f32(r, 64)), {}, (0, 2, 3)),
        "layer_norm_two_axes": (fn("layer_norm"), lambda r: (
            f32(r, 3, 4, 8), [4, 8]), {}, (0,)),
        "instance_norm": (fn("instance_norm"), lambda r: (
            f32(r, 2, 3, 4, 5), None, None, f32(r, 3), f32(r, 3)), {},
            (0, 3, 4)),
        "group_norm": (fn("group_norm"), lambda r: (
            f32(r, 2, 6, 3, 3), 3, 1e-5, f32(r, 6), f32(r, 6)), {},
            (0, 3, 4)),
        "local_response_norm": (fn("local_response_norm"), lambda r: (
            f32(r, 2, 7, 3, 3), 5), {}, (0,)),
        "grid_sample_bilinear_zeros": (fn("grid_sample"), lambda r: (
            f32(r, 2, 3, 5, 6), f32(r, 2, 4, 7, 2) * 0.8), {}, (0, 1)),
        "grid_sample_bilinear_border": (fn("grid_sample"), lambda r: (
            f32(r, 2, 3, 5, 6), f32(r, 2, 4, 7, 2) * 0.8),
            dict(padding_mode="border", align_corners=False), (0, 1)),
        "grid_sample_nearest_reflection": (fn("grid_sample"), lambda r: (
            f32(r, 2, 3, 5, 6), f32(r, 2, 4, 7, 2) * 0.8),
            dict(mode="nearest", padding_mode="reflection"), (0,)),
        "affine_grid": (fn("affine_grid"), lambda r: (
            f32(r, 2, 2, 3), [2, 3, 4, 5]), {}, (0,)),
        "temporal_shift": (fn("temporal_shift"), lambda r: (
            f32(r, 6, 8, 3, 3), 3), {}, (0,)),
        "temporal_shift_nhwc": (fn("temporal_shift"), lambda r: (
            f32(r, 6, 3, 3, 8), 3), dict(data_format="NHWC"), (0,)),
        "gather_tree": (fn("gather_tree"), lambda r: (
            ints(r, 9, 5, 3, 4), ints(r, 4, 5, 3, 4)), {}, ()),
    }
    layers = {
        "MSELoss": (lambda d: tnn.MSELoss(), 2),
        "L1Loss": (lambda d: tnn.L1Loss(), 2),
        "NLLLoss": (lambda d: tnn.NLLLoss(), "nll"),
        "BCELoss": (lambda d: tnn.BCELoss(), "probs"),
        "BCEWithLogitsLoss": (lambda d: tnn.BCEWithLogitsLoss(), 2),
        "KLDivLoss": (lambda d: tnn.KLDivLoss(), "kl"),
        "SmoothL1Loss": (lambda d: tnn.SmoothL1Loss(), 2),
        "MarginRankingLoss": (lambda d: tnn.MarginRankingLoss(0.2),
                              "rank"),
        "HingeEmbeddingLoss": (lambda d: tnn.HingeEmbeddingLoss(), "hinge"),
        "CosineEmbeddingLoss": (lambda d: tnn.CosineEmbeddingLoss(),
                                "cosine"),
        "CTCLoss": (lambda d: tnn.CTCLoss(), "ctc"),
        "TripletMarginLoss": (lambda d: tnn.TripletMarginLoss(), 3),
        "HSigmoidLoss": (lambda d: tnn.HSigmoidLoss(4, 6, device=d),
                         "hsig"),
        "GroupNorm": (lambda d: tnn.GroupNorm(2, 4, device=d), "nchw4"),
        "InstanceNorm1D": (lambda d: tnn.InstanceNorm1D(3, device=d),
                           "ncl"),
        "InstanceNorm2D": (lambda d: tnn.InstanceNorm2D(4, device=d),
                           "nchw4"),
        "InstanceNorm3D": (lambda d: tnn.InstanceNorm3D(2, device=d),
                           "ncdhw"),
        "LocalResponseNorm": (lambda d: tnn.LocalResponseNorm(3), "nchw4"),
        "SpectralNorm": (lambda d: tnn.SpectralNorm([4, 3, 2], dim=1,
                                                    power_iters=3,
                                                    device=d), "w432"),
        "SyncBatchNorm": (lambda d: tnn.SyncBatchNorm(4, device=d),
                          "nchw4"),
        "PairwiseDistance": (lambda d: tnn.PairwiseDistance(), 2),
        "weight_norm": (lambda d: tnn.weight_norm(tnn.Linear(
            4, 3, device=d)), "lin"),
        "spectral_norm": (lambda d: tnn.spectral_norm(tnn.Conv2D(
            4, 3, 3, device=d), dim=1), "nchw4"),
        "ParameterList": (lambda d: _ParamProduct(tnn, d), "lin"),
    }
    inputs = {
        2: lambda r: (f32(r, 4, 3), f32(r, 4, 3)),
        3: lambda r: (f32(r, 5, 3), f32(r, 5, 3), f32(r, 5, 3)),
        "nll": lambda r: (np.log(probs(r, 6, 4)), ints(r, 4, 6)),
        "probs": lambda r: (probs(r, 4, 3), probs(r, 4, 3)),
        "kl": lambda r: (np.log(probs(r, 4, 5)), probs(r, 4, 5)),
        "rank": lambda r: (f32(r, 6), f32(r, 6), signs(r, 6)),
        "hinge": lambda r: (f32(r, 4, 3), signs(r, 4, 3)),
        "cosine": lambda r: (f32(r, 5, 3), f32(r, 5, 3), signs(r, 5)),
        "ctc": ctc,
        "hsig": lambda r: hsig(r)[:2],
        "nchw4": lambda r: (f32(r, 2, 4, 5, 5),),
        "ncl": lambda r: (f32(r, 2, 3, 6),),
        "ncdhw": lambda r: (f32(r, 1, 2, 3, 3, 3),),
        "w432": lambda r: (f32(r, 4, 3, 2),),
        "lin": lambda r: (f32(r, 5, 4),),
    }
    for name, (build, kind) in layers.items():
        cases[name] = (("layer", build), inputs[kind], {}, (0,))
    return cases


class _ParamProduct(torch.nn.Module):
    """``x @ p0 @ p1`` over a ``ParameterList``."""

    def __init__(self, tnn, device):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.plist = tnn.ParameterList([torch.nn.Parameter(
            torch.randn(4, 6, generator=gen).to(device))])
        self.plist.append(torch.nn.Parameter(
            torch.randn(6, 2, generator=gen).to(device)))

    def forward(self, x):
        return x @ self.plist[0] @ self.plist[1]


def breadth_call(fn, args, kw, grad, device, layer_state=None):
    """(first output, gradients of ``grad`` positions) on ``device``;
    ``fn`` may be ("layer", build(device)). On the card the call and its
    backward run with synchronizing CUDA calls turned into errors."""
    targs = [torch.from_numpy(np.array(a)).to(device).requires_grad_(
        i in grad) if isinstance(a, np.ndarray) else a
        for i, a in enumerate(args)]
    state = None
    if isinstance(fn, tuple):
        layer = fn[1](device)
        if layer_state is not None:
            layer.load_state_dict(layer_state)
        state = layer.state_dict()
        fn = layer
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*targs, **kw)
        out = out[0] if isinstance(out, (tuple, list)) else out
        if grad:
            ct = torch.linspace(0.5, 1.5, out.numel(), device=out.device
                                ).reshape(out.shape)
            (out * ct).sum().backward()
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    grads = [targs[i].grad.cpu() for i in grad]
    return out.detach().cpu(), grads, state


def breadth_phase(dev, tnn, F, static, counted, launches):
    """20d: every function and layer of the slice on the card against the
    same call on CPU tensors, and the four static.nn functions through
    ``Executor.run`` on the card against the CPU's."""
    worst_v, worst_g, n = 0.0, 0.0, 0
    _cleared(counted)
    for name, (fn, build, kw, grad) in breadth_cases(tnn, F).items():
        args = build(np.random.RandomState(0))
        cpu, cpu_g, state = breadth_call(fn, args, kw, grad, "cpu")
        card, card_g, _ = breadth_call(fn, args, kw, grad, dev, state)
        ok, e = _close_report(card, cpu, *BREADTH_TOL)
        worst_v = max(worst_v, e)
        for i, (a, b) in enumerate(zip(card_g, cpu_g)):
            tol = BREADTH_GRAD_TOL
            if name == "ctc_loss_infeasible":
                a, b = a[:, 1:], b[:, 1:]  # the feasible sequences
                ok2, e = _close_report(card_g[i][:, :1], cpu_g[i][:, :1],
                                       0.0, CTC_INFEASIBLE_GRAD_ATOL)
                ok = ok and ok2
            ok2, e2 = _close_report(a, b, *tol)
            ok, worst_g = ok and ok2, max(worst_g, e2)
        if not ok:
            raise AssertionError(f"20d: {name} on the card is off the CPU's")
        n += 1
    got = _read_launches(counted, launches, "nn_breadth")
    static_err = static_breadth(dev, static)
    log(f"[20d] {n} functions and layers on the card (under "
        f"torch.cuda.set_sync_debug_mode('error')) against "
        f"the CPU: worst value err {worst_v:.3g}, worst grad err "
        f"{worst_g:.3g} (tols {BREADTH_TOL}, {BREADTH_GRAD_TOL}); "
        f"static.nn group_norm / instance_norm / spectral_norm / nce through "
        f"Executor.run: worst err {static_err:.3g}; #5 launches "
        f"{got['layer_norm_fwd']}")
    if got["layer_norm_fwd"] < 1 or static_err > BREADTH_TOL[1]:
        raise AssertionError("20d: F.layer_norm missed #5, or a static.nn "
                             "function is off the CPU's")
    return {"cases": n, "worst_value_err": worst_v,
            "worst_grad_err": worst_g, "static_worst_err": static_err}


def _close_report(got, want, rtol, atol):
    """(within rtol·|want| + atol everywhere, worst |got - want| beyond
    rtol·|want|)."""
    excess = (got.double() - want.double()).abs() - rtol * want.double(
        ).abs()
    worst = float(excess.max()) if excess.numel() else 0.0
    return worst <= atol, max(worst, 0.0)


def static_breadth(dev, static):
    """The four static.nn functions of the slice recorded once on the card
    and once on the CPU (the CPU program's parameters copied over), run
    through ``Executor.run``: the worst difference."""
    r = np.random.RandomState(1)
    feeds = {"x4": r.randn(2, 4, 3, 3).astype(np.float32),
             "w": r.randn(4, 3, 2).astype(np.float32),
             "x": r.randn(5, 4).astype(np.float32),
             "l": r.randint(0, 9, (5, 1)).astype(np.int64)}

    def program(device):
        main = static.Program()
        with static.program_guard(main):
            d = lambda n, s, t: static.data(n, s, t, device=device)  # noqa
            x4 = d("x4", [None, 4, 3, 3], "float32")
            outs = [static.nn.group_norm(x4, 2, act="relu"),
                    static.nn.instance_norm(x4),
                    static.nn.spectral_norm(d("w", [4, 3, 2], "float32"),
                                            dim=1, power_iters=3),
                    static.nn.nce(d("x", [None, 4], "float32"),
                                  d("l", [None, 1], "int64"), 9,
                                  num_neg_samples=3, seed=5)]
        return main, outs

    cpu_prog, cpu_outs = program("cpu")
    card_prog, card_outs = program(dev)
    with torch.no_grad():
        for a, b in zip(card_prog.all_parameters(),
                        cpu_prog.all_parameters()):
            a.copy_(b)
    want = static.Executor(static.CPUPlace()).run(
        cpu_prog, feed=feeds, fetch_list=cpu_outs)
    got = static.Executor(static.CUDAPlace(0)).run(
        card_prog, feed=feeds, fetch_list=card_outs)
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def nn_slice_phase(dev, counted, launches, smi):
    """Phase 20: Transformer-base trained and beam-searched, the LSTM and
    GRU language models, and the breadth of the slice."""
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer import lr as lr_mod

    out, seconds = {}, {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    tnn.initializer.seed(20)
    seed_state = NMTModel(tnn, "cpu", 0.0).state_dict()
    batch = nmt_batch(torch.Generator(device=dev).manual_seed(20), dev)
    common = (seed_state, lr_mod, Adam, ParallelTrainStep)
    out["parity"] = nmt_parity(dev, tnn, fused, batch, *common, counted,
                               launches)
    lap("20a_parity")
    model, out["f32"] = nmt_timed_leg(dev, tnn, fused, amp, batch, *common,
                                      counted, launches, False, smi)
    lap("20a_f32")
    out["beam"] = nmt_beam_phase(dev, tnn, model, batch, counted, launches,
                                 smi)
    del model
    torch.cuda.empty_cache()
    lap("20b")
    model, out["bf16"] = nmt_timed_leg(dev, tnn, fused, amp, batch, *common,
                                       counted, launches, True, smi)
    del model
    torch.cuda.empty_cache()
    lap("20a_bf16")
    out["lstm"] = rnn_phase(dev, tnn, "LSTM", counted, launches, smi)
    out["gru"] = rnn_phase(dev, tnn, "GRU", counted, launches, smi)
    lap("20c")
    out["breadth"] = breadth_phase(dev, tnn, F, static, counted, launches)
    torch.cuda.empty_cache()
    lap("20d")
    out["seconds"] = seconds
    log("[20] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


# --- phase 21: the tensor API ----------------------------------------------------
# 21a: every function of the tensor namespace on the card against the same
# call on CPU tensors, each case's own tolerance (tests/torch_tensor_cases.py)
# loosened to this floor for the card's other summation orders and
# transcendental approximations (max |card - cpu| <= atol + rtol·|cpu|)
TENSOR_CARD_TOL = (1e-4, 1e-5)
# torch's lstsq on CUDA has the 'gels' driver only, which returns no
# residuals, rank or singular values: the solution alone is compared
SOLUTION_ONLY_ON_CARD = {"lstsq"}
# 21b: GPT-2 345M trained through the top-level API, as phase 8's shape
TENSOR_PATH_STEPS = 10
# step 1's loss against phase 8's ParallelTrainStep on the same weights and
# batch: the same bf16 ops if the engine's casts give the same bf16 weights;
# else within a few bf16 roundings of the mean loss (2^-7 relative)
TENSOR_PATH_LOSS_RTOL = 2.0 ** -7
# 21c: top-k sampling from the trained model
SAMPLE_PROMPT, SAMPLE_TOKENS, SAMPLE_TOP_K = 32, 16, 40
# 21d: WGAN-GP (Gulrajani et al. 2017) on a 1024-4096-1024 GELU MLP critic
GP_LAMBDA, GP_BATCH, GP_WIDTHS = 10.0, 8192, (1024, 4096, 1024)
# the penalty's gradient, f32 with TF32 off, card against CPU: each tensor
# within this share of its largest magnitude (sums over 8192 samples in
# other orders, through a second derivative)
GP_GRAD_REL_TOL = 1e-4
STE_SHAPE = (8, 1024, 4096)


def _tensor_cases():
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_tensor_cases as tc

    return tc


def _card_guard(tc, synced):
    """A context that turns a synchronizing CUDA call into an error, except
    for the cases allowed to sync; a case that raised is noted in
    ``synced`` (and rerun without the guard)."""

    @contextlib.contextmanager
    def guard(name):
        if name in tc.SYNCS or name in synced:
            yield
            return
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return guard


def tensor_breadth(dev):
    """21a: each case of the tensor namespace on the card (creation on the
    current device "gpu:0") against the CPU's, under
    ``set_sync_debug_mode("error")`` but for ``SYNCS``; then the static
    sequence functions through ``Executor.run``."""
    import paddle_tpu_torch as P

    tc = _tensor_cases()
    synced, failed, worst_v, worst_g, n = set(), [], 0.0, 0.0, 0
    guard = _card_guard(tc, synced)
    for name, case in tc.all_cases().items():
        P.set_device("cpu")
        want = tc.run(name, case, tc.PortAdapter(P.tensor, "cpu"))
        P.set_device("gpu:0")
        card = tc.PortAdapter(P.tensor, dev)
        try:
            got = tc.run(name, case, card, guard=guard)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            synced.add(name)
            torch.cuda.set_sync_debug_mode(0)
            got = tc.run(name, case, card, guard=guard)
        try:
            if case.kind == "random":
                tc.compare_random(name, got[0])
                tc.compare_random(name, want[0])
            else:
                if name in SOLUTION_ONLY_ON_CARD:
                    got, want = (got[0][:1], got[1]), (want[0][:1],
                                                       want[1])
                tol = tuple(max(a, b) for a, b in zip(case.tol,
                                                       TENSOR_CARD_TOL))
                v, g = tc.compare(name, case._replace(tol=tol), got, want)
                worst_v, worst_g = max(worst_v, v), max(worst_g, g)
        except AssertionError as e:
            failed.append(str(e))
        n += 1
    P.set_device("gpu:0")
    unexpected = synced - tc.TORCH_SYNCS
    if failed or unexpected:
        raise AssertionError(
            f"21a: {len(failed)} cases are off the CPU's: "
            + "; ".join(failed) + f"; unexpected syncs: {sorted(unexpected)}"
            + f"; all syncs: {sorted(synced)}")
    log(f"[21a] {n} cases of the tensor namespace on the card against the "
        f"CPU: worst excess of |card - cpu| over rtol·|cpu|: values "
        f"{worst_v:.3g}, gradients {worst_g:.3g} (within atol: each case's "
        f"tolerance, at least {TENSOR_CARD_TOL}); "
        f"{len(tc.SYNCS)} cases may sync (data-dependent sizes, host "
        f"reads); cases whose torch implementation synced (cuSOLVER "
        f"status): {sorted(synced)}")
    if unexpected:
        raise AssertionError(f"21a: these cases synchronized with the card "
                             f"under set_sync_debug_mode('error'): "
                             f"{sorted(unexpected)}")
    static_err = static_sequence_breadth(dev)
    log(f"[21a] static.nn.sequence_* through Executor.run on the card "
        f"against the CPU: worst err {static_err:.3g}")
    if static_err > TENSOR_CARD_TOL[0]:
        raise AssertionError("21a: a static.nn sequence function is off the "
                             "CPU's")
    return {"cases": n, "worst_value_err": worst_v,
            "worst_grad_err": worst_g, "may_sync": len(tc.SYNCS),
            "torch_synced": sorted(synced),
            "static_sequence_worst_err": static_err}


def static_sequence_breadth(dev):
    """The static sequence functions recorded on the card and on the CPU
    (the CPU program's parameters copied over), run through
    ``Executor.run`` at a batch other than the record time's: the worst
    difference."""
    from paddle_tpu_torch import static

    r = np.random.RandomState(2)
    feeds = {"x": r.randn(4, 5, 2).astype(np.float32),
             "n": np.array([3, 1, 5, 4], np.int64),
             "i": np.array([[0, 4], [1, 1], [2, 3], [4, 0]], np.int64),
             "u": r.randn(4, 2, 2).astype(np.float32)}

    def program(device):
        main = static.Program()
        with static.program_guard(main):
            d = lambda n, s, t: static.data(n, s, t, device=device)  # noqa
            x, n = d("x", [None, 5, 2], "float32"), d("n", [None], "int64")
            nn = static.nn
            outs = [nn.sequence_conv(x, 3, filter_size=3, act="relu"),
                    nn.sequence_reshape(x, 5),
                    nn.sequence_scatter(x, d("i", [None, 2], "int64"),
                                        d("u", [None, 2, 2], "float32")),
                    nn.sequence_pool(x, "max", n),
                    nn.sequence_pool(x, "sqrt", n),
                    nn.sequence_last_step(x, n),
                    nn.sequence_softmax(x, n), nn.sequence_reverse(x, n),
                    nn.sequence_enumerate(x[..., 0], 2, lengths=n)]
        return main, outs

    cpu_prog, cpu_outs = program("cpu")
    card_prog, card_outs = program(dev)
    with torch.no_grad():
        for a, b in zip(card_prog.all_parameters(),
                        cpu_prog.all_parameters()):
            a.copy_(b)
    want = static.Executor(static.CPUPlace()).run(
        cpu_prog, feed=feeds, fetch_list=cpu_outs)
    got = static.Executor(static.CUDAPlace(0)).run(
        card_prog, feed=feeds, fetch_list=card_outs)
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def _engine_step1_loss(gpt_mod, ids, labels):
    """Phase 8's first step (ParallelTrainStep, bf16 compute over f32
    masters) from the seed-4 weights on this batch."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import Adam

    cfg = gpt_mod.gpt2_medium(hidden_dropout=0.0, attention_dropout=0.0)
    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.float32, seed=4)
    opt = Adam(TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt,
                             compute_dtype=torch.bfloat16)
    loss = step((ids, labels), (labels,)).detach().float().cpu()
    del step, model, opt
    torch.cuda.empty_cache()
    return loss


def tensor_path(dev, counted, launches, phase8, smi):
    """21b: GPT-2 345M at bench.py's shape trained as a reference user
    writes the loop: ``paddle.seed``, the batch from ``paddle.randint``,
    O2 bf16 with Adam's f32 masters, ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``; an accuracy from argmax / equal / mean."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    paddle.set_device("gpu:0")
    paddle.seed(21)
    cfg = gpt_mod.gpt2_medium(hidden_dropout=0.0, attention_dropout=0.0)
    ids = paddle.randint(0, cfg.vocab_size, list(TRAIN_SHAPE))
    labels = paddle.roll(ids, -1, axis=1)
    ref_loss = _engine_step1_loss(gpt_mod, ids, labels)

    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.float32, seed=4)
    opt = paddle.optimizer.Adam(TRAIN_LR, parameters=model.parameters(),
                                multi_precision=True)
    model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")

    def train_step(ids, labels):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    first = train_step(ids, labels).float().cpu()
    same_bits = bool(torch.equal(first, ref_loss))
    rel = float((first - ref_loss).abs() / ref_loss.abs())
    log(f"[21b] step 1's loss {float(first):.6f} against phase 8's "
        f"ParallelTrainStep on the same weights and batch "
        f"{float(ref_loss):.6f}: same bits {same_bits}, relative diff "
        f"{rel:.3g} (tol {TENSOR_PATH_LOSS_RTOL:.3g})")
    if rel > TENSOR_PATH_LOSS_RTOL:
        raise AssertionError("21b: step 1's loss is off phase 8's")
    for _ in range(2):
        train_step(ids, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    losses, step_ms, wall = timed_steps(train_step, (ids, labels),
                                        TENSOR_PATH_STEPS)
    got = _read_launches(counted, launches, "tensor_path")
    peak = torch.cuda.max_memory_allocated()
    n = TENSOR_PATH_STEPS
    n_ln = 2 * cfg.num_layers + 1
    want = {"layer_norm_fwd": n_ln * n, "layer_norm_bwd": 2 * n_ln * n,
            "flash_attn_fwd": cfg.num_layers * n,
            "flash_attn_bwd_dq": cfg.num_layers * n,
            "flash_attn_bwd_dkv": cfg.num_layers * n, "adam": 2 * n}
    if any(got[k] != want[k] for k in want):
        raise AssertionError(f"21b launched {got}, expected {want}")
    prof = profile_step("21b", train_step, (ids, labels))
    with torch.no_grad(), paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        logits = model(ids)
        acc = paddle.mean(paddle.cast(paddle.equal(
            paddle.argmax(logits, axis=-1), labels), "float32"))
    losses = [float(x) for x in [first] + losses]
    out = {"tokens_per_s": TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * n / wall,
           "step_ms_p50": step_ms[n // 2], "step_ms_min": step_ms[0],
           "step_ms_max": step_ms[-1],
           "device_ms_per_step": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"], "peak_memory_bytes": peak,
           "losses": losses, "accuracy": float(acc),
           "step1_loss": float(first), "step1_loss_phase8": float(ref_loss),
           "step1_same_bits": same_bits, "step1_rel_diff": rel,
           "launches": got, "card": smi}
    p8 = phase8.get("profile") or {}
    log(f"[21b] GPT-2 345M through the top-level API at {TRAIN_SHAPE}: "
        f"{out['tokens_per_s']:.1f} tokens/s (phase 8 "
        f"{phase8['tokens_per_s']:.1f}), step p50 {out['step_ms_p50']:.2f} "
        f"ms (phase 8 {phase8['step_ms_p50']:.2f}), device "
        f"{out['device_ms_per_step']:.2f} ms a step (phase 8 "
        f"{p8.get('device_ms_per_step', float('nan')):.2f}), busy share "
        f"{out['busy_share']:.4f} (phase 8 "
        f"{p8.get('busy_share', float('nan')):.4f}), peak memory "
        f"{peak / 2**30:.2f} GiB (phase 8 "
        f"{phase8['peak_memory_bytes'] / 2**30:.2f}); loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}, accuracy {out['accuracy']:.4f}; launches "
        f"{got}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"21b: the loss did not fall: {losses}")
    return model, ids, out


def sample_tokens(paddle, F, model, prompt):
    """SAMPLE_TOKENS tokens of top-k sampling, one full forward a token."""
    seq = prompt
    with torch.no_grad(), paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        for _ in range(SAMPLE_TOKENS):
            logits = model(seq)[:, -1, :].float()
            vals, idx = paddle.topk(logits, SAMPLE_TOP_K)
            probs = F.softmax(vals, axis=-1)
            pick = paddle.multinomial(probs, 1)
            seq = paddle.concat([seq, paddle.index_sample(idx, pick)],
                                axis=1)
    return seq[:, prompt.shape[1]:]


def sampling_phase(model, ids):
    """21c: 16 tokens sampled from the trained model, then the card's
    random state set back to the one read before the draw and the same 16
    tokens again."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    prompt = ids[:2, :SAMPLE_PROMPT]
    state = paddle.get_cuda_rng_state()
    first = sample_tokens(paddle, F, model, prompt)
    paddle.set_cuda_rng_state(state)
    again = sample_tokens(paddle, F, model, prompt)
    other = sample_tokens(paddle, F, model, prompt)
    same = bool(torch.equal(first, again))
    log(f"[21c] top-{SAMPLE_TOP_K} sampling, {SAMPLE_TOKENS} tokens x "
        f"{prompt.shape[0]} rows: {first.tolist()}; replayed from the saved "
        f"state: same {same}; a third draw (state moved on) differs: "
        f"{not torch.equal(first, other)}")
    if not same or first.shape != (prompt.shape[0], SAMPLE_TOKENS):
        raise AssertionError("21c: the replayed draw gave other tokens")
    return {"tokens": first.tolist(), "replay_equal": same}


def _third_order(paddle, x):
    y = (paddle.tanh(x) * x ** 2 + paddle.sin(x) * x).sum()
    (g1,) = paddle.grad(y, [x], create_graph=True)
    (g2,) = paddle.grad(g1.sum(), [x], create_graph=True)
    (g3,) = paddle.grad(g2.sum(), [x])
    return [g.detach().cpu() for g in (g1, g2, g3)]


def _gp_grads(paddle, F, params, x):
    """The WGAN-GP penalty's gradient with respect to the critic's
    weights."""
    w1, b1, w2, b2 = params
    score = (F.gelu(x @ w1 + b1) @ w2 + b2).sum()
    (gx,) = paddle.grad(score, [x], create_graph=True)
    norm = paddle.sqrt((gx ** 2).sum(axis=1) + 1e-12)
    penalty = GP_LAMBDA * ((norm - 1.0) ** 2).mean()
    return [g.cpu() for g in paddle.grad(penalty, params[:3])], float(
        penalty.detach())


def autograd_phase(dev):
    """21d: third-order gradients, the WGAN-GP penalty's gradient and a
    PyLayer on the card against the CPU, and higher derivatives through
    the LayerNorm and attention kernels against their plain versions'."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.flash_tpu import _flash_reference as \
        flash_reference
    from paddle_tpu_torch.ops.flash_tpu import (flash_attention_blhd,
                                                flash_attention_full)
    from paddle_tpu_torch.ops.fused import _ln_reference as \
        fused_ln_reference
    from paddle_tpu_torch.ops.fused import fused_layer_norm

    r = np.random.RandomState(21)
    a = r.randn(4096).astype(np.float32)
    cpu = _third_order(paddle, paddle.to_tensor(a, place="cpu",
                                                stop_gradient=False))
    card = _third_order(paddle, paddle.to_tensor(a, stop_gradient=False))
    third_err = max(_close_report(c, w, 1e-5, 0.0)[1]
                    for c, w in zip(card, cpu))
    if third_err > 1e-5:
        raise AssertionError(f"21d: third-order gradients off by "
                             f"{third_err:.3g}")
    # WGAN-GP
    d_in, d_h, d_out = GP_WIDTHS
    gen = torch.Generator().manual_seed(21)
    shapes = [(d_in, d_h), (d_h,), (d_h, d_out), (d_out,)]
    host = [torch.randn(s, generator=gen) * (1.0 / math.sqrt(s[0]))
            for s in shapes]
    real = torch.randn(GP_BATCH, d_in, generator=gen)
    fake = torch.randn(GP_BATCH, d_in, generator=gen)
    eps = torch.rand(GP_BATCH, 1, generator=gen)
    xhat = eps * real + (1 - eps) * fake
    sides = {}
    for where in ("cpu", dev):
        params = [h.to(where).requires_grad_() for h in host]
        x = xhat.to(where).requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sides[str(where)] = _gp_grads(paddle, F, params, x)
        torch.cuda.synchronize()
        sides[str(where) + "_s"] = time.perf_counter() - t0
    (g_cpu, pen_cpu), (g_card, pen_card) = sides["cpu"], sides[str(dev)]
    gp_card_s = sides[str(dev) + "_s"]
    gp_err = max(float((g - w).abs().max() / w.abs().max())
                 for g, w in zip(g_card, g_cpu))
    log(f"[21d] third-order gradients (4096 elements) on the card against "
        f"the CPU: worst err {third_err:.3g}; WGAN-GP (lambda {GP_LAMBDA}) "
        f"on a {'-'.join(map(str, GP_WIDTHS))} GELU MLP at batch "
        f"{GP_BATCH}: penalty {pen_card:.6f} (CPU {pen_cpu:.6f}), its "
        f"gradient's worst err {gp_err:.3g} of each tensor's largest "
        f"magnitude (tol {GP_GRAD_REL_TOL}); card "
        f"{sides[str(dev) + '_s']:.2f} s, CPU {sides['cpu_s']:.2f} s")
    if gp_err > GP_GRAD_REL_TOL:
        raise AssertionError("21d: the penalty's gradient on the card is "
                             "off the CPU's")
    # a straight-through estimator as a PyLayer against autograd of its
    # plain function

    class STE(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return torch.round(x)

        @staticmethod
        def backward(ctx, g):
            return g

    x0 = torch.randn(STE_SHAPE, device=dev) * 3
    w = torch.randn(STE_SHAPE[-1], 8, device=dev) / 64
    x1, x2 = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    (STE.apply(x1) @ w).tanh().sum().backward()
    ((x2 + (torch.round(x2) - x2).detach()) @ w).tanh().sum().backward()
    ste_same = bool(torch.equal(x1.grad, x2.grad))
    del x0, x1, x2
    # the third derivative through each kernel (create_graph at every
    # order) against its plain version's, differentiated by autograd
    x = torch.randn(64, 1024, device=dev, requires_grad=True)
    lw, lb = torch.randn(1024, device=dev), torch.randn(1024, device=dev)
    q = torch.randn(2, 128, 4, 64, device=dev, requires_grad=True)
    kb = padding_bias(2, 128, torch.Generator(device=dev).manual_seed(21),
                      dev)
    cases = (
        ("layer_norm", x, 3, lambda t: fused_layer_norm(t, lw, lb),
         lambda t: fused_ln_reference(t, lw, lb)),
        ("flash_attention", q, 3, lambda t: flash_attention_blhd(t, t, t)[0],
         lambda t: flash_reference(t, t, t, True)[0]),
        ("flash_attention_full", q, 3,
         lambda t: flash_attention_full(t, t, t, kb)[0],
         lambda t: flash_reference(t, t, t, False, kb)[0]))
    second = {}
    for kernel, t, order, fn, plain_fn in cases:
        sides = []
        for f in (fn, plain_fn):
            g = (f(t) ** 3).sum()
            for i in range(order):
                (g,) = paddle.grad(g, [t], create_graph=i + 1 < order)
                g_last = g
                g = (g ** 2).sum()
            sides.append(g_last.detach())
        second[kernel] = float((sides[0] - sides[1]).abs().max()
                               / sides[1].abs().max())
    log(f"[21d] PyLayer straight-through at {STE_SHAPE}: gradient the same "
        f"bits as autograd of its plain function: {ste_same}; third "
        f"derivatives through the kernels against their plain versions', "
        f"worst err of the largest magnitude: {second} (tol "
        f"{SECOND_ORDER_REL_TOL})")
    if not ste_same or max(second.values()) > SECOND_ORDER_REL_TOL:
        raise AssertionError("21d: the PyLayer or a kernel's higher "
                             "derivative failed")
    return {"third_order_err": third_err, "gp_err": gp_err,
            "gp_penalty": pen_card, "gp_card_s": gp_card_s,
            "ste_same_bits": ste_same, "kernel_higher_order_err": second}


def tensor_api_phase(dev, counted, launches, phase8, smi):
    """Phase 21: the tensor API, its path at full width, sampling with a
    replayed random state, and autograd."""
    out, seconds = {}, {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # f32 comparisons with the CPU: no TF32 (as main sets it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cleared(counted)
    out["breadth"] = tensor_breadth(dev)
    _read_launches(counted, launches, "tensor_breadth")
    lap("21a")
    model, ids, out["path"] = tensor_path(dev, counted, launches, phase8, smi)
    lap("21b")
    out["sampling"] = sampling_phase(model, ids)
    del model
    torch.cuda.empty_cache()
    lap("21c")
    out["autograd"] = autograd_phase(dev)
    torch.cuda.empty_cache()
    lap("21d")
    out["seconds"] = seconds
    log("[21] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


# -- phase 22: detection, CRF tagging and the hapi tail -----------------------
SSD_BATCH, SSD_SIZE, SSD_CLASSES = 8, 300, 21
# PaddleDetection ssd_mobilenet_v1_voc: after conv13, four pairs of a 1x1
# conv and a 3x3 stride-2 conv (10 -> 5 -> 3 -> 2 -> 1)
SSD_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))
SSD_HEAD = dict(base_size=300, min_ratio=20, max_ratio=90,
                aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                               [2.0, 3.0], [2.0, 3.0]],
                offset=0.5, flip=True, clip=True, kernel_size=3, pad=1)
SSD_NMS = dict(score_threshold=0.01, nms_top_k=400, keep_top_k=200,
               nms_threshold=0.45, background_label=0)
SSD_ITERS = 20  # timed batches of 22a
# the static head against the eager one: the same cuDNN convolutions
SSD_HEAD_ATOL = 1e-5
CRF_TAGS = 7  # MSRA-NER's BIO tags: B/I of PER, ORG, LOC and O
CRF_STEPS = 10
CRF_LENGTHS = (64, 128)
# f32 forward algorithm over 128 steps, card against CPU: the logsumexp
# kernels round differently. The costs are ~100s; a gradient is a sum of
# marginals exp(alpha + beta - log Z) whose exponents are differences of
# sums of ~100s (f32 spacing ~1.5e-5 there), so each gradient tensor is
# held relative to its largest value
CRF_LOSS_RTOL = 1e-5
CRF_GRAD_REL_TOL = 1e-4
FUSED_HEAD_STEPS = 5
# the fused head's mean is rounded to bf16 as the reference's is (phase
# 8's is an f32 mean of bf16 logits): two bf16 roundings
FUSED_HEAD_LOSS_RTOL = 2.0 ** -7
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((13, 32, (6, 7, 8)), (26, 16, (3, 4, 5)), (52, 8, (0, 1, 2)))
YOLO_NMS = dict(score_threshold=0.005, nms_top_k=1000, keep_top_k=100,
                nms_threshold=0.45, background_label=-1)
YOLO_BATCH = 8
# Faster R-CNN R50-C4: C4 features of an 800 x 1216 image, 512 RoIs an
# image, 14 x 14 RoIAlign at 1/16; R-FCN: 21 classes x 7 x 7 score maps,
# 300 RoIs an image; DCNv2 at ResNet-50's res5 3x3
ROI_FEAT, ROIS_PER_IMAGE = (2, 1024, 50, 76), 512
PSROI_FEAT, PSROIS_PER_IMAGE = (2, 1029, 50, 76), 300
DCN_X = (2, 512, 25, 38)
# the CPU recomputes these many images / RoIs of the card's full call
OPS_CPU_IMAGES, OPS_CPU_ROIS = 2, 128
# f32 card against CPU (TF32 off): other summation orders and atomics.
# A gradient sums many terms (with cancellation: box_coder's 1/w^2), so it
# is held relative to its tensor's largest value
OPS_RTOL, OPS_ATOL = 1e-4, 1e-4
OPS_GRAD_REL_TOL = 1e-4
# the integers tests/test_torch_hapi_tail.py holds against the reference
FLOPS_WANT = {"LeNet": 347560, "resnet50": 4111514624,
              "mobilenet_v1": 578876928}


class SSDMobileNet(torch.nn.Module):
    """SSD-MobileNet-v1 (PaddleDetection ``ssd_mobilenet_v1_voc``): the
    port's MobileNetV1 (scale 1) to conv11 (19x19x512) and conv13
    (10x10x1024), the four extra pairs, and a 3x3 loc conv (4 a prior)
    and conf conv (``classes`` a prior) on each of the six maps.
    ``forward(images)`` gives (locs [N, P, 4], confs [N, P, classes])."""

    def __init__(self, classes=SSD_CLASSES, seed=0, device=None):
        super().__init__()
        from paddle_tpu_torch.nn import Conv2D
        from paddle_tpu_torch.vision.models.mobilenet import (ConvBNLayer,
                                                              MobileNetV1)
        from paddle_tpu_torch.vision.ops import _expand_aspect_ratios

        body = MobileNetV1(scale=1.0, num_classes=0, with_pool=False,
                           seed=seed, device=device)
        blocks = list(body.blocks)
        self.conv11 = torch.nn.Sequential(body.conv1, *blocks[:11])
        self.conv13 = torch.nn.Sequential(*blocks[11:])
        gen = torch.Generator().manual_seed(seed + 1)
        extras, c = [], 1024
        for c1, c2 in SSD_EXTRAS:
            extras.append(torch.nn.Sequential(
                ConvBNLayer(c, c1, 1, generator=gen),
                ConvBNLayer(c1, c2, 3, 2, 1, generator=gen)))
            c = c2
        self.extras = torch.nn.ModuleList(extras)
        chans = [512, 1024] + [c2 for _, c2 in SSD_EXTRAS]
        # a map's priors a cell: its aspect ratios, then the max-size box
        priors_per_map = [len(_expand_aspect_ratios(ar, SSD_HEAD["flip"]))
                          + 1 for ar in SSD_HEAD["aspect_ratios"]]
        self.classes = classes
        self.loc = torch.nn.ModuleList(
            Conv2D(ci, p * 4, 3, padding=1, generator=gen)
            for ci, p in zip(chans, priors_per_map))
        self.conf = torch.nn.ModuleList(
            Conv2D(ci, p * classes, 3, padding=1, generator=gen)
            for ci, p in zip(chans, priors_per_map))
        self.to(device)

    def features(self, x):
        feats = [self.conv11(x)]
        feats.append(self.conv13(feats[0]))
        for e in self.extras:
            feats.append(e(feats[-1]))
        return feats

    def forward(self, x):
        feats = self.features(x)
        n = x.shape[0]
        locs = [l(f).permute(0, 2, 3, 1).reshape(n, -1, 4)
                for l, f in zip(self.loc, feats)]
        confs = [c(f).permute(0, 2, 3, 1).reshape(n, -1, self.classes)
                 for c, f in zip(self.conf, feats)]
        return torch.cat(locs, 1), torch.cat(confs, 1)


def ssd_priors(feats, image):
    """The head's priors and variances [P, 4] (``multi_box_head``'s size
    schedule) and the priors a cell of each map."""
    from paddle_tpu_torch.static.nn import _ssd_sizes
    from paddle_tpu_torch.vision.ops import prior_box

    mins, maxs = _ssd_sizes(len(feats), SSD_HEAD["base_size"],
                            SSD_HEAD["min_ratio"], SSD_HEAD["max_ratio"])
    boxes, variances, per_map = [], [], []
    for f, lo, hi, ar in zip(feats, mins, maxs, SSD_HEAD["aspect_ratios"]):
        b, v = prior_box(f, image, min_sizes=[lo], max_sizes=[hi],
                         aspect_ratios=ar, flip=SSD_HEAD["flip"],
                         clip=SSD_HEAD["clip"], offset=SSD_HEAD["offset"])
        per_map.append(int(b.shape[2]))
        boxes.append(b.reshape(-1, 4))
        variances.append(v.reshape(-1, 4))
    return torch.cat(boxes), torch.cat(variances), per_map


def ssd_postprocess(locs, confs, prior, var):
    """Decoded boxes, class scores [N, C, P] and the NMS block."""
    from paddle_tpu_torch.vision.ops import box_coder, multiclass_nms

    boxes = box_coder(prior, var, locs, code_type="decode_center_size")
    scores = torch.softmax(confs, dim=-1).transpose(1, 2)
    out, counts = multiclass_nms(boxes, scores, **SSD_NMS)
    return boxes, scores, out, counts


def ssd_ground_truths(n, seed=22, detections=None):
    """2-6 boxes an image, labels 1..20, normalized corners; with
    ``detections`` (an NMS block on the host), rows of it moved by up to
    2% instead, so that some detections match."""
    r = np.random.RandomState(seed)
    gts = []
    for i in range(n):
        k = r.randint(2, 7)
        if detections is None:
            xy = r.rand(k, 2) * 0.7
            box = np.concatenate([xy, xy + r.rand(k, 2) * 0.25 + 0.05], 1)
            label = r.randint(1, SSD_CLASSES, (k, 1))
        else:
            rows = detections[i][r.choice(int((detections[i][:, 0] >= 0)
                                              .sum()), k, replace=False)]
            label = rows[:, :1]
            box = rows[:, 2:] + r.uniform(-0.02, 0.02, (k, 4))
        gts.append(np.concatenate([label, box], 1).astype(np.float32))
    return gts


@contextlib.contextmanager
def no_host_sync():
    """Turn a synchronizing CUDA call into an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def ssd_phase(dev, counted, launches, smi):
    """22a: SSD-MobileNet-v1 on VOC served at 8 x 3 x 300 x 300, the
    static head, NMS and mAP against the CPU, no host sync."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.metric import DetectionMAP
    from paddle_tpu_torch.vision.ops import multiclass_nms

    gen = torch.Generator(device=dev).manual_seed(22)
    images = torch.rand(SSD_BATCH, 3, SSD_SIZE, SSD_SIZE, device=dev,
                        generator=gen)
    model = SSDMobileNet(device=dev).eval()
    with torch.no_grad():
        feats = model.features(images[:1])
    prior, var, per_map = ssd_priors(feats, images)
    log(f"[22a] SSD-MobileNet-v1 priors a cell {per_map} on maps "
        f"{[tuple(f.shape[2:]) for f in feats]}: {prior.shape[0]} priors")

    def serve(x):
        with torch.no_grad():
            locs, confs = model(x)
            return ssd_postprocess(locs, confs, prior, var)

    for _ in range(3):
        serve(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    _, batch_ms, wall = timed_steps(serve, (images,), SSD_ITERS)
    got = _read_launches(counted, launches, "ssd_serve")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step("22a", serve, (images,))
    with torch.no_grad():
        locs, confs = model(images)
        boxes, scores, out, counts = ssd_postprocess(locs, confs, prior, var)
    nms_prof = profile_step("22a nms", lambda b, s: multiclass_nms(
        b, s, **SSD_NMS), (boxes, scores), top=4)
    # decoding and NMS read nothing back to the host
    with no_host_sync():
        ssd_postprocess(locs, confs, prior, var)
    # NMS on the CPU over the card's decoded boxes and scores
    cpu_out, cpu_counts = multiclass_nms(boxes.cpu(), scores.cpu(),
                                         **SSD_NMS)
    same_block = bool(torch.equal(out.cpu(), cpu_out)
                      and torch.equal(counts.cpu(), cpu_counts))
    maps = []
    for gts in (ssd_ground_truths(SSD_BATCH),
                ssd_ground_truths(SSD_BATCH, detections=cpu_out.numpy())):
        for block in (out, cpu_out):
            m = DetectionMAP(overlap_threshold=0.5, ap_type="11point")
            for i in range(SSD_BATCH):
                m.update(block[i], gts[i])
            maps.append(m.accumulate())
    # the head as a Program, on the eager head's parameters
    main = static.Program()
    with static.program_guard(main):
        fvars = [static.data(f"f{i}", [SSD_BATCH, *f.shape[1:]], "float32",
                             device=dev) for i, f in enumerate(feats)]
        img = static.data("image", list(images.shape), "float32",
                          device=dev)
        outs = static.nn.multi_box_head(fvars, img, num_classes=SSD_CLASSES,
                                        **SSD_HEAD)
    params = main.all_parameters()
    eager = [t for l, c in zip(model.loc, model.conf)
             for t in (l.weight, l.bias, c.weight, c.bias)]
    with torch.no_grad():
        for p, q in zip(params, eager):
            p.copy_(q)
        feats = model.features(images)
    s_locs, s_confs, s_prior, s_var = static.Executor(
        static.CUDAPlace(0)).run(
        main, feed={**{f"f{i}": f for i, f in enumerate(feats)},
                    "image": images},
        fetch_list=list(outs), return_numpy=False)
    head_err = max(float((s_locs - locs).abs().max()),
                   float((s_confs - confs).abs().max()))
    prior_bits = bool(torch.equal(s_prior, prior) and torch.equal(s_var, var))
    res = {"images_per_s": SSD_BATCH * SSD_ITERS / wall,
           "batch_ms_p50": batch_ms[SSD_ITERS // 2],
           "batch_ms_min": batch_ms[0], "batch_ms_max": batch_ms[-1],
           "device_ms_per_batch": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"],
           "nms_device_ms": nms_prof["device_ms_per_step"],
           "nms_share": nms_prof["device_ms_per_step"]
           / prof["device_ms_per_step"],
           "peak_memory_bytes": peak, "priors": int(prior.shape[0]),
           "detections": [int(c) for c in counts.cpu()],
           "map_11point": maps[0], "map_cpu": maps[1],
           "map_11point_matched": maps[2], "map_cpu_matched": maps[3],
           "nms_same_as_cpu": same_block, "static_head_err": head_err,
           "static_priors_same_bits": prior_bits, "launches": got,
           "card": smi}
    log(f"[22a] served {SSD_ITERS} batches of {SSD_BATCH} x 3 x {SSD_SIZE}"
        f" x {SSD_SIZE}: {res['images_per_s']:.1f} images/s, batch p50 "
        f"{res['batch_ms_p50']:.2f} ms, device "
        f"{res['device_ms_per_batch']:.2f} ms a batch (busy share {res['busy_share']:.4f}), NMS device "
        f"{res['nms_device_ms']:.2f} ms ({res['nms_share']:.3f} of the "
        f"batch's), peak memory {peak / 2**30:.2f} GiB; detections "
        f"{res['detections']}; NMS block same as the CPU's {same_block}; "
        f"mAP (11point) {maps[0]:.6f} card, {maps[1]:.6f} CPU (ground truths"
        f" near detections: {maps[2]:.6f}, {maps[3]:.6f}); static head "
        f"err {head_err:.3g} (atol {SSD_HEAD_ATOL}), static priors same "
        f"bits {prior_bits}; launches {got}")
    if not (same_block and maps[0] == maps[1] and maps[2] == maps[3] > 0
            and prior_bits):
        raise AssertionError("22a: the card's detections or priors differ "
                             "from the CPU's / prior_box's")
    if head_err > SSD_HEAD_ATOL:
        raise AssertionError("22a: the static head disagrees with the eager")
    if not bool(torch.isfinite(out).all()) or out.shape != (
            SSD_BATCH, SSD_NMS["keep_top_k"], 6):
        raise AssertionError(f"22a: bad detections {tuple(out.shape)}")
    return res, model, images


class BertCRFTagger(torch.nn.Module):
    """BERT-base, ``Linear(768, 7)`` and a linear-chain CRF over a [9, 7]
    transition. The emissions and the transition go to the CRF in f32 (a
    bf16 step casts both), so the 127 dependent steps of the recursion sum
    in f32. ``forward`` returns the mean CRF cost."""

    def __init__(self, bert_mod, cfg, dev, seed=0):
        super().__init__()
        from paddle_tpu_torch.nn.layer.common import Linear

        self.bert = bert_mod.BertModel(cfg, device=dev, seed=seed)
        self.cls = Linear(cfg.hidden_size, CRF_TAGS, device=dev)
        gen = torch.Generator().manual_seed(seed)
        self.transition = torch.nn.Parameter(
            (torch.randn(CRF_TAGS + 2, CRF_TAGS, generator=gen) * 0.1).to(dev))

    def emissions(self, ids, types, mask):
        return self.cls(self.bert(ids, types, mask)[0]).float()

    def forward(self, ids, types, mask, labels, lengths):
        from paddle_tpu_torch.text.crf import linear_chain_crf

        return linear_chain_crf(self.emissions(ids, types, mask), labels,
                                self.transition.float(), lengths).mean()


def crf_batch(cfg, dev, seed=22):
    """A tagged batch shaped as MSRA-NER's: tags O (0), B-/I-PER (1, 2),
    B-/I-ORG (3, 4), B-/I-LOC (5, 6); entity spans of 1-4 tokens start at
    a token with probability 0.08, and an entity's tokens come from its
    type's own range of the vocabulary (the others from the rest), so the
    tags can be learned from the tokens and the transitions."""
    r = np.random.RandomState(seed)
    b, s = BERT_SHAPE
    v, w = cfg.vocab_size, cfg.vocab_size // 16
    ranges = [(w, v // 2)] + [(v // 2 + k * w, v // 2 + (k + 1) * w)
                              for k in range(3)]
    lengths = r.randint(CRF_LENGTHS[0], CRF_LENGTHS[1] + 1, b)
    ids = np.zeros((b, s), np.int64)
    labels = np.zeros((b, s), np.int64)
    for i in range(b):
        t = 0
        while t < lengths[i]:
            if r.rand() < 0.08:
                k = r.randint(3)
                n = min(r.randint(1, 5), lengths[i] - t)
                labels[i, t:t + n] = [2 * k + 1] + [2 * k + 2] * (n - 1)
                ids[i, t:t + n] = r.randint(*ranges[k + 1], n)
                t += n
            else:
                ids[i, t] = r.randint(*ranges[0])
                t += 1
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int64)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        ids, np.zeros_like(ids), mask, labels, lengths))


def crf_checks(model, batch):
    """The CRF on the trained model's emissions, card against CPU."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.text import viterbi_decode
    from paddle_tpu_torch.text.crf import crf_decoding, linear_chain_crf

    ids, types, mask, labels, lengths = batch
    with torch.no_grad():
        em = model.emissions(ids, types, mask)
    trans = model.transition.detach().float()
    res = {}
    outs = {}
    for where in ("card", "cpu"):
        d = em.device if where == "card" else torch.device("cpu")
        e = em.to(d).clone().requires_grad_()
        t = trans.to(d).clone().requires_grad_()
        lb, ln = labels.to(d), lengths.to(d)
        ctx = no_host_sync() if where == "card" else contextlib.nullcontext()
        with ctx:
            cost = linear_chain_crf(e, lb, t, ln)
            cost.sum().backward()
            path = crf_decoding(e, t, length=ln)
            ok = crf_decoding(e, t, label=lb, length=ln)
            vs, vp = viterbi_decode(e.detach(), t.detach()[2:])
        outs[where] = [x.detach().cpu() for x in (cost, e.grad, t.grad, path,
                                                  ok, vs, vp)]
    card, cpu = outs["card"], outs["cpu"]
    res["loss_rel_err"] = float(((card[0] - cpu[0]).abs()
                                 / cpu[0].abs()).max())
    res["grad_em_rel_err"] = max_rel(card[1], cpu[1])
    res["grad_trans_rel_err"] = max_rel(card[2], cpu[2])
    res["paths_equal"] = bool(torch.equal(card[3], cpu[3]))
    res["label_mask_equal"] = bool(torch.equal(card[4], cpu[4]))
    res["viterbi_paths_equal"] = bool(torch.equal(card[6], cpu[6]))
    res["viterbi_score_rel_err"] = float(((card[5] - cpu[5]).abs()
                                          / cpu[5].abs()).max())
    main = static.Program()
    with static.program_guard(main):
        x = static.data("em", list(em.shape), "float32", device=em.device)
        n = static.data("n", list(lengths.shape), "int64", device=em.device)
        out = static.nn.crf_decoding(x, model.transition, length=n)
    s_path, = static.Executor(static.CUDAPlace(0)).run(
        main, feed={"em": em, "n": lengths}, fetch_list=[out],
        return_numpy=False)
    res["static_paths_equal"] = bool(torch.equal(s_path.cpu(), cpu[3]))
    res["tagged_share"] = float(card[4].sum() / lengths.sum().cpu())
    return res


def bert_crf_phase(dev, counted, launches, bert_mod, phase10, smi):
    """22b: BERT-base-CRF (MSRA-NER's 7 tags) trained at phase 10's shape
    with bf16 compute and AdamW, then the CRF against the CPU."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_mod.bert_base()
    model = BertCRFTagger(bert_mod, cfg, dev, seed=22)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    step = ParallelTrainStep(model, lambda out, *_: out, opt,
                             compute_dtype=torch.bfloat16)
    batch = crf_batch(cfg, dev)
    train = lambda *b: step(b, (b[3],))
    first = [train(*batch) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    n = CRF_STEPS - 2
    losses, step_ms, wall = timed_steps(train, batch, n)
    got = _read_launches(counted, launches, "bert_crf")
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    # BertModel has no MLM head: one LayerNorm fewer than phase 10's model
    n_ln = 2 * layers + 1
    want = {"layer_norm_fwd": n_ln * n, "layer_norm_bwd": 2 * n_ln * n,
            "flash_attn_fwd_full": layers * n,
            "flash_attn_bwd_dq_full": layers * n,
            "flash_attn_bwd_dkv_full": layers * n, "adam": 2 * n}
    prof = profile_step("22b", train, batch)
    losses = [float(x) for x in first + losses]
    b = BERT_SHAPE[0]
    res = {"samples_per_s": b * n / wall, "step_ms_p50": step_ms[n // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "device_ms_per_step": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"],
           "launches_per_step": prof["launches_per_step"],
           "peak_memory_bytes": peak, "losses": losses,
           "lengths": [int(x) for x in batch[4].cpu()], "launches": got,
           "card": smi}
    res["crf"] = crf_checks(model, batch)
    log(f"[22b] BERT-base-CRF bf16 + AdamW at {BERT_SHAPE} (lengths "
        f"{CRF_LENGTHS[0]}-{CRF_LENGTHS[1]}): {res['samples_per_s']:.1f} "
        f"samples/s (phase 10 {phase10['samples_per_s']:.1f}), step p50 "
        f"{res['step_ms_p50']:.2f} ms (phase 10 {phase10['step_ms_p50']:.2f}"
        f"), device {res['device_ms_per_step']:.2f} ms a step (phase 10 "
        f"{phase10.get('device_ms_per_step') or float('nan'):.2f}), busy "
        f"share {res['busy_share']:.4f} (phase 10 "
        f"{phase10.get('busy_share') or float('nan'):.4f}), "
        f"{res['launches_per_step']:.0f} device ops a step, peak memory "
        f"{peak / 2**30:.2f} GiB (phase 10 "
        f"{phase10['peak_memory_bytes'] / 2**30:.2f}); loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; launches {got}")
    log(f"[22b] CRF on the trained emissions, card against CPU: {res['crf']}"
        f" (loss rtol {CRF_LOSS_RTOL}, gradients {CRF_GRAD_REL_TOL} of "
        "their largest value)")
    c = res["crf"]
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"22b launched {got}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"22b: the loss did not fall: {losses}")
    if not (c["loss_rel_err"] <= CRF_LOSS_RTOL
            and max(c["grad_em_rel_err"], c["grad_trans_rel_err"])
            <= CRF_GRAD_REL_TOL
            and c["viterbi_score_rel_err"] <= CRF_LOSS_RTOL
            and c["paths_equal"] and c["label_mask_equal"]
            and c["viterbi_paths_equal"] and c["static_paths_equal"]):
        raise AssertionError("22b: the CRF on the card disagrees with the "
                             "CPU")
    del step, model, opt
    torch.cuda.empty_cache()
    return res


def _device_time(fn, what):
    """(ms, source) of one call of ``fn``: its kernels' time from the
    profiler, else (a session that records no device operation, as the
    profiler now and then gives late in the script) CUDA events over
    back-to-back calls, which also count the launch gaps."""
    try:
        return device_ms(fn, what, iters=3, attempts=3), "profiler"
    except RuntimeError as e:
        log(f"[22c] {e}; timing with CUDA events instead")
        return time_ms(fn, iters=3, warmup=1), "events"


def _ops_compare(name, fn, args, grad, cpu_args=None, cpu_rows=None):
    """``fn`` on the card's ``args`` against the CPU's: the worst error of
    the output (rows ``cpu_rows`` of it, which ``cpu_args`` give on the
    CPU) and, for the positions ``grad``, of the gradients for one
    cotangent (the full call on both sides); the device time of a call
    (and of a forward and backward)."""
    def run(a, with_grad):
        a = [t.detach().requires_grad_(i in grad and with_grad)
             if isinstance(t, torch.Tensor) and t.is_floating_point() else t
             for i, t in enumerate(a)]
        out = fn(*a)
        out = out[0] if isinstance(out, tuple) else out
        if not with_grad:
            return out.detach(), []
        ct = torch.linspace(0.5, 1.5, out.numel(), device=out.device
                            ).reshape(out.shape)
        (out * ct).sum().backward()
        return out.detach(), [a[i].grad for i in grad]

    out, _ = run(args, False)
    cpu = [t.cpu() if isinstance(t, torch.Tensor) else t
           for t in (cpu_args or args)]
    ref, _ = run(cpu, False)
    got = out[cpu_rows].cpu() if cpu_rows is not None else out.cpu()
    errs = {"out": float((got - ref).abs().max())}
    ok = bool(((got - ref).abs() <= OPS_ATOL + OPS_RTOL * ref.abs()).all())
    if grad:
        _, g_card = run(args, True)
        _, g_cpu = run([t.cpu() if isinstance(t, torch.Tensor) else t
                        for t in args], True)
        for i, a, b in zip(grad, g_card, g_cpu):
            errs[f"grad{i}"] = max_rel(a.cpu(), b)
            ok &= errs[f"grad{i}"] <= OPS_GRAD_REL_TOL
    res = {"err": errs, "ok": ok}
    res["device_ms"], res["timed_by"] = _device_time(
        lambda: run(args, False), name)
    if grad:
        res["fwd_bwd_device_ms"], res["fwd_bwd_timed_by"] = _device_time(
            lambda: run(args, True), name + " fwd+bwd")
    log(f"[22c] {name}: worst err {errs} (output: rtol {OPS_RTOL}, atol "
        f"{OPS_ATOL}; gradients: {OPS_GRAD_REL_TOL} of their largest value)"
        f"; device {res['device_ms']:.3f} ms ({res['timed_by']})"
        + (f", forward + backward {res['fwd_bwd_device_ms']:.3f} ms "
           f"({res['fwd_bwd_timed_by']})" if grad else ""))
    if not ok:
        raise AssertionError(f"22c: {name} disagrees with the CPU")
    return res


def vision_ops_phase(dev):
    """22c: the rest of ``vision.ops`` at published shapes, card against
    CPU."""
    from paddle_tpu_torch.vision import ops as V

    gen = torch.Generator().manual_seed(23)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen)
                                 * scale).to(dev)
    res = {}
    # YOLOv3-416's three heads, 80 classes, then NMS over the 10647 boxes
    img = torch.full((YOLO_BATCH, 2), 416, dtype=torch.int32, device=dev)
    heads = []
    for size, ratio, mask in YOLO_HEADS:
        x = rnd(YOLO_BATCH, 255, size, size)
        anchors = [YOLO_ANCHORS[2 * m + k] for m in mask for k in (0, 1)]
        kw = dict(anchors=anchors, class_num=80, conf_thresh=0.005,
                  downsample_ratio=ratio)
        res[f"yolo_box_{size}"] = _ops_compare(
            f"yolo_box {list(x.shape)}", lambda a, i, kw=kw: torch.cat(
                V.yolo_box(a, i, **kw), -1), [x, img], ())
        heads.append(V.yolo_box(x, img, **kw))
    boxes = torch.cat([h[0] for h in heads], 1)
    scores = torch.cat([h[1] for h in heads], 1).transpose(1, 2).contiguous()
    with no_host_sync():
        out, counts = V.multiclass_nms(boxes, scores, **YOLO_NMS)
    k = OPS_CPU_IMAGES
    cpu_out, cpu_counts = V.multiclass_nms(boxes[:k].cpu(), scores[:k].cpu(),
                                           **YOLO_NMS)
    same = bool(torch.equal(out[:k].cpu(), cpu_out)
                and torch.equal(counts[:k].cpu(), cpu_counts))
    res["yolo_nms"] = {"same_as_cpu": same, "counts": counts.tolist()}
    res["yolo_nms"]["device_ms"], res["yolo_nms"]["timed_by"] = _device_time(
        lambda: V.multiclass_nms(boxes, scores, **YOLO_NMS), "yolo nms")
    log(f"[22c] multiclass_nms over YOLOv3-416's {boxes.shape[1]} boxes x 80"
        f" classes (top 1000, keep 100): images 0-{k - 1} the CPU's block "
        f"{same}; counts {res['yolo_nms']['counts']}; device "
        f"{res['yolo_nms']['device_ms']:.2f} ms "
        f"({res['yolo_nms']['timed_by']})")
    if not same:
        raise AssertionError("22c: YOLO NMS differs from the CPU's")
    del heads, boxes, scores
    # R50-C4's RoIAlign; the CPU recomputes the first RoIs of each image
    feat = rnd(*ROI_FEAT)
    n_img, per = ROI_FEAT[0], ROIS_PER_IMAGE
    scale = 1 / 16
    h, w = ROI_FEAT[2] / scale, ROI_FEAT[3] / scale

    def rois(count):
        xy = torch.rand(count, 2, generator=gen) * torch.tensor([w, h])
        wh = torch.rand(count, 2, generator=gen) * 300 + 8
        return torch.cat([xy, xy + wh], 1).to(dev)

    r = rois(n_img * per)
    num = torch.full((n_img,), per, device=dev)
    k = OPS_CPU_ROIS // n_img
    rows = torch.cat([i * per + torch.arange(k) for i in range(n_img)])
    sub = r[rows.to(dev)]
    sub_num = torch.full((n_img,), k)
    ra = lambda f, b, n: V.roi_align(f, b, 14, spatial_scale=scale,
                                     boxes_num=n)
    res["roi_align"] = _ops_compare(
        f"roi_align {list(ROI_FEAT)} x {n_img * per} RoIs -> 14", ra,
        [feat, r, num], (), cpu_args=[feat, sub, sub_num], cpu_rows=rows)
    res["roi_align_grad"] = _ops_compare(
        f"roi_align gradient over {OPS_CPU_ROIS} RoIs", ra,
        [feat, sub, sub_num.to(dev)], (0, 1))
    del feat
    # R-FCN's position-sensitive pooling
    x = rnd(*PSROI_FEAT)
    n_img, per = PSROI_FEAT[0], PSROIS_PER_IMAGE
    r = rois(n_img * per)
    res["psroi_pool"] = _ops_compare(
        f"psroi_pool {list(PSROI_FEAT)} x {n_img * per} RoIs -> 7",
        lambda a, b: V.psroi_pool(a, b, torch.full(
            (n_img,), per, device=a.device), 7, scale), [x, r], (0,))
    del x
    # DCNv2 at ResNet-50's res5 3x3
    n, c, hh, ww = DCN_X
    x = rnd(*DCN_X)
    off = rnd(n, 18, hh, ww, scale=2.0)
    m = torch.sigmoid(rnd(n, 9, hh, ww))
    wt = rnd(c, c, 3, 3, scale=0.02)
    res["deform_conv2d"] = _ops_compare(
        f"deform_conv2d v2 {list(DCN_X)} -> {c}", lambda a, o, w_, mk: (
            V.deform_conv2d(a, o, w_, padding=1, mask=mk)),
        [x, off, wt, m], (0, 1, 2, 3))
    # the rest at SSD's and ResNet's shapes
    f19 = torch.zeros(1, 1, 19, 19, device=dev)
    image = torch.zeros(1, 3, 300, 300, device=dev)
    res["prior_box"] = _ops_compare(
        "prior_box 19 x 19 (60, 111)", lambda f, i: V.prior_box(
            f, i, [60.0], [111.0], [2.0, 3.0], flip=True, clip=True),
        [f19, image], ())
    prior = torch.sort(torch.rand(2278, 4, generator=gen), 1).values.to(dev)
    gt = torch.sort(torch.rand(64, 4, generator=gen), 1).values.to(dev)
    res["box_coder_encode"] = _ops_compare(
        "box_coder encode 64 x 2278", lambda p, t: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], t), [prior, gt], (0, 1))
    res["box_coder_decode"] = _ops_compare(
        "box_coder decode 8 x 2278", lambda p, t: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], t, code_type="decode_center_size"),
        [prior, rnd(8, 2278, 4, scale=0.5)], (0, 1))
    res["iou_similarity"] = _ops_compare(
        "iou_similarity 64 x 2278", V.iou_similarity, [gt, prior], (0, 1))
    res["spp"] = _ops_compare("spp [8, 256, 13, 13] height 3", lambda a: (
        V.spp(a, 3)), [rnd(8, 256, 13, 13)], (0,))
    res["space_to_depth_stem_conv"] = _ops_compare(
        "space_to_depth_stem_conv [8, 3, 224, 224] -> 64",
        V.space_to_depth_stem_conv,
        [rnd(8, 3, 224, 224), rnd(64, 3, 7, 7, scale=0.1)], (0, 1))
    return res


def fused_head_phase(dev, counted, launches, gpt_mod, phase8, smi):
    """22d: GPT-2 345M at bench.py's shape with ``fused_head_ce=True``."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import Adam

    cfg = gpt_mod.gpt2_medium(hidden_dropout=0.0, attention_dropout=0.0)
    g = torch.Generator(device=dev).manual_seed(24)
    ids = torch.randint(0, cfg.vocab_size, TRAIN_SHAPE, device=dev,
                        generator=g)
    labels = torch.roll(ids, -1, dims=1)
    ref_loss = _engine_step1_loss(gpt_mod, ids, labels)
    cfg.fused_head_ce = True
    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.float32, seed=4)
    opt = Adam(TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt,
                             compute_dtype=torch.bfloat16)
    train = lambda i, l: step((i, l), (l,))
    torch.cuda.reset_peak_memory_stats()
    first = train(ids, labels).detach().float().cpu()
    rel = float((first - ref_loss).abs() / ref_loss.abs())
    warm = [train(ids, labels)]
    torch.cuda.synchronize()
    _cleared(counted)
    n = FUSED_HEAD_STEPS - 2
    losses, step_ms, wall = timed_steps(train, (ids, labels), n)
    got = _read_launches(counted, launches, "gpt_fused_head")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step("22d", train, (ids, labels))
    n_ln = 2 * cfg.num_layers + 1
    want = {"layer_norm_fwd": n_ln * n, "layer_norm_bwd": 2 * n_ln * n,
            "flash_attn_fwd": cfg.num_layers * n,
            "flash_attn_bwd_dq": cfg.num_layers * n,
            "flash_attn_bwd_dkv": cfg.num_layers * n, "adam": 2 * n}
    losses = [float(x) for x in [first] + warm + losses]
    p8 = phase8.get("profile") or {}
    res = {"tokens_per_s": TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * n / wall,
           "step_ms_p50": step_ms[n // 2], "step_ms_min": step_ms[0],
           "step_ms_max": step_ms[-1],
           "device_ms_per_step": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"], "peak_memory_bytes": peak,
           "losses": losses, "step1_loss": float(first),
           "step1_loss_phase8": float(ref_loss), "step1_rel_diff": rel,
           "launches": got, "card": smi}
    log(f"[22d] GPT-2 345M with fused_head_ce at {TRAIN_SHAPE}: step 1's "
        f"loss {float(first):.6f} against phase 8's path on the same weights"
        f" and batch {float(ref_loss):.6f}, relative diff {rel:.3g} (tol "
        f"{FUSED_HEAD_LOSS_RTOL:.3g}); {res['tokens_per_s']:.1f} tokens/s "
        f"(phase 8 {phase8['tokens_per_s']:.1f}), step p50 "
        f"{res['step_ms_p50']:.2f} ms (phase 8 {phase8['step_ms_p50']:.2f}),"
        f" device {res['device_ms_per_step']:.2f} ms a step (phase 8 "
        f"{p8.get('device_ms_per_step', float('nan')):.2f}), peak memory "
        f"{peak / 2**30:.2f} GiB (phase 8 "
        f"{phase8['peak_memory_bytes'] / 2**30:.2f}); losses {losses}; "
        f"launches {got}")
    if rel > FUSED_HEAD_LOSS_RTOL:
        raise AssertionError("22d: step 1's loss is off phase 8's")
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"22d launched {got}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"22d: the loss did not fall: {losses}")
    del step, model, opt
    torch.cuda.empty_cache()
    return res


HUBCONF = '''
def ssd_mobilenet_v1_voc(seed=0, device="cuda"):
    """SSD-MobileNet-v1 on VOC (chip_smoke.SSDMobileNet)."""
    import chip_smoke

    return chip_smoke.SSDMobileNet(seed=seed, device=device).eval()
'''


def hapi_tail_phase(dev, ssd_model, images, workdir):
    """22e: flops on the card, hub.load of the 22a model, encryption at
    rest and the image loader (or the errors that name their packages)."""
    import importlib.util

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.framework import io_crypto
    from paddle_tpu_torch.vision import image as vimage
    from paddle_tpu_torch.vision import models as vmodels

    res = {"flops": {}}
    for name, shape in (("LeNet", [1, 1, 28, 28]),
                        ("resnet50", [1, 3, 224, 224]),
                        ("mobilenet_v1", [1, 3, 224, 224])):
        res["flops"][name] = ptt.flops(getattr(vmodels, name)(device=dev),
                                       shape)
    log(f"[22e] flops on the card: {res['flops']} (the reference's "
        f"{FLOPS_WANT})")
    if res["flops"] != FLOPS_WANT:
        raise AssertionError("22e: flops differ from the reference's")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "hubconf.py"), "w") as f:
        f.write(HUBCONF)
    hub_model = ptt.hub.load(workdir, "ssd_mobilenet_v1_voc",
                             device=images.device)
    with torch.no_grad():
        want = ssd_model(images)
        got = hub_model(images)
    res["hub_same_bits"] = all(torch.equal(a, b) for a, b in zip(got, want))
    res["hub_list"] = ptt.hub.list(workdir)
    del hub_model
    crypto = importlib.util.find_spec("cryptography") is not None
    key = bytes(range(32))
    if crypto:
        path = os.path.join(workdir, "ssd.pdparams")
        state = ssd_model.state_dict()
        ptt.save(state, path, cipher_key=key)
        back = ptt.load(path, cipher_key=key)
        res["encrypted_state_same_bits"] = all(
            torch.equal(back[k], v.cpu()) for k, v in state.items())
        plain = os.path.join(workdir, "ssd")
        jit.save(ssd_model, plain, input_spec=[jit.InputSpec(
            list(images.shape), "float32", "image")])
        secret = os.path.join(workdir, "ssd_secret")
        with open(plain + ".pdexport", "rb") as f:
            io_crypto.AESCipher(key).encrypt_to_file(f.read(),
                                                     secret + ".pdexport")
        outs = []
        for prefix in (plain, secret):
            cfg = inference.Config(prefix)
            if prefix == secret:
                cfg.set_cipher_key(key)
            outs.append(inference.create_predictor(cfg).run(
                [images.cpu().numpy()]))
        res["encrypted_export_same_bits"] = all(
            np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(*outs))
        branch = "cryptography present: encrypted round trips"
        ok = res["encrypted_state_same_bits"] and \
            res["encrypted_export_same_bits"]
    else:
        try:
            io_crypto.AESCipher(key)
            ok = False
        except ImportError as e:
            ok = "cryptography" in str(e)
            res["crypto_error"] = str(e)
        branch = "cryptography missing: the port names it"
    res["crypto_branch"] = branch
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        arr = (np.arange(6 * 7 * 3) % 251).astype(np.uint8).reshape(6, 7, 3)
        p = os.path.join(workdir, "im.png")
        Image.fromarray(arr).save(p)
        res["image_branch"] = "PIL present: image_load decodes"
        img_ok = np.array_equal(vimage.image_load(p, "tensor").numpy(), arr)
    else:
        try:
            vimage.image_load(os.path.join(workdir, "im.png"))
            img_ok = False
        except ImportError as e:
            img_ok = "PIL" in str(e)
            res["image_error"] = str(e)
        res["image_branch"] = "PIL missing: the port names it"
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[22e] hub.load of {res['hub_list']}: the 22a model's bits "
        f"{res['hub_same_bits']}; {branch} ({ok}); {res['image_branch']} "
        f"({img_ok})")
    if not (res["hub_same_bits"] and ok and img_ok):
        raise AssertionError("22e: the hapi tail failed")
    return res


def detection_crf_phase(dev, counted, launches, phase8, phase10, smi):
    """Phase 22: detection serving, CRF tagging, the rest of vision.ops,
    GPT's fused head and the hapi tail."""
    from paddle_tpu_torch.text.models import bert as bert_mod
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, seconds = {}, {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] done in {seconds[name]:.1f} s")
        t0 = time.perf_counter()

    out["ssd"], ssd_model, images = ssd_phase(dev, counted, launches, smi)
    lap("22a")
    out["bert_crf"] = bert_crf_phase(dev, counted, launches, bert_mod,
                                     phase10, smi)
    lap("22b")
    out["vision_ops"] = vision_ops_phase(dev)
    torch.cuda.empty_cache()
    lap("22c")
    out["fused_head"] = fused_head_phase(dev, counted, launches, gpt_mod,
                                         phase8, smi)
    lap("22d")
    out["hapi_tail"] = hapi_tail_phase(
        dev, ssd_model, images,
        str(Path(__file__).resolve().parent / "build" / "chip_smoke_hub"))
    del ssd_model
    torch.cuda.empty_cache()
    lap("22e")
    out["seconds"] = seconds
    log("[22] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


# -- phase 23: second derivatives and the fp16 instances of #1-#6 -----------
# 23d: each fp16 instance against its plain version. The LayerNorms round
# y, dx (and dγ/dβ) once to fp16 from f32 as their plain versions do: a
# few fp16 ulps (2^-10 relative) apart, sums over up to 8192 rows in
# another order.
LN_FP16_TOL = (4e-3, 2.0 ** -9)
# the forward against the f32-P plain version: P rounded to fp16 as the
# P·V operand (bf16's 1e-2 scaled by bf16's 8 to fp16's 11 bits, doubled)
FLASH_FP16_OUT_TOL = (2e-3, 2e-3)
# the backward against the plain version with fp16-rounded P and dS (one
# fp16 ulp of each output, 2^-10 of |ref|, and a few rounded P or dS
# elements flipped between the sum orders: 2^-12 of max|ref|), and against
# the f32 plain version of the same fp16 inputs within 2^-8 of max|ref|
FLASH_BWD_FP16_TOL = (2.0 ** -10, 2.0 ** -12)
FP16_VS_F32_REL_TOL = 2.0 ** -8
# 23a/23b: step 1's loss in fp16 against phase 8's (10's) bf16 step 1 on
# the same weights and batch: the bf16 run's activations keep 8
# significant bits, fp16's 11; the mean loss over the batch within a few
# bf16 roundings of itself
FP16_STEP1_LOSS_RTOL = 2.0 ** -6
FP16_TIMED_STEPS = 8
# 23c: WGAN-GP (Gulrajani et al. 2017) on a critic of two GPT-2 345M
# decoder blocks (causal) and a linear head, at interpolated [8, 1024,
# 1024] inputs
WGAN_SHAPE, WGAN_LAMBDA = (8, 1024, 1024), 10.0
# the penalty's gradient through the kernels (f32: the scalar flash
# kernels, the LayerNorm kernels; second-order terms in plain torch)
# against plain autograd differentiating the plain forward twice, TF32 off:
# each tensor within this share of its largest magnitude (sums over
# 8 x 1024 rows and 1024 keys in other orders, through a second
# derivative)
WGAN_REL_TOL = 1e-3
# 21d: the third derivative through each kernel against its plain
# version's on the card (f32), each tensor within this share of its
# largest magnitude
SECOND_ORDER_REL_TOL = 1e-4


def _fp16_ln_case(dev, rnd, fused, rows, hidden, err):
    x, g = (rnd(rows, hidden, dtype=torch.float16) for _ in range(2))
    w, b = (rnd(hidden, dtype=torch.float16) for _ in range(2))
    y = fused.fused_layer_norm(x, w, b)
    got = fused.layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    e_y, ok_y = worst(y, fused._ln_reference(x, w, b), *LN_FP16_TOL)
    res = [worst(a, r, *LN_FP16_TOL)
           for a, r in zip(got, fused._ln_bwd_reference(x, w, g))]
    err["layer_norm_fwd_fp16"] = max(err["layer_norm_fwd_fp16"], e_y)
    err["layer_norm_bwd_fp16"] = max(err["layer_norm_bwd_fp16"],
                                     *(e for e, _ in res))
    log(f"[23d] layer_norm fp16 rows={rows} hidden={hidden}: y err "
        f"{e_y:.3g}, dx/dw/db err " + "/".join(f"{e:.3g}" for e, _ in res)
        + f" (tol {LN_FP16_TOL})")
    if not (ok_y and all(ok for _, ok in res)):
        raise AssertionError("23d: an fp16 LayerNorm kernel disagrees")


def _fp16_flash_case(dev, rnd, gen, flash_tpu, shape, causal, err):
    q, k, v, do = (rnd(*shape, dtype=torch.float16) for _ in range(4))
    kb = None if causal else padding_bias(shape[0], shape[1], gen, dev)
    if causal:
        out, lse = flash_tpu.flash_attention_blhd(q, k, v)
        dq, delta = flash_tpu.flash_bwd_dq(q, k, v, do, lse, out)
        dk, dv = flash_tpu.flash_bwd_dkv(q, k, v, do, lse, delta)
    else:
        out, lse = flash_tpu.flash_attention_full(q, k, v, kb)
        dq, delta = flash_tpu.flash_bwd_dq_full(q, k, v, do, lse, out, kb)
        dk, dv = flash_tpu.flash_bwd_dkv_full(q, k, v, do, lse, delta, kb)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_tpu._flash_reference(q, k, v, causal, kb)
    e_o, ok_o = worst(out, ref_out, *FLASH_FP16_OUT_TOL)
    e_l, ok_l = worst(lse, ref_lse, *FLASH_LSE_TOL[torch.bfloat16])
    ref = flash_tpu._flash_bwd_reference(q, k, v, out, lse, do, causal, kb,
                                         operand_dtype=torch.float16)
    rtol, share = FLASH_BWD_FP16_TOL
    res = [worst(a, r, share * float(r.float().abs().max()), rtol)
           for a, r in zip((dq, dk, dv), ref)]
    ref32 = flash_tpu._flash_bwd_reference(
        *(t.float() for t in (q, k, v, out)), lse, do.float(), causal, kb)
    res32 = [share_worst(a, r, FP16_VS_F32_REL_TOL)
             for a, r in zip((dq, dk, dv), ref32)]
    suffix = "" if causal else "_full"
    err[f"flash_attn_fwd{suffix}_fp16"] = max(
        err[f"flash_attn_fwd{suffix}_fp16"], e_o, e_l)
    err[f"flash_attn_bwd_dq{suffix}_fp16"] = max(
        err[f"flash_attn_bwd_dq{suffix}_fp16"], res[0][0])
    err[f"flash_attn_bwd_dkv{suffix}_fp16"] = max(
        err[f"flash_attn_bwd_dkv{suffix}_fp16"], res[1][0], res[2][0])
    log(f"[23d] flash fp16 {'causal' if causal else 'full + key bias'} "
        f"(b,L,H,d)={shape}: out err {e_o:.3g} (tol {FLASH_FP16_OUT_TOL}), "
        f"lse err {e_l:.3g}; dq/dk/dv err "
        + "/".join(f"{e:.3g}" for e, _ in res)
        + f" (tol {rtol:.4g}|ref| + {share:.4g} max|ref|); vs f32 plain "
        + "/".join(f"{e:.3g}" for e, _ in res32)
        + f" (tol {FP16_VS_F32_REL_TOL:.4g} max|ref|)")
    if not (ok_o and ok_l and all(ok for _, ok in res + res32)):
        raise AssertionError("23d: an fp16 attention kernel disagrees")


def fp16_kernel_phase(dev, rnd, gen, fused, flash_tpu):
    """23d: each fp16 instance of #1-#6 against its plain version at GPT-2
    345M's and BERT-base's training shapes, then its time (events and
    device), its bound, its plain version's time and the library call's
    (F.layer_norm and its autograd, SDPA and its backward, in fp16).
    Returns (the errors by row name, the timings)."""
    F = torch.nn.functional
    err = {f"{n}_fp16": 0.0 for n in (
        "layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
        "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "flash_attn_fwd_full",
        "flash_attn_bwd_dq_full", "flash_attn_bwd_dkv_full")}
    for rows, hidden in LN_TIMED:
        _fp16_ln_case(dev, rnd, fused, rows, hidden, err)
    for shape, causal in ((GPT_ATTN_SHAPE, True), (BERT_ATTN_SHAPE, False)):
        _fp16_flash_case(dev, rnd, gen, flash_tpu, shape, causal, err)
    timings = []
    h16 = torch.float16
    for rows, hidden in LN_TIMED:
        w, b = (rnd(hidden, dtype=h16) for _ in range(2))
        copies = []
        for _ in range(LN_COPIES):
            x, g = (rnd(rows, hidden, dtype=h16) for _ in range(2))
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            y = F.layer_norm(leaves[0], (hidden,), leaves[1], leaves[2], 1e-5)
            copies.append((x, g, leaves, y))
        x, g = copies[0][:2]
        for kernel, kern, lib, plain, (bound, by) in (
                ("layer_norm_fwd_fp16",
                 [lambda x=x: fused.fused_layer_norm(x, w, b)
                  for x, *_ in copies],
                 [lambda x=x: F.layer_norm(x, (hidden,), w, b, 1e-5)
                  for x, *_ in copies],
                 lambda: fused._ln_reference(x, w, b),
                 ln_bound(rows, hidden, h16)),
                ("layer_norm_bwd_fp16",
                 [lambda x=x, g=g: fused.layer_norm_bwd(x, w, g)
                  for x, g, *_ in copies],
                 [lambda g=g, lv=lv, y=y: torch.autograd.grad(
                     y, lv, g, retain_graph=True)
                  for _, g, lv, y in copies],
                 lambda: fused._ln_bwd_reference(x, w, g),
                 ln_bwd_bound(rows, hidden, h16))):
            kern, lib = in_turn(kern), in_turn(lib)
            what = f"{kernel} {[rows, hidden]}"
            timings.append({
                "kernel": kernel, "shape": [rows, hidden],
                "dtype": "float16", "ms": time_ms(kern, iters=24),
                "plain_ms": time_ms(plain, iters=5, warmup=1),
                "library_ms": time_ms(lib, iters=24),
                "device_ms": device_ms(kern, what, iters=2 * LN_COPIES),
                "library_device_ms": device_ms(
                    lib, "F.layer_norm fp16 " + ("autograd " if "bwd" in
                                                 kernel else "")
                    + str([rows, hidden]), iters=2 * LN_COPIES),
                "bound_ms": bound, "bound_by": by})
        del copies, x, g
    for shape, causal, suffix in ((GPT_ATTN_SHAPE, True, ""),
                                  (BERT_ATTN_SHAPE, False, "_full")):
        q, k, v, do = (rnd(*shape, dtype=h16) for _ in range(4))
        kb = None if causal else padding_bias(shape[0], shape[1], gen, dev)
        mask = None if causal else kb[:, None, None, :].to(h16)
        lt = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(
            *lt, attn_mask=mask, is_causal=causal)
        ys = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(ys, lt, do.transpose(1, 2),
                                               retain_graph=True)
        if causal:
            fwd = lambda: flash_tpu.flash_attention_blhd(q, k, v)
        else:
            fwd = lambda: flash_tpu.flash_attention_full(q, k, v, kb)
        out, lse = fwd()
        dq_fn = flash_tpu.flash_bwd_dq if causal else \
            (lambda *a: flash_tpu.flash_bwd_dq_full(*a, kb))
        dkv_fn = flash_tpu.flash_bwd_dkv if causal else \
            (lambda *a: flash_tpu.flash_bwd_dkv_full(*a, kb))
        _, delta = dq_fn(q, k, v, do, lse, out)
        plain_fwd = time_ms(lambda: flash_tpu._flash_reference(
            q, k, v, causal, kb), iters=5, warmup=1)
        plain_bwd = time_ms(lambda: flash_tpu._flash_bwd_reference(
            q, k, v, out, lse, do, causal, kb, operand_dtype=h16), iters=3,
            warmup=1)
        lib_fwd, lib_fwd_dev = time_ms(sdpa, iters=20), device_ms(
            sdpa, f"SDPA fp16 {shape}", iters=10)
        lib_bwd, lib_bwd_dev = time_ms(sdpa_bwd, iters=10), device_ms(
            sdpa_bwd, f"SDPA fp16 backward {shape}", iters=10)
        for name, kern, kind in (
                ("flash_attn_fwd", fwd, "fwd"),
                ("flash_attn_bwd_dq", lambda: dq_fn(q, k, v, do, lse, out),
                 "dq"),
                ("flash_attn_bwd_dkv",
                 lambda: dkv_fn(q, k, v, do, lse, delta), "dkv")):
            bound, by = flash_bound(*shape, h16, kind, causal)
            name = f"{name}{suffix}_fp16"
            timings.append({
                "kernel": name, "shape": list(shape), "dtype": "float16",
                "ms": time_ms(kern, iters=20),
                "plain_ms": plain_fwd if kind == "fwd" else plain_bwd,
                "library_ms": lib_fwd if kind == "fwd" else lib_bwd,
                "device_ms": device_ms(kern, f"{name} {shape}", iters=10),
                "library_device_ms": lib_fwd_dev if kind == "fwd"
                else lib_bwd_dev, "bound_ms": bound, "bound_by": by})
            if kind != "fwd":
                timings[-1]["note"] = ("plain and library times are the "
                                       "whole backward (dQ, dK and dV)")
            if not causal:
                timings[-1]["note_library"] = (
                    "SDPA with the key-padding mask as an fp16 additive "
                    "[b, 1, 1, L] attn_mask")
        del q, k, v, do, lt, ys, out, lse, delta
        torch.cuda.empty_cache()
    for t in timings:
        log(f"[23d] time {t['kernel']} {t['shape']} fp16: kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, "
            f"{t['bound_ms'] / t['device_ms']:.3f} of its bound "
            f"{t['bound_ms']:.5f} ms, {t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
            f"(device {t['library_device_ms']:.4f})")
    return err, timings


def _fp16_profile(tag, step, batch, n_layers, extra_ln):
    """Two steps under the profiler (``profile_step``): every attention
    and LayerNorm launch ran the fp16 (``__half``) instances, none the
    bf16 or scalar ones, in the launch counts (``extra_ln``: the
    LayerNorms outside the layers); each session after a warm-up step, a
    session short of the launches taken again, as in
    ``profile_training``."""
    n_ln = 2 * n_layers + extra_ln
    want = {"fwd": 2 * n_layers, "dq": 2 * n_layers, "dkv": 2 * n_layers,
            "ln_fwd": 2 * n_ln, "ln_bwd": 2 * n_ln, "other_attention": 0,
            "other_ln": 0}
    for attempt in range(PROFILE_ATTEMPTS):
        keys = []
        prof_out = profile_step(tag, step, batch, keys=keys, warmup=True)
        count = lambda *words: sum(c for k, c in keys
                                   if all(w in k for w in words))
        got = {"fwd": count("flash_fwd_mma_kernel<__half"),
               "dq": count("flash_dq_mma_kernel<__half"),
               "dkv": count("flash_dkv_mma_kernel<__half"),
               "ln_fwd": count("ln_fwd_warp_kernel<__half"),
               "ln_bwd": count("ln_bwd_warp_kernel<__half"),
               "other_attention": count("mma_kernel<__nv_bfloat16")
               + count("flash_fwd_kernel<") + count("flash_dq_kernel<")
               + count("flash_dkv_kernel<"),
               "other_ln": count("ln_fwd_kernel<")
               + count("ln_bwd_rows_kernel<")
               + count("_warp_kernel<__nv_bfloat16")
               + count("_warp_kernel<float")}
        log(f"[{tag}] profile, fp16 instances in 2 steps: {got}")
        if got == want:
            return prof_out
        if got["other_attention"] or got["other_ln"] \
                or attempt + 1 == PROFILE_ATTEMPTS:
            raise AssertionError(f"{tag}: the profiled steps ran {got}, "
                                 f"expected {want}")
        log(f"[{tag}] profile session {attempt + 1} short of the launches; "
            "profiling again")


def gpt_fp16_phase(dev, counted, launches, gpt_mod, batch8, phase8, smi):
    """23a: GPT-2 345M through ``ParallelTrainStep(compute_dtype=
    torch.float16)`` with Adam's f32 masters (#7's fp16 instance) at
    bench.py's 8 x 1024, on phase 8's weights (seed 4) and batch."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import Adam

    ids, labels = batch8
    cfg = gpt_mod.gpt2_medium(hidden_dropout=0.0, attention_dropout=0.0)
    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.float32, seed=4)
    opt = Adam(TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    engine = ParallelTrainStep(model, lambda out, lbl: out, opt,
                               compute_dtype=torch.float16)
    if {p.dtype for p in model.parameters()} != {torch.float16}:
        raise AssertionError("23a: the residents are not fp16")
    step = lambda i, l: engine((i, l), (l,))
    warm = [step(ids, labels) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    n = FP16_TIMED_STEPS
    losses, step_ms, wall = timed_steps(step, (ids, labels), n)
    got = _read_launches(counted, launches, "fp16_gpt")
    peak = torch.cuda.max_memory_allocated()
    n_ln = 2 * cfg.num_layers + 1
    want = {**{k: 0 for k in counted},
            "layer_norm_fwd": n_ln * n, "layer_norm_bwd": 2 * n_ln * n,
            "flash_attn_fwd": cfg.num_layers * n,
            "flash_attn_bwd_dq": cfg.num_layers * n,
            "flash_attn_bwd_dkv": cfg.num_layers * n, "adam": 2 * n}
    prof = _fp16_profile("23a", step, (ids, labels), cfg.num_layers, 1)
    losses = [float(x) for x in torch.stack(warm + losses)]
    ref = phase8["losses"][0]
    rel = abs(losses[0] - ref) / abs(ref)
    p8 = phase8.get("profile") or {}
    out = {"tokens_per_s": TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * n / wall,
           "step_ms_p50": step_ms[n // 2], "step_ms_min": step_ms[0],
           "step_ms_max": step_ms[-1],
           "device_ms_per_step": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"], "peak_memory_bytes": peak,
           "losses": losses, "step1_loss_phase8": ref,
           "step1_rel_diff": rel, "launches": got, "card": smi}
    log(f"[23a] GPT-2 345M, ParallelTrainStep(compute_dtype=float16) + "
        f"Adam's f32 masters at {TRAIN_SHAPE}: {out['tokens_per_s']:.1f} "
        f"tokens/s (phase 8 bf16 {phase8['tokens_per_s']:.1f}), step p50 "
        f"{out['step_ms_p50']:.2f} ms (phase 8 {phase8['step_ms_p50']:.2f}),"
        f" device {out['device_ms_per_step']:.2f} ms a step (phase 8 "
        f"{p8.get('device_ms_per_step', float('nan')):.2f}), busy share "
        f"{out['busy_share']:.4f} (phase 8 "
        f"{p8.get('busy_share', float('nan')):.4f}), peak memory "
        f"{peak / 2**30:.2f} GiB (phase 8 "
        f"{phase8['peak_memory_bytes'] / 2**30:.2f}); step 1's loss "
        f"{losses[0]:.4f} against phase 8's bf16 {ref:.4f} (rel "
        f"{rel:.3g}, tol {FP16_STEP1_LOSS_RTOL:.3g}), -> {losses[-1]:.4f}; "
        f"launches {got}; {smi}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"23a: the loss did not fall: {losses}")
    if rel > FP16_STEP1_LOSS_RTOL:
        raise AssertionError("23a: step 1's loss is off phase 8's")
    if got != want:
        raise AssertionError(f"23a launched {got}, expected {want}")
    del engine, model, opt
    torch.cuda.empty_cache()
    return out


def bert_fp16_phase(dev, gen, counted, launches, bert_mod, batch10, phase10,
                    smi):
    """23b: BERT-base through the same engine in fp16 (f32 parameters
    resident, the forward on their fp16 casts) with AdamW at phase 10's
    32 x 128, on phase 10's weights (seed 6) and batch; then padded
    steps, where the attention mask is #4's key bias."""
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_mod.bert_base(hidden_dropout=0.0, attention_dropout=0.0)
    ids, mlm, nsp = batch10
    model = bert_mod.BertForPretraining(cfg, dtype=torch.float32, seed=6)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    engine = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                               compute_dtype=torch.float16)
    step = lambda i, m, s: engine((i,), (m, s))
    warm = [step(ids, mlm, nsp) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cleared(counted)
    n = FP16_TIMED_STEPS
    losses, step_ms, wall = timed_steps(step, (ids, mlm, nsp), n)
    got = _read_launches(counted, launches, "fp16_bert")
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    want = {**{k: 0 for k in counted},
            "layer_norm_fwd": (2 * L + 2) * n,
            "layer_norm_bwd": 2 * (2 * L + 2) * n,
            "flash_attn_fwd_full": L * n, "flash_attn_bwd_dq_full": L * n,
            "flash_attn_bwd_dkv_full": L * n, "adam": 2 * n}
    prof = _fp16_profile("23b", step, (ids, mlm, nsp), L, 2)
    losses = [float(x) for x in torch.stack(warm + losses)]
    ref = phase10["losses"][0]
    rel = abs(losses[0] - ref) / abs(ref)
    if got != want:
        raise AssertionError(f"23b launched {got}, expected {want}")
    mask = (padding_bias(*BERT_SHAPE, gen, dev) == 0).long()
    types = torch.zeros_like(ids)
    _cleared(counted)
    n_pad = 3
    padded = [float(engine((ids, types, mask), (mlm, nsp)))
              for _ in range(n_pad)]
    torch.cuda.synchronize()
    got_pad = _read_launches(counted, launches, "fp16_bert_padded")
    want_pad = {k: v // n * n_pad for k, v in want.items()}
    samples = BERT_SHAPE[0] * n
    out = {"samples_per_s": samples / wall,
           "tokens_per_s": samples * BERT_SHAPE[1] / wall,
           "step_ms_p50": step_ms[n // 2], "step_ms_min": step_ms[0],
           "step_ms_max": step_ms[-1],
           "device_ms_per_step": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"], "peak_memory_bytes": peak,
           "losses": losses, "padded_losses": padded,
           "step1_loss_phase10": ref, "step1_rel_diff": rel,
           "launches": got, "launches_padded": got_pad, "card": smi}
    log(f"[23b] BERT-base, ParallelTrainStep(compute_dtype=float16) + AdamW"
        f" at {BERT_SHAPE}: {out['samples_per_s']:.1f} samples/s (phase 10 "
        f"bf16 {phase10['samples_per_s']:.1f}), step p50 "
        f"{out['step_ms_p50']:.2f} ms (phase 10 {phase10['step_ms_p50']:.2f}"
        f"), device {out['device_ms_per_step']:.2f} ms a step (phase 10 "
        f"{phase10.get('device_ms_per_step') or float('nan'):.2f}), busy "
        f"share {out['busy_share']:.4f} (phase 10 "
        f"{phase10.get('busy_share') or float('nan'):.4f}), peak memory "
        f"{peak / 2**30:.2f} GiB (phase 10 "
        f"{phase10['peak_memory_bytes'] / 2**30:.2f}); step 1's loss "
        f"{losses[0]:.4f} against phase 10's bf16 {ref:.4f} (rel {rel:.3g}, "
        f"tol {FP16_STEP1_LOSS_RTOL:.3g}), -> {losses[-1]:.4f}; padded "
        f"(lengths {mask.sum(1).min().item()}-{mask.sum(1).max().item()}) "
        f"{padded}; launches {got}, padded {got_pad}; {smi}")
    if not all(math.isfinite(x) for x in losses + padded) \
            or losses[-1] >= losses[0]:
        raise AssertionError(f"23b: the loss did not fall: {losses}")
    if rel > FP16_STEP1_LOSS_RTOL:
        raise AssertionError("23b: step 1's loss is off phase 10's")
    if got_pad != want_pad:
        raise AssertionError(f"23b padded steps launched {got_pad}, "
                             f"expected {want_pad}")
    del engine, model, opt
    torch.cuda.empty_cache()
    return out


class WGANCritic(torch.nn.Module):
    """Two GPT-2 decoder blocks (causal) and a linear head: D(x) per
    position."""

    def __init__(self, gpt_mod, cfg, dtype, seed):
        super().__init__()
        from paddle_tpu_torch.nn import Linear, initializer

        gen = torch.Generator(device="cuda").manual_seed(seed)
        initializer.seed(seed)  # the weights, drawn on the CPU
        self.blocks = torch.nn.ModuleList(
            [gpt_mod.GPTBlock(cfg, gen, "cuda", dtype) for _ in range(2)])
        self.head = Linear(cfg.hidden_size, 1, device="cuda", dtype=dtype)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)


def _wgan_penalty_grads(critic, x, counted=None):
    """The WGAN-GP penalty λ·(‖∇ₓD(x̂)‖ − 1)², its gradient in the
    critic's weights, and (given the counts) the launches of the
    first-order path: D's forward and ∇ₓD with create_graph."""
    params = [p for p in critic.parameters()]
    x = x.detach().requires_grad_()
    if counted is not None:
        _cleared(counted)
    (gx,) = torch.autograd.grad(critic(x).float().sum(), [x],
                                create_graph=True)
    first = {n: fn.launches for n, fn in counted.items()} \
        if counted is not None else None
    norm = torch.sqrt((gx.float() ** 2).sum(dim=(1, 2)) + 1e-12)
    penalty = WGAN_LAMBDA * ((norm - 1.0) ** 2).mean()
    grads = torch.autograd.grad(penalty, params, allow_unused=True)
    return penalty.detach(), [torch.zeros_like(p) if g is None else g
                              for g, p in zip(grads, params)], first


def wgan_phase(dev, counted, launches, gpt_mod, plain, smi):
    """23c: the WGAN-GP penalty's gradient through two GPT-2 345M blocks,
    in f32 through the kernels (first order on #1-#3 and #5/#6, the
    second-order terms in plain torch) against f32 under
    ``plain_kernels`` (plain torch autograd differentiates the plain
    forward twice), then in bf16 for the time and memory."""
    cfg = gpt_mod.gpt2_medium(hidden_dropout=0.0, attention_dropout=0.0)
    gen = torch.Generator(device=dev).manual_seed(23)
    b, L, h = WGAN_SHAPE
    real, fake = (torch.randn(b, L, h, device=dev, generator=gen)
                  for _ in range(2))
    eps = torch.rand(b, 1, 1, device=dev, generator=gen)
    xhat = eps * real + (1 - eps) * fake
    del real, fake
    critic = WGANCritic(gpt_mod, cfg, torch.float32, 23).eval()
    pen_k, g_k, first = _wgan_penalty_grads(critic, xhat, counted)
    torch.cuda.synchronize()
    got_all = _read_launches(counted, launches, "wgan_gp")
    with plain():
        pen_p, g_p, _ = _wgan_penalty_grads(critic, xhat)
    torch.cuda.synchronize()
    errs = [float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for a, r in zip(g_k, g_p) if r.abs().max() > 0]
    worst_rel = max(errs)
    n_ln = 2 * 2
    want_first = {**{k: 0 for k in counted},
                  "layer_norm_fwd": n_ln, "layer_norm_bwd": 2 * n_ln,
                  "flash_attn_fwd": 2, "flash_attn_bwd_dq": 2,
                  "flash_attn_bwd_dkv": 2}
    log(f"[23c] WGAN-GP (lambda {WGAN_LAMBDA}) on two GPT-2 345M blocks at "
        f"{WGAN_SHAPE}, f32: penalty {float(pen_k):.6f} through the kernels,"
        f" {float(pen_p):.6f} plain; its gradient in the critic's "
        f"{len(g_k)} tensors, worst err {worst_rel:.3g} of each tensor's "
        f"largest magnitude (tol {WGAN_REL_TOL}); launches on the first-"
        f"order path {first}; in the whole penalty gradient {got_all}")
    if first != want_first:
        raise AssertionError(f"23c: the first-order path launched {first}, "
                             f"expected {want_first}")
    if worst_rel > WGAN_REL_TOL or not math.isfinite(float(pen_k)):
        raise AssertionError("23c: the penalty's gradient through the "
                             "kernels is off the plain path's")
    del critic, g_k, g_p
    torch.cuda.empty_cache()
    # bf16: the time of the penalty's gradient and of the double backward
    critic = WGANCritic(gpt_mod, cfg, torch.bfloat16, 23).eval()
    x16 = xhat.to(torch.bfloat16)
    params = list(critic.parameters())

    def first_order():
        x = x16.detach().requires_grad_()
        (gx,) = torch.autograd.grad(critic(x).float().sum(), [x],
                                    create_graph=True)
        norm = torch.sqrt((gx.float() ** 2).sum(dim=(1, 2)) + 1e-12)
        return WGAN_LAMBDA * ((norm - 1.0) ** 2).mean()

    pens = [first_order() for _ in range(2)]
    for p in pens:
        torch.autograd.grad(p, params, allow_unused=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    pen = first_order()
    marks[1].record()
    grads = torch.autograd.grad(pen, params, allow_unused=True)
    marks[2].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    first_ms, double_ms = (marks[i].elapsed_time(marks[i + 1])
                           for i in range(2))
    dev_double = device_ms(
        lambda: torch.autograd.grad(first_order(), params,
                                    allow_unused=True),
        "WGAN-GP penalty gradient bf16", iters=2, per_call=10)
    out = {"shape": list(WGAN_SHAPE), "penalty_f32": float(pen_k),
           "penalty_f32_plain": float(pen_p), "grad_rel_err": worst_rel,
           "launches_first_order": first, "launches": got_all,
           "bf16_penalty": float(pen.detach()),
           "bf16_first_order_ms": first_ms,
           "bf16_double_backward_ms": double_ms,
           "bf16_penalty_grad_device_ms": dev_double,
           "bf16_peak_memory_bytes_above_weights": peak, "card": smi}
    log(f"[23c] bf16: penalty {float(pen.detach()):.4f}; D's forward and "
        f"∇ₓD {first_ms:.2f} ms, the double backward (penalty -> weights) "
        f"{double_ms:.2f} ms (events), the whole penalty gradient "
        f"{dev_double:.2f} ms of device time; peak memory "
        f"{peak / 2**30:.2f} GiB above the weights and inputs; {smi}")
    if not all(torch.isfinite(g).all() for g in grads if g is not None):
        raise AssertionError("23c: a non-finite bf16 penalty gradient")
    del critic, grads, pens, pen, x16
    torch.cuda.empty_cache()
    return out


def fp16_slice_phase(dev, gen, counted, launches, gpt_mod, bert_mod, plain,
                     batch8, phase8, batch10, phase10, smi):
    """Phase 23: 23a GPT-2 345M and 23b BERT-base trained in fp16, 23c the
    WGAN-GP penalty through GPT-2 blocks (23d ran after phase 3c)."""
    seconds, t0 = {}, time.perf_counter()
    out = {"gpt_fp16": gpt_fp16_phase(dev, counted, launches, gpt_mod,
                                      batch8, phase8, smi)}
    seconds["23a"] = time.perf_counter() - t0
    out["bert_fp16"] = bert_fp16_phase(dev, gen, counted, launches, bert_mod,
                                       batch10, phase10, smi)
    seconds["23b"] = time.perf_counter() - t0 - seconds["23a"]
    out["wgan_gp"] = wgan_phase(dev, counted, launches, gpt_mod, plain, smi)
    seconds["23c"] = time.perf_counter() - t0 - seconds["23a"] \
        - seconds["23b"]
    out["seconds"] = seconds
    log("[23] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


def counted_kernels():
    """Each kernel's wrapper by its name in the kernels line; each counts
    its launches in ``.launches``."""
    from paddle_tpu_torch.experiments import dkv_packed as dkv_mod
    from paddle_tpu_torch.ops import flash_tpu, fused, tree_reduce

    return {"layer_norm_fwd": fused.fused_layer_norm,
            "flash_attn_fwd": flash_tpu.flash_attention_blhd,
            "layer_norm_bwd": fused.layer_norm_bwd,
            "flash_attn_bwd_dq": flash_tpu.flash_bwd_dq,
            "flash_attn_bwd_dkv": flash_tpu.flash_bwd_dkv,
            "adam": fused.fused_adam_step,
            "flash_attn_fwd_full": flash_tpu.flash_attention_full,
            "flash_attn_bwd_dq_full": flash_tpu.flash_bwd_dq_full,
            "flash_attn_bwd_dkv_full": flash_tpu.flash_bwd_dkv_full,
            "dkv_packed": dkv_mod.dkv_call,
            "grad_sumsq": fused.grad_global_norm,
            "adam_check": fused.adam_finite_check,
            "tree_reduce": tree_reduce.tree_reduce}


def card_name():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
    from paddle_tpu_torch.inference.serving import (
        TokenServeConfig, TokenServingEngine, dense_greedy_reference,
        run_generation_streams)
    from paddle_tpu_torch.experiments import dkv_packed as dkv_mod
    from paddle_tpu_torch.jit.functionalize import get_params
    from paddle_tpu_torch.jit.train_step import TrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.optimizer import optimizer as opt_mod
    from paddle_tpu_torch.nn.layer import norm as norm_mod
    from paddle_tpu_torch.core import sanitizer
    from paddle_tpu_torch.core.tree import leaves as tree_leaves
    from paddle_tpu_torch.ops import (_build, attention, flash_tpu, fused,
                                      tree_reduce)
    from paddle_tpu_torch.optimizer import Adam, AdamW
    from paddle_tpu_torch.resilience import (corrupt_param_bit,
                                             fingerprint_digest)
    from paddle_tpu_torch.profiler.telemetry import get_telemetry
    from paddle_tpu_torch.text.models import bert as bert_mod
    from paddle_tpu_torch.text.models import gpt as gpt_mod
    from paddle_tpu_torch import bench as bench_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ln_fn, flash_fn = fused.fused_layer_norm, flash_tpu.flash_attention_blhd
    t_start = time.perf_counter()

    def at(phase):
        log(f"[t] phase {phase} starts {time.perf_counter() - t_start:.1f} "
            "s into the script")
    counted = counted_kernels()
    plain = lambda: plain_kernels(gpt_mod, fused, flash_tpu, norm_mod,
                                  bert_mod, attention)

    # -- phase 1: the card ---------------------------------------------------
    smi = card_name()
    log(f"[1] card: {smi}  (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    at("2")
    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({_build.build_info['path']})")
    for src, text in _build.build_info.get("log", {}).items():
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # e.g. flash_fwd_mma_kernel<Li64ELb1> from the mangled name
                m = re.search(r"\d([a-z][a-z_]*_kernel)(?:I(\w*?)EE)?", line)
                kernel = (m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                        else "")) if m else ""
            if "registers" in line or "spill" in line:
                log(f"    {src} {kernel}: {line.strip()}")
            # the warp-per-row LayerNorms keep their rows and sums in
            # registers, the packed dK/dV at d <= 64 its K and V fragments
            # and both accumulators: a spill would put them in local memory
            packed = re.fullmatch(r"dkv_packed_mma_kernel<Li(\d+)>", kernel)
            if ("_warp_kernel" in kernel
                    or (packed and int(packed.group(1)) <= 64)) \
                    and "spill" in line and \
                    re.search(r"[1-9]\d* bytes spill", line):
                raise AssertionError(f"{src} {kernel} spills: {line}")

    at("3")
    # -- phase 3: each kernel against its plain version ---------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, dtype: torch.randn(
        *shape, device=dev, generator=gen).to(dtype)
    err = {name: 0.0 for name in counted}
    for dtype in DTYPES:
        for rows, hidden, off, want in ln_cases(LN_ROWS):
            x = rnd(rows, hidden, dtype=dtype)
            x = misaligned(x) if off else x
            w, b = rnd(hidden, dtype=dtype), rnd(hidden, dtype=dtype)
            y = ln_fn(x, w, b)
            torch.cuda.synchronize()
            e, ok = worst(y, fused._ln_reference(x, w, b), *LN_TOL[dtype])
            err["layer_norm_fwd"] = max(err["layer_norm_fwd"], e)
            log(f"[3] layer_norm {str(dtype)[6:]} rows={rows} "
                f"hidden={hidden}{' misaligned' if off else ''} "
                f"({ln_variant(fused, want, x, w, b, y)}): max err {e:.3g} "
                f"(tol {LN_TOL[dtype]})")
            if not ok:
                raise AssertionError("layer_norm kernel disagrees")
        # the shapes with dense operands, then GPT's training shape with
        # q/k/v as the main path passes them: views of the fused QKV
        for shape, fused_qkv in ([(sh, False) for sh in FLASH_SHAPES]
                                 + [(GPT_ATTN_SHAPE, True)]):
            q, k, v, _ = attn_operands(rnd, shape, dtype, fused_qkv)
            out, lse = flash_fn(q, k, v)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_tpu._flash_reference(q, k, v)
            e_o, ok_o = worst(out, ref_out, *FLASH_OUT_TOL[dtype])
            e_l, ok_l = worst(lse, ref_lse, *FLASH_LSE_TOL[dtype])
            err["flash_attn_fwd"] = max(err["flash_attn_fwd"], e_o, e_l)
            log(f"[3] flash {str(dtype)[6:]} (b,L,H,d)={shape}"
                + (f" as fused-QKV views (row stride {q.stride(1)})"
                   if fused_qkv else "") + f": out err "
                f"{e_o:.3g} (tol {FLASH_OUT_TOL[dtype]}), lse err {e_l:.3g} "
                f"(tol {FLASH_LSE_TOL[dtype]})")
            if not (ok_o and ok_l):
                raise AssertionError("flash kernel disagrees")

    timings = []
    # decode buckets, a prefill chunk and the training shapes; at GPT's the
    # block kernel too (on a misaligned view), the kernel before the warp
    # kernels
    for rows, hidden, kernel in (
            [(r, 1024, "layer_norm_fwd") for r in (1, 8, 128, 1024)]
            + [(r, h, "layer_norm_fwd") for r, h in LN_TIMED]
            + [(*LN_TIMED[0], "layer_norm_fwd_block")]):
        xs = [rnd(rows, hidden, dtype=torch.bfloat16)
              for _ in range(LN_COPIES if rows >= 4096 else 1)]
        if kernel.endswith("block"):
            xs = [misaligned(x) for x in xs]
        x = xs[0]
        w, b = (rnd(hidden, dtype=torch.bfloat16) for _ in range(2))
        bound, by = ln_bound(rows, hidden, torch.bfloat16)
        lib = lambda x=x: torch.nn.functional.layer_norm(x, (hidden,), w, b,
                                                         1e-5)
        # the training shapes take their inputs from HBM, as in a step (one
        # copy after another); the decode and prefill shapes stay in the L2
        kern = in_turn([lambda x=x: ln_fn(x, w, b) for x in xs])
        lib_turn = in_turn([lambda x=x: lib(x) for x in xs])
        what = f"{kernel} {[rows, hidden]}"
        timings.append({
            "kernel": kernel, "shape": [rows, hidden], "dtype": "bfloat16",
            "ms": time_ms(kern),
            "plain_ms": time_ms(lambda: fused._ln_reference(x, w, b)),
            "library_ms": time_ms(lib_turn),
            "device_ms": device_ms(kern, what, iters=4 * LN_COPIES),
            "library_device_ms": device_ms(lib_turn,
                                           f"F.layer_norm {[rows, hidden]}",
                                           iters=4 * LN_COPIES),
            "bound_ms": bound, "bound_by": by})
        if len(xs) > 1:  # also with one copy, whose x stays in the L2
            timings[-1].update(
                device_l2_ms=device_ms(lambda: ln_fn(x, w, b),
                                       what + " in the L2"),
                library_device_l2_ms=device_ms(
                    lib, f"F.layer_norm {[rows, hidden]} in the L2"))
        del kern, lib_turn
        del xs, x
    for shape in FLASH_SHAPES + ((8, 1024, 16, 64),):
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
            "device_ms": device_ms(lambda: flash_fn(q, k, v),
                                   f"flash_attn_fwd {shape}"),
            "library_device_ms": device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), f"SDPA {shape}"),
            "bound_ms": bound, "bound_by": by})
    for t in timings:
        log(f"[3] time {t['kernel']} {t['shape']} bf16: kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
            f"(device {t['library_device_ms']:.4f}), bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']})")

    at("3b")
    # -- phase 3b: the backward kernels and Adam -----------------------------
    cfg = gpt_mod.gpt2_medium()
    check_backward_kernels(dev, rnd, fused, flash_tpu, err)
    torch.cuda.empty_cache()
    timings += time_backward_kernels(dev, rnd, fused, flash_tpu, cfg)
    torch.cuda.empty_cache()

    at("3c")
    # -- phase 3c: full attention, the packed dK/dV and AdamW ----------------
    bert_cfg = bert_mod.bert_base(hidden_dropout=0.0, attention_dropout=0.0)
    check_bert_kernels(dev, rnd, gen, fused, flash_tpu, dkv_mod, bert_cfg,
                       err)
    timings += time_bert_kernels(dev, rnd, gen, fused, flash_tpu, dkv_mod,
                                 bert_cfg)
    # 19a (#7's fp16 instance and its lr-scale column) runs beside the
    # other kernels' checks: late in the script the profiler has recorded
    # as little as one operation of a window of its launches
    surface = {"adam_fp16": param_adam_phase(dev, cfg, fused, err)}
    torch.cuda.empty_cache()
    # 23d (the fp16 instances of #1-#6) here for the same reason
    at("23d")
    fp16_err, fp16_t = fp16_kernel_phase(dev, rnd, gen, fused, flash_tpu)
    torch.cuda.empty_cache()
    log("timings " + json.dumps(timings))
    for t in timings:
        if t["kernel"].startswith("flash_attn_fwd"):
            log(f"[3] forward {t['kernel']} {t['shape']}: device "
                f"{t['device_ms']:.4f} ms, "
                f"{t['bound_ms'] / t['device_ms']:.3f} of its bound "
                f"({t['bound_by']}), "
                f"{t['device_ms'] / t['library_device_ms']:.2f}x SDPA's "
                f"device time ({t['library_device_ms']:.4f} ms)")
    for t in timings:
        if "device_l2_ms" in t:
            kern, lib = t["device_ms"], t["library_device_ms"]
            log(f"[3] {t['kernel']} {t['shape']}: device {kern:.4f} ms with "
                f"its inputs out of the L2 ({t['device_l2_ms']:.4f} in it), "
                f"{t['bound_ms'] / kern:.3f} of its bound "
                f"({t['bound_by']}), {kern / lib:.2f}x F.layer_norm"
                + (" autograd" if "bwd" in t["kernel"] else "")
                + f"'s device time ({lib:.4f} ms; "
                f"{t['library_device_l2_ms']:.4f} in the L2)")
    for full in ("", "_full"):
        for t in timings:
            if t["kernel"] != f"flash_attn_bwd_dq{full}":
                continue
            t2 = next(u for u in timings if u["shape"] == t["shape"]
                      and u["kernel"] == f"flash_attn_bwd_dkv{full}")
            both = t["device_ms"] + t2["device_ms"]
            log(f"[3b] backward{full or ' (causal)'} {t['shape']}: dQ "
                f"{t['device_ms']:.4f} ms "
                f"({t['bound_ms'] / t['device_ms']:.3f} of its bound, "
                f"{t['bound_by']}) + dK/dV {t2['device_ms']:.4f} ms "
                f"({t2['bound_ms'] / t2['device_ms']:.3f} of its bound, "
                f"{t2['bound_by']}) = {both:.4f} ms, "
                f"{both / t['library_device_ms']:.2f}x SDPA's whole "
                "backward "
                f"({t['library_device_ms']:.4f} ms)")
    torch.cuda.empty_cache()

    launches = {name: {} for name in counted}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(phase):
        for name, fn in counted.items():
            launches[name][phase] = fn.launches
        return ln_fn.launches, flash_fn.launches

    at("4")
    # -- phase 4: dense forward at full width ------------------------------
    model = gpt_mod.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=0).eval()
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), device=dev,
                        generator=gen)
    with torch.no_grad():
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        n_ln, n_flash = read_counts("dense_forward")
        with plain():
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
    dense = (ids, logits.cpu())  # phase 17c's jit.to_static comparison

    at("5")
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

    at("6")
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
    del engine, model32
    torch.cuda.empty_cache()

    at("7")
    # -- phase 7: gradient parity at full width (f32) ------------------------
    cfg2 = gpt_mod.gpt2_medium(num_layers=2, hidden_dropout=0.0,
                               attention_dropout=0.0)
    ids = torch.randint(0, cfg2.vocab_size, (2, 1024), device=dev,
                        generator=gen)
    labels = torch.roll(ids, -1, dims=1)

    def one_step(use_plain, bf16=False):
        """One Adam step; ``bf16``: bf16 compute with f32 masters, as
        phase 8 trains (the gradients are the bf16 ones)."""
        model = gpt_mod.GPTForCausalLM(cfg2, dtype=torch.float32, seed=3)
        opt = Adam(TRAIN_LR, parameters=model.parameters(),
                   multi_precision=bf16)
        grads = {}
        update = opt.step

        def keep_grads_then_update():
            grads.update({n: p.grad.clone()
                          for n, p in model.named_parameters()})
            update()

        opt.step = keep_grads_then_update
        step = ParallelTrainStep(
            model, lambda out, lbl: out, opt,
            compute_dtype=torch.bfloat16 if bf16 else None)
        with plain() if use_plain else contextlib.nullcontext():
            loss = float(step((ids, labels), (labels,)))
        return loss, grads, {n: p.clone()
                             for n, p in get_params(model).items()}

    reset_counts()
    loss_k, grads_k, params_k = one_step(use_plain=False)
    torch.cuda.synchronize()
    read_counts("grad_parity")
    got = {n: launches[n]["grad_parity"] for n in counted}
    n_ln = 2 * cfg2.num_layers + 1
    want = {**{n: 0 for n in counted},
            "layer_norm_fwd": n_ln, "layer_norm_bwd": 2 * n_ln,
            "flash_attn_fwd": cfg2.num_layers,
            "flash_attn_bwd_dq": cfg2.num_layers,
            "flash_attn_bwd_dkv": cfg2.num_layers, "adam": 2}
    loss_p, grads_p, params_p = one_step(use_plain=True)
    g_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                / max(float(grads_p[n].abs().max()), 1e-30)
                for n in grads_p)
    p_err = max(float((params_k[n] - params_p[n]).abs().max())
                for n in params_p)
    l_err = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[7] one f32 step of gpt2_medium(num_layers=2) at [2, 1024]: loss "
        f"{loss_k:.6f} (kernels) vs {loss_p:.6f} (plain), rel err "
        f"{l_err:.3g} (tol {LOSS_RTOL}); worst grad err / max|grad| "
        f"{g_err:.3g} over {len(grads_p)} tensors (tol {GRAD_REL_TOL}); "
        f"params after Adam max err {p_err:.3g} (atol {PARAM_ATOL}); "
        f"launches {got}")
    if got != want:
        raise AssertionError(f"phase 7 launched {got}, expected {want}")
    if set(grads_k) != set(grads_p) or len(grads_p) != 28:
        raise AssertionError("phase 7 did not see every gradient")
    if not (l_err <= LOSS_RTOL and g_err <= GRAD_REL_TOL
            and p_err <= PARAM_ATOL):
        raise AssertionError("training step through the kernels disagrees "
                             "with the plain path")
    del grads_k, grads_p, params_k, params_p
    torch.cuda.empty_cache()
    # the same step in bf16 with f32 masters: every bf16 kernel (the
    # tensor-core attention forward and backward among them) against the
    # plain path on the loss and each bf16 gradient tensor
    reset_counts()
    loss_k, grads_k, _ = one_step(use_plain=False, bf16=True)
    torch.cuda.synchronize()
    read_counts("grad_parity_bf16")
    got = {n: launches[n]["grad_parity_bf16"] for n in counted}
    loss_p, grads_p, _ = one_step(use_plain=True, bf16=True)
    g_errs = {n: float((grads_k[n].float() - grads_p[n].float()).abs().max())
              / max(float(grads_p[n].float().abs().max()), 1e-30)
              for n in grads_p}
    g_name = max(g_errs, key=g_errs.get)
    l_err = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[7] one bf16 step (f32 masters) of gpt2_medium(num_layers=2) at "
        f"[2, 1024]: loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain), "
        f"rel err {l_err:.3g} (tol {LOSS_BF16_RTOL}); worst grad err / "
        f"max|grad| {g_errs[g_name]:.3g} ({g_name}) over {len(grads_p)} "
        f"tensors (tol {GRAD_BF16_REL_TOL:.4g}); grad dtype "
        f"{next(iter(grads_k.values())).dtype}; launches {got}")
    if got != want:
        raise AssertionError(f"phase 7 (bf16) launched {got}, expected "
                             f"{want}")
    if set(grads_k) != set(grads_p) or len(grads_p) != 28:
        raise AssertionError("phase 7 (bf16) did not see every gradient")
    if not (l_err <= LOSS_BF16_RTOL
            and max(g_errs.values()) <= GRAD_BF16_REL_TOL):
        raise AssertionError("bf16 training step through the kernels "
                             "disagrees with the plain path")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    at("8")
    # -- phase 8: training GPT-2 345M at full width --------------------------
    train_cfg = gpt_mod.gpt2_medium(hidden_dropout=0.0,
                                    attention_dropout=0.0)
    model = gpt_mod.GPTForCausalLM(train_cfg, dtype=torch.float32, seed=4)
    opt = Adam(TRAIN_LR, parameters=model.parameters(),
               multi_precision=True)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt,
                             compute_dtype=torch.bfloat16)
    ids = torch.randint(0, train_cfg.vocab_size, TRAIN_SHAPE, device=dev,
                        generator=gen)
    labels = torch.roll(ids, -1, dims=1)
    batch8 = (ids, labels)  # phase 23a's batch
    warm = [step((ids, labels), (labels,)) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tel.reset()
    reset_counts()
    n_steps = 20
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    t0 = time.perf_counter()
    losses = []
    for i in range(n_steps):
        marks[i].record()
        losses.append(step((ids, labels), (labels,)))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("training")
    peak = torch.cuda.max_memory_allocated()
    all_losses = [float(x) for x in torch.stack(warm + losses)]
    step_ms = sorted(marks[i].elapsed_time(marks[i + 1])
                     for i in range(n_steps))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * n_steps
    got = {n: launches[n]["training"] for n in counted}
    n_ln = 2 * train_cfg.num_layers + 1
    want = {**{n: 0 for n in counted},
            "layer_norm_fwd": n_ln * n_steps,
            "layer_norm_bwd": 2 * n_ln * n_steps,
            "flash_attn_fwd": train_cfg.num_layers * n_steps,
            "flash_attn_bwd_dq": train_cfg.num_layers * n_steps,
            "flash_attn_bwd_dkv": train_cfg.num_layers * n_steps,
            "adam": 2 * n_steps}
    hist = tel.hist_summary("engine/step_ms") or {}
    training = {
        "tokens_per_s": tokens / wall, "step_ms_p50": step_ms[n_steps // 2],
        "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
        "engine_step_ms_p50": hist.get("p50"),
        "peak_memory_bytes": peak, "losses": all_losses,
        "engine_steps": tel.counter_value("engine/steps")}
    log(f"[8] trained gpt2_medium bf16 + f32 masters at {TRAIN_SHAPE}: "
        f"{training['tokens_per_s']:.1f} tokens/s over {n_steps} steps, "
        f"step p50 {training['step_ms_p50']:.2f} ms (events; min "
        f"{step_ms[0]:.2f}, max {step_ms[-1]:.2f}; engine/step_ms p50 "
        f"{hist.get('p50', float('nan')):.2f}), peak memory "
        f"{peak / 2**30:.2f} GiB; loss {all_losses[0]:.4f} -> "
        f"{all_losses[-1]:.4f}; launches {got}")
    log("training " + json.dumps(training))
    if not all(np.isfinite(all_losses)):
        raise AssertionError(f"non-finite loss: {all_losses}")
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"the loss did not fall: {all_losses}")
    if got != want:
        raise AssertionError(f"training launched {got}, expected {want}")
    if training["engine_steps"] != n_steps:
        raise AssertionError("engine/steps does not count the steps")
    training["profile"] = profile_training(step, ids, labels,
                                           train_cfg.num_layers)
    del step, model, opt
    torch.cuda.empty_cache()

    at("9")
    # -- phase 9: BERT gradient parity at full width (f32) --------------------
    cfg9 = bert_mod.bert_base(num_layers=2, hidden_dropout=0.0,
                              attention_dropout=0.0)
    ids9, mlm9, nsp9 = bert_batch(cfg9, 4, 128, gen, dev)
    # the padded variant: an attention mask of random valid lengths
    mask9 = (padding_bias(4, 128, gen, dev) == 0).long()

    def bert_step(use_plain, padded=False):
        model = bert_mod.BertForPretraining(cfg9, dtype=torch.float32, seed=5)
        opt = AdamW(TRAIN_LR, parameters=model.parameters(),
                    weight_decay=0.01)
        grads = {}
        update = opt.step

        def keep_grads_then_update():
            grads.update({n: p.grad.clone()
                          for n, p in model.named_parameters()})
            update()

        opt.step = keep_grads_then_update
        step = ParallelTrainStep(model, model.loss_fn, opt)
        inputs = (ids9, torch.zeros_like(ids9), mask9) if padded else (ids9,)
        with plain() if use_plain else contextlib.nullcontext():
            loss = float(step(inputs, (mlm9, nsp9)))
        return loss, grads, {n: p.clone()
                             for n, p in get_params(model).items()}

    n_ln = 2 * cfg9.num_layers + 2
    want = {**{n: 0 for n in counted},
            "layer_norm_fwd": n_ln, "layer_norm_bwd": 2 * n_ln,
            "flash_attn_fwd_full": cfg9.num_layers,
            "flash_attn_bwd_dq_full": cfg9.num_layers,
            "flash_attn_bwd_dkv_full": cfg9.num_layers, "adam": 2}
    n_tensors = 5 + 12 * cfg9.num_layers + 8
    for phase, padded in (("bert_grad_parity", False),
                          ("bert_padded_grad_parity", True)):
        reset_counts()
        loss_k, grads_k, params_k = bert_step(use_plain=False, padded=padded)
        torch.cuda.synchronize()
        read_counts(phase)
        got = {n: launches[n][phase] for n in counted}
        loss_p, grads_p, params_p = bert_step(use_plain=True, padded=padded)
        g_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                    / max(float(grads_p[n].abs().max()), 1e-30)
                    for n in grads_p)
        p_err = max(float((params_k[n] - params_p[n]).abs().max())
                    for n in params_p)
        l_err = abs(loss_k - loss_p) / abs(loss_p)
        log(f"[9] one f32 AdamW step of bert_base(num_layers=2) at [4, 128]"
            + (f", padded (valid lengths {mask9.sum(1).tolist()})"
               if padded else "") + f": loss {loss_k:.6f} (kernels) vs "
            f"{loss_p:.6f} (plain), rel err {l_err:.3g} (tol {LOSS_RTOL}); "
            f"worst grad err / max|grad| {g_err:.3g} over {len(grads_p)} "
            f"tensors (tol {GRAD_REL_TOL}); params after AdamW max err "
            f"{p_err:.3g} (atol {PARAM_ATOL}); launches {got}")
        if got != want:
            raise AssertionError(f"phase 9 launched {got}, expected {want}")
        if set(grads_k) != set(grads_p) or len(grads_p) != n_tensors:
            raise AssertionError("phase 9 did not see every gradient")
        if not (l_err <= LOSS_RTOL and g_err <= GRAD_REL_TOL
                and p_err <= PARAM_ATOL):
            raise AssertionError("BERT step through the kernels disagrees "
                                 "with the plain path")
        del grads_k, grads_p, params_k, params_p
    torch.cuda.empty_cache()

    at("10")
    # -- phase 10: BERT-base pretraining at full width, depth and batch -------
    model = bert_mod.BertForPretraining(bert_cfg, dtype=torch.float32, seed=6)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    step = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                             compute_dtype=torch.bfloat16)
    ids, mlm, nsp = bert_batch(bert_cfg, *BERT_SHAPE, gen, dev)
    batch10 = (ids, mlm, nsp)  # phase 23b's batch
    warm = [step((ids,), (mlm, nsp)) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tel.reset()
    reset_counts()
    n_steps = 20
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    t0 = time.perf_counter()
    losses = []
    for i in range(n_steps):
        marks[i].record()
        losses.append(step((ids,), (mlm, nsp)))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("bert_training")
    peak = torch.cuda.max_memory_allocated()
    all_losses = [float(x) for x in torch.stack(warm + losses)]
    step_ms = sorted(marks[i].elapsed_time(marks[i + 1])
                     for i in range(n_steps))
    got = {n: launches[n]["bert_training"] for n in counted}
    n_layers = bert_cfg.num_layers
    want = {**{n: 0 for n in counted},
            "layer_norm_fwd": (2 * n_layers + 2) * n_steps,
            "layer_norm_bwd": 2 * (2 * n_layers + 2) * n_steps,
            "flash_attn_fwd_full": n_layers * n_steps,
            "flash_attn_bwd_dq_full": n_layers * n_steps,
            "flash_attn_bwd_dkv_full": n_layers * n_steps,
            "adam": 2 * n_steps}
    attn_calls = tel.counter_value("attn/calls")
    samples = BERT_SHAPE[0] * n_steps
    bert_training = {
        "samples_per_s": samples / wall,
        "tokens_per_s": samples * BERT_SHAPE[1] / wall,
        "step_ms_p50": step_ms[n_steps // 2], "step_ms_min": step_ms[0],
        "step_ms_max": step_ms[-1], "peak_memory_bytes": peak,
        "losses": all_losses, "attn_calls": attn_calls}
    log(f"[10] trained bert_base bf16 (f32 params, no masters) + AdamW at "
        f"{BERT_SHAPE}: {bert_training['samples_per_s']:.1f} samples/s, "
        f"{bert_training['tokens_per_s']:.1f} tokens/s over {n_steps} steps,"
        f" step p50 {step_ms[n_steps // 2]:.2f} ms (events; min "
        f"{step_ms[0]:.2f}, max {step_ms[-1]:.2f}), peak memory "
        f"{peak / 2**30:.2f} GiB; loss {all_losses[0]:.4f} -> "
        f"{all_losses[-1]:.4f}; attn/calls {attn_calls}; launches "
        f"{got}")
    bert_training.update(profile_bert_training(step, (ids, mlm, nsp),
                                               n_layers))
    log("bert_training " + json.dumps(bert_training))
    if not all(np.isfinite(all_losses)):
        raise AssertionError(f"non-finite BERT loss: {all_losses}")
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"the BERT loss did not fall: {all_losses}")
    if got != want:
        raise AssertionError(f"BERT training launched {got}, expected {want}")
    if attn_calls != got["flash_attn_fwd_full"]:
        raise AssertionError(f"{attn_calls} attention calls but "
                             f"{got['flash_attn_fwd_full']} forward kernel "
                             "launches")
    # padded batches: the attention mask becomes the full kernels' key
    # bias. A bf16 forward through the kernels against the plain path,
    # then masked AdamW steps of the trained model.
    mask = (padding_bias(*BERT_SHAPE, gen, dev) == 0).long()
    types = torch.zeros_like(ids)
    model16 = bert_mod.BertForPretraining(bert_cfg, dtype=torch.bfloat16,
                                          seed=7).eval()
    with torch.no_grad():
        reset_counts()
        logits_k, nsp_k = model16(ids, types, mask)
        torch.cuda.synchronize()
        n_fwd = flash_tpu.flash_attention_full.launches
        with plain():
            logits_p, nsp_p = model16(ids, types, mask)
    e_mlm = float((logits_k.float() - logits_p.float()).abs().max())
    e_nsp = float((nsp_k.float() - nsp_p.float()).abs().max())
    log(f"[10] padded bf16 forward of bert_base at {BERT_SHAPE} (valid "
        f"lengths {mask.sum(1).tolist()}): MLM logits max err {e_mlm:.4g}, "
        f"NSP {e_nsp:.4g} against the plain path (atol {LOGITS_BF16_ATOL}); "
        f"{n_fwd} full-forward launches")
    if tuple(logits_k.shape) != (*BERT_SHAPE, bert_cfg.vocab_size) \
            or not bool(torch.isfinite(logits_k).all()):
        raise AssertionError(f"bad padded logits {tuple(logits_k.shape)}")
    if max(e_mlm, e_nsp) > LOGITS_BF16_ATOL:
        raise AssertionError("padded BERT logits disagree with the plain "
                             "path")
    if n_fwd != n_layers:
        raise AssertionError(f"the padded forward launched {n_fwd} full "
                             f"forwards, expected {n_layers}")
    del model16, logits_k, logits_p
    tel.reset()
    reset_counts()
    n_padded = 3
    padded_losses = [float(step((ids, types, mask), (mlm, nsp)))
                     for _ in range(n_padded)]
    torch.cuda.synchronize()
    read_counts("bert_padded")
    got = {n: launches[n]["bert_padded"] for n in counted}
    want = {n: v // n_steps * n_padded for n, v in want.items()}
    attn_calls = tel.counter_value("attn/calls")
    log(f"[10] {n_padded} padded AdamW steps: losses {padded_losses}; "
        f"attn/calls {attn_calls}; launches {got}")
    if not all(np.isfinite(padded_losses)):
        raise AssertionError(f"non-finite padded loss: {padded_losses}")
    if got != want:
        raise AssertionError(f"padded steps launched {got}, expected {want}")
    if attn_calls != got["flash_attn_fwd_full"]:
        raise AssertionError(f"{attn_calls} padded attention calls but "
                             f"{got['flash_attn_fwd_full']} forward kernel "
                             "launches")
    del step, model, opt
    torch.cuda.empty_cache()

    at("11")
    # -- the packed dK/dV experiment's own path -------------------------------
    reset_counts()
    packed = dkv_mod.main()
    torch.cuda.synchronize()
    read_counts("packed_dkv")
    log(f"[11] packed dK/dV experiment (b=8, H=16, L=1024, d=64): {packed}; "
        f"launches {launches['dkv_packed']['packed_dkv']}")
    if not (packed["err_dk"] <= PACKED_REL_TOL * packed["scale_dk"]
            and packed["err_dv"] <= PACKED_REL_TOL * packed["scale_dv"]):
        raise AssertionError("the packed dK/dV is not the causal gradient")

    at("12")
    # -- phase 12: GPT-2 345M trained as it is pretrained ------------------
    sumsq_t, adam_clip_t = check_clip_kernels(dev, cfg, fused, err)
    timings.append(sumsq_t)
    train_with_options(dev, gen, counted, launches, opt_mod, gpt_mod,
                       ParallelTrainStep, TrainStep, AdamW, lr_mod,
                       ClipGradByGlobalNorm)
    torch.cuda.empty_cache()

    at("13")
    # -- phase 13: the vision family -----------------------------------------
    lenet, lenet_adam_t = train_lenet(dev, gen, counted, launches, fused,
                                      plain, err)
    vision = {"lenet": lenet, "resnet_check": resnet_card_against_cpu(dev)}
    torch.cuda.empty_cache()
    vision["resnet_training"] = train_resnet(dev, counted, launches)
    log("vision " + json.dumps(vision))
    torch.cuda.empty_cache()

    at("14")
    # -- phase 14: the high-level API ------------------------------------------
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_hapi"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        hapi = {"lenet": train_hapi_lenet(dev, counted, launches, lenet,
                                          workdir)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    hapi["mobilenet_fp16"] = train_mobilenet_fp16(dev, counted, launches)
    torch.cuda.empty_cache()
    hapi["vgg_fp16"] = train_vgg_fp16(dev, counted, launches)
    log("hapi " + json.dumps(hapi))
    torch.cuda.empty_cache()

    at("15")
    # -- phase 15: guarded and fingerprinted training -------------------------
    resilience = {"pipeline": pipeline_phase(counted, launches)}
    torch.cuda.empty_cache()
    resilience["bert_fingerprint"], fold_t = bert_fingerprint_phase(
        counted, launches, tree_reduce, sanitizer, tree_leaves,
        corrupt_param_bit, fingerprint_digest, err)
    torch.cuda.empty_cache()
    ids = torch.randint(0, train_cfg.vocab_size, TRAIN_SHAPE, device=dev,
                        generator=gen)
    labels = torch.roll(ids, -1, dims=1)
    resilience["guard_gpt"], check_t = guard_phase(
        dev, counted, launches,
        gpt_mod.GPTForCausalLM(train_cfg, dtype=torch.float32, seed=4),
        lambda m: Adam(TRAIN_LR, parameters=m.parameters(),
                       multi_precision=True),
        ((ids, labels), (labels,)), lambda out, lbl: out, "gpt", fused, err)
    torch.cuda.empty_cache()
    bert_model = bert_mod.BertForPretraining(bert_cfg, dtype=torch.float32,
                                             seed=6)
    ids, mlm, nsp = bert_batch(bert_cfg, *BERT_SHAPE, gen, dev)
    resilience["guard_bert"], _ = guard_phase(
        dev, counted, launches, bert_model,
        lambda m: AdamW(TRAIN_LR, parameters=m.parameters(),
                        weight_decay=0.01),
        ((ids,), (mlm, nsp)), bert_model.loss_fn, "bert", fused, err)
    del bert_model
    log("resilience " + json.dumps(resilience))
    torch.cuda.empty_cache()

    at("16")
    # -- phase 16: long-context training ---------------------------------------
    longctx_t = check_longctx_attention(rnd, flash_tpu, attention, err)
    longctx, flash_phase = longctx_phase(counted, launches, bench_mod)
    longctx["remat"] = longctx_remat_phase(counted, launches, bench_mod)
    log("longctx " + json.dumps(longctx))
    torch.cuda.empty_cache()

    at("17")
    # -- phase 17: the static graph ---------------------------------------------
    static = {"resnet_check": static_resnet_check(dev)}
    torch.cuda.empty_cache()
    static["resnet_config2"] = static_resnet_bench(
        counted, launches, bench_mod,
        vision["resnet_training"]["losses"][0])
    torch.cuda.empty_cache()
    static["gpt_kernels"] = static_gpt_kernels(dev, gen, counted, launches,
                                               gpt_mod, plain, dense)
    log("static " + json.dumps(static))
    torch.cuda.empty_cache()

    at("18")
    # -- phase 18: serving breadth ---------------------------------------------
    serving, model = predictor_phase(dev, gen, counted, launches, gpt_mod,
                                     fused, flash_tpu, dense, err, smi)
    torch.cuda.empty_cache()
    # 18b-18d record the shapes they give #1 and #5; each is then held
    # against the plain versions
    with kernel_shapes(fused, flash_tpu) as seen:
        serving["benches"] = serving_benches_phase(counted, launches,
                                                   bench_mod, smi)
        torch.cuda.empty_cache()
        serving["decode_profile"] = decode_profile_phase(
            counted, launches, bench_mod, smi)
        serving["spec"] = spec_phase(dev, counted, launches, gpt_mod, smi)
        serving["int8"] = int8_phase(dev, counted, launches, model, smi)
    del model
    serving["kernel_shapes"] = check_kernel_shapes(dev, gen, seen, fused,
                                                   flash_tpu, err)
    log("serving_breadth " + json.dumps(serving))
    torch.cuda.empty_cache()

    at("19")
    # -- phase 19: the parameter surface (19a ran after phase 3c) ------------
    surface["resnet_o2"] = o2_resnet_phase(dev, counted, launches)
    torch.cuda.empty_cache()
    surface["sparse"] = sparse_phase(dev, counted, launches)
    surface["param_lr"] = param_lr_phase(dev, gen, counted, launches,
                                         gpt_mod, norm_mod, plain)
    log("parameter_surface " + json.dumps(surface))
    torch.cuda.empty_cache()

    at("20")
    # -- phase 20: the rest of nn/ ------------------------------------------
    nn_slice = nn_slice_phase(dev, counted, launches, smi)
    log("nn_slice " + json.dumps(nn_slice))

    at("21")
    # -- phase 21: the tensor API -------------------------------------------------
    tensor_api = tensor_api_phase(dev, counted, launches, training, smi)
    log("tensor_api " + json.dumps(tensor_api))

    at("22")
    # -- phase 22: detection, CRF tagging and the hapi tail -------------------
    detection_crf = detection_crf_phase(dev, counted, launches, training,
                                        bert_training, smi)
    log("detection_crf " + json.dumps(detection_crf))

    at("23")
    # -- phase 23: fp16 training and second derivatives through #1-#6 ---------
    fp16_slice = fp16_slice_phase(dev, gen, counted, launches, gpt_mod,
                                  bert_mod, plain, batch8, training, batch10,
                                  bert_training, smi)
    log("fp16_slice " + json.dumps(fp16_slice))

    at("kernels line")
    # -- the kernels line and the result --------------------------------------
    def timed(kernel, shape):
        return next(t for t in timings if t["kernel"] == kernel
                    and t["shape"] == shape)

    bert_attn = list(BERT_ATTN_SHAPE)
    options_paths = tuple(f"options_{p}" for p in REMAT_POLICIES) + (
        "options_train_step", "options_parallel")
    kernels = []
    # each kernel with the phases (main paths) that must have launched it
    for name, source, replaces, t, paths in (
            ("layer_norm_fwd", "paddle_tpu_torch/csrc/layer_norm.cu",
             "paddle_tpu/ops/fused.py:25",
             timed("layer_norm_fwd", list(LN_TIMED[0])),
             ("dense_forward", "training", "bert_training", "longctx",
              "static_gpt", "static_to_static", "predictor_layer",
              "predictor_export", "serving_spec", "serving_int8",
              "nmt_parity", "nmt_f32", "nmt_bf16", "nmt_beam",
              "nn_breadth", "tensor_path", "bert_crf", "gpt_fused_head")),
            ("flash_attn_fwd", "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
             "paddle_tpu/ops/flash_tpu.py:43",
             timed("flash_attn_fwd", list(GPT_ATTN_SHAPE)),
             ("dense_forward", "training", flash_phase, "static_gpt",
              "static_to_static", "predictor_layer", "predictor_export",
              "bench_decode", "tensor_path", "gpt_fused_head")),
            ("layer_norm_bwd", "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
             "paddle_tpu/ops/fused.py:34",
             timed("layer_norm_bwd", list(LN_TIMED[0])),
             ("training", "bert_training", "longctx", "static_gpt",
              "nmt_parity", "nmt_f32", "nmt_bf16", "tensor_path",
              "bert_crf", "gpt_fused_head")),
            ("flash_attn_bwd_dq", "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             "paddle_tpu/ops/flash_tpu.py:83",
             timed("flash_attn_bwd_dq", [8, 1024, 16, 64]),
             ("training", flash_phase, "static_gpt", "tensor_path",
              "gpt_fused_head")),
            ("flash_attn_bwd_dkv", "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             "paddle_tpu/ops/flash_tpu.py:118",
             timed("flash_attn_bwd_dkv", [8, 1024, 16, 64]),
             ("training", flash_phase, "static_gpt", "tensor_path",
              "gpt_fused_head")),
            ("adam", "paddle_tpu_torch/csrc/adam.cu",
             "paddle_tpu/ops/fused.py:172",
             next(t for t in timings if t["kernel"] == "adam"),
             ("training", "bert_training") + options_paths
             + ("lenet_training", "lenet_mnist", "hapi_lenet", "pipeline",
                "bert_fingerprint_0", "guard_gpt", "guard_bert",
                "longctx", "static_gpt", "param_resnet_o2",
                "param_trainstep_o2", "param_sparse_adam_dense",
                "param_sparse_adam_sparse", "param_lr", "nmt_parity",
                "nmt_f32", "nmt_bf16", "tensor_path", "bert_crf",
                "gpt_fused_head")),
            ("grad_sumsq", "paddle_tpu_torch/csrc/adam.cu",
             "paddle_tpu/nn/clip.py:111", sumsq_t,
             options_paths + ("param_sparse_adam_global_clip_dense",
                              "param_sparse_adam_global_clip_sparse",
                              "rnn_lstm", "rnn_gru")),
            ("flash_attn_fwd_full", "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
             "paddle_tpu/ops/attention.py:156",
             timed("flash_attn_fwd_full", bert_attn),
             ("bert_training", "bert_padded", "bert_crf")),
            ("flash_attn_bwd_dq_full",
             "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             "paddle_tpu/ops/attention.py:297",
             timed("flash_attn_bwd_dq_full", bert_attn),
             ("bert_training", "bert_padded", "bert_crf")),
            ("flash_attn_bwd_dkv_full",
             "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             "paddle_tpu/ops/attention.py:297",
             timed("flash_attn_bwd_dkv_full", bert_attn),
             ("bert_training", "bert_padded", "bert_crf")),
            ("dkv_packed", "paddle_tpu_torch/csrc/dkv_packed.cu",
             "tools/experiments/dkv_packed_kernel.py:43",
             timed("dkv_packed", list(PACKED_TIMED[0])),
             ("packed_dkv",)),
            ("adam_check", "paddle_tpu_torch/csrc/adam.cu",
             "paddle_tpu/core/sanitizer.py:57", check_t,
             ("guard_gpt", "guard_bert")),
            ("tree_reduce", "paddle_tpu_torch/csrc/tree_reduce.cu",
             "paddle_tpu/core/sanitizer.py:102", fold_t,
             ("bert_fingerprint_0", "bert_fingerprint_1",
              "bert_fingerprint_bench"))):
        by_phase = launches[name]
        if any(by_phase[phase] == 0 for phase in paths):
            raise AssertionError(f"{name} never launched on the main path "
                                 f"({', '.join(paths)}): {by_phase}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "launches_static": sum(by_phase.get(p, 0) for p in (
                "static_resnet", "static_gpt", "static_to_static")),
            "launches_predictor": sum(by_phase.get(p, 0) for p in (
                "predictor_layer", "predictor_export")),
            "launches_nn_slice": sum(by_phase.get(p, 0) for p in (
                "nmt_parity", "nmt_f32", "nmt_bf16", "nmt_beam",
                "rnn_lstm", "rnn_gru", "nn_breadth")),
            "launches_tensor_api": sum(by_phase.get(p, 0) for p in (
                "tensor_breadth", "tensor_path")),
            "launches_detection_crf": sum(by_phase.get(p, 0) for p in (
                "ssd_serve", "bert_crf", "gpt_fused_head")),
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "device_l2_ms": t.get("device_l2_ms"), "shape": t["shape"],
            "dtype": t["dtype"]})
        at_8192 = [t for t in longctx_t if t["kernel"] == name]
        if at_8192:
            kernels[-1]["longctx"] = {k: at_8192[0][k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")}
        if name == "adam":
            kernels[-1]["lenet"] = {k: lenet_adam_t[k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")}
            fp16 = surface["adam_fp16"]
            kernels[-1]["fp16"] = {k: fp16[k] for k in (
                "shape", "dtype", "ms", "device_ms", "plain_ms",
                "library_ms", "library_device_ms", "bound_ms", "bound_by")}
            kernels[-1]["note_fp16"] = (
                "the fp16 instance (dtype code 2: fp16 gradients and "
                "resident copies over f32 masters) with the per-tensor "
                "learning-rate scale column, phase 19a over GPT-2 345M's "
                "292 tensors at scales 0-2; library_ms is "
                "torch.optim.Adam(fused=True) over the f32 masters")
            kernels[-1]["with_clip_ms"] = adam_clip_t["ms"]
            kernels[-1]["with_clip_device_ms"] = adam_clip_t["device_ms"]
            kernels[-1]["with_clip_update_device_ms"] = \
                adam_clip_t["adam_device_ms"]
        if name == "grad_sumsq":
            kernels[-1]["note"] = (
                "the global-norm clip's sum-of-squares pass, run inside "
                "fused_adam_step; it replaces the XLA-level "
                "clip_grads_global_norm_raw, no Pallas kernel; library_ms "
                f"is {sumsq_t['library']}")
        if name == "adam_check":
            kernels[-1]["note"] = (
                "the guarded step's check pass of the Adam kernel (#7), run "
                "before its update on GPT-2 345M's 292 tensors (bf16 grads, "
                "f32 masters); no Pallas kernel: it replaces the XLA-level "
                "finite_flags / select_if_finite (sanitizer.py:38, :57); no "
                "one PyTorch call computes it (library_ms null)")
        if name == "tree_reduce":
            kernels[-1]["note"] = (
                "the multi-tensor fold of BERT-base's state (params, AdamW "
                "moments and beta powers); no Pallas kernel: it replaces "
                "the XLA-level tree_fingerprint (sanitizer.py:102) and "
                "finite_flags; library_ms is torch._foreach_norm(ord=1) "
                "over the float leaves, the abs-sum part alone: no torch "
                "call folds XOR")
        if name == "dkv_packed":
            kernels[-1]["note"] = (
                "the causal dK/dV kernel (flash_attn_bwd_dkv) at the same "
                f"shape in this run: device {t['dkv_device_ms']:.4f} ms; "
                f"library_ms is SDPA's whole causal backward (device "
                f"{t['library_device_ms']:.4f} ms)")
    # the fp16 instances of #1-#6 (23d's times, 23a's and 23b's launches)
    for name, source, replaces, paths in (
            ("layer_norm_fwd", "paddle_tpu_torch/csrc/layer_norm.cu",
             "paddle_tpu/ops/fused.py:25", ("fp16_gpt", "fp16_bert")),
            ("layer_norm_bwd", "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
             "paddle_tpu/ops/fused.py:34", ("fp16_gpt", "fp16_bert")),
            ("flash_attn_fwd", "paddle_tpu_torch/csrc/flash_attn_fwd_f16.cu",
             "paddle_tpu/ops/flash_tpu.py:43", ("fp16_gpt",)),
            ("flash_attn_bwd_dq",
             "paddle_tpu_torch/csrc/flash_attn_bwd_f16.cu",
             "paddle_tpu/ops/flash_tpu.py:83", ("fp16_gpt",)),
            ("flash_attn_bwd_dkv",
             "paddle_tpu_torch/csrc/flash_attn_bwd_f16.cu",
             "paddle_tpu/ops/flash_tpu.py:118", ("fp16_gpt",)),
            ("flash_attn_fwd_full",
             "paddle_tpu_torch/csrc/flash_attn_fwd_f16.cu",
             "paddle_tpu/ops/attention.py:156",
             ("fp16_bert", "fp16_bert_padded")),
            ("flash_attn_bwd_dq_full",
             "paddle_tpu_torch/csrc/flash_attn_bwd_f16.cu",
             "paddle_tpu/ops/attention.py:297",
             ("fp16_bert", "fp16_bert_padded")),
            ("flash_attn_bwd_dkv_full",
             "paddle_tpu_torch/csrc/flash_attn_bwd_f16.cu",
             "paddle_tpu/ops/attention.py:297",
             ("fp16_bert", "fp16_bert_padded"))):
        by_phase = {p: launches[name][p]
                    for p in ("fp16_gpt", "fp16_bert", "fp16_bert_padded")}
        if any(by_phase[p] == 0 for p in paths):
            raise AssertionError(f"{name}'s fp16 instance never launched on "
                                 f"its path ({', '.join(paths)}): "
                                 f"{by_phase}")
        rows = [t for t in fp16_t if t["kernel"] == f"{name}_fp16"]
        t = rows[0]  # GPT's shape for the LayerNorms
        kernels.append({
            "name": f"{name}_fp16", "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": fp16_err[f"{name}_fp16"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "shape": t["shape"], "dtype": "float16"})
        if len(rows) > 1:
            kernels[-1]["bert_shape"] = {k: rows[1][k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")}
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
