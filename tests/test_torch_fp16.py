"""The fp16 instances of the LayerNorm and attention kernels (#1-#6) and
the engine's fp16 compute dtype.

On the CPU: ``ParallelTrainStep(compute_dtype=torch.float16)`` (f32
masters, fp16 residents) against the reference's engine with
``compute_dtype=jnp.float16`` over three steps of a 2-layer GPT-2 tiny on
the reference's weights; the fp16 plain versions (``_ln_reference``,
``_ln_bwd_reference``, ``_flash_reference``, ``_bwd_plain`` with fp16
operands) against the reference's own kernels run on fp16 operands in
interpret mode. On the card (``cuda``): each fp16 kernel against its plain
version at GPT's and BERT's shapes."""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.ops import flash_tpu as jflash
from paddle_tpu.ops import fused as jfused
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.ops import flash_tpu as tflash
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.text.models import gpt as tgpt
from test_torch_flash import _pallas_bwd
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

LR = 1e-3
STEPS = 3
# fp16 keeps 11 significant bits to bf16's 8: the reference and the port
# round activations at different places (the reference's one-pass
# LayerNorm, its bf16-free fp16 matmuls against torch's), a few fp16 ulps
# of the loss (one ulp is 2^-8 at 4-8)
FP16_LOSS_TOL = 0.01
# fp16 masters: each step moves an element by at most ~lr, and an
# fp16-rounded gradient can flip its sign: at most 2·lr per step
FP16_PARAM_TOL = 2 * LR * STEPS
# the plain versions against the reference's kernels on the same fp16
# values: an fp16 output one ulp apart at most (2^-10 relative), and the
# elements that sit at a rounding boundary of P or dS (f32 sums in other
# orders) moved by 2^-11 of themselves: 2^-14 of the tensor's largest
# magnitude
FP16_RTOL, FP16_REL_ATOL = 2.0 ** -10, 2.0 ** -14


def _gpt_cfg(mod):
    return mod.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                         num_heads=4, max_position_embeddings=256,
                         hidden_dropout=0.0, attention_dropout=0.0)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _np(params):
    return {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}


@pytest.fixture(scope="module")
def fp16_runs():
    """Three steps of each engine in fp16 master mode from one set of
    weights: (reference losses, reference params, port losses, port
    params, each resident's dtype, its master's and whether it is its
    master's cast)."""
    paddle.seed(7)
    ref_model = jgpt.GPTForCausalLM(_gpt_cfg(jgpt))
    p0 = _np(jfunc.get_params(ref_model))
    ref_opt = paddle.optimizer.Adam(learning_rate=LR,
                                    parameters=ref_model.parameters(),
                                    multi_precision=True)
    ref_step = JStep(ref_model, loss_fn=lambda out, lbl: out,
                     optimizer=ref_opt,
                     mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                     compute_dtype=jnp.float16)
    ids, labels = _batch()
    ref_losses = [float(np.asarray(ref_step((ids, labels),
                                            (labels,)).numpy()))
                  for _ in range(STEPS)]
    ref_step.sync_to_layer()
    ref_params = _np(jfunc.get_params(ref_model))

    model = load_jax_params(
        tgpt.GPTForCausalLM(_gpt_cfg(tgpt), device="cpu"), p0)
    opt = Adam(LR, parameters=model.parameters(), multi_precision=True)
    step = ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                             compute_dtype=torch.float16)
    tids, tlabels = (torch.from_numpy(a).long() for a in _batch())
    losses = [step((tids, tlabels), (tlabels,)) for _ in range(STEPS)]
    # the residents after the last step, against the masters
    residents = [(p.dtype, opt.state_for(p)["master"].dtype,
                  torch.equal(p, opt.state_for(p)["master"].half()))
                 for p in model.parameters()]
    step.sync_to_layer()
    params = _np({k: v.float() for k, v in get_params(model).items()})
    return ref_losses, ref_params, losses, params, residents


@pytest.mark.parametrize("i", range(STEPS))
def test_fp16_engine_loss_of_each_step_matches_reference(fp16_runs, i):
    ref_losses, _, losses, *_ = fp16_runs
    assert losses[i].dtype == torch.float32 and losses[i].dim() == 0
    assert abs(float(losses[i]) - ref_losses[i]) <= FP16_LOSS_TOL, \
        (float(losses[i]), ref_losses[i])


def test_fp16_engine_params_after_three_steps_match_reference(fp16_runs):
    _, ref_params, losses, params, *_ = fp16_runs
    assert float(losses[-1]) < float(losses[0])
    assert set(params) == set(ref_params)
    for name, ref in ref_params.items():
        err = float(np.abs(params[name] - ref).max())
        assert err <= FP16_PARAM_TOL, (name, err)


def test_fp16_engine_keeps_fp16_residents_over_f32_masters(fp16_runs):
    """Master mode as the reference's ``resident()``: after the steps the
    float parameters are fp16 on the layer, their masters f32 in the
    optimizer, and each resident is its master's fp16 cast."""
    residents = fp16_runs[-1]
    assert {r[:2] for r in residents} == {(torch.float16, torch.float32)}
    assert all(r[2] for r in residents)


def test_engine_refuses_a_compute_dtype_that_is_not_a_float():
    model = tgpt.GPTForCausalLM(_gpt_cfg(tgpt), device="cpu")
    opt = Adam(LR, parameters=model.parameters())
    with pytest.raises(TypeError, match="not a float"):
        ParallelTrainStep(model, lambda out, lbl: out, opt, device="cpu",
                          compute_dtype=torch.int32)


# ---------------------------------------------------------------------------
# the plain versions in fp16 against the reference's kernels on fp16
# operands (interpret mode)
# ---------------------------------------------------------------------------
def _fp16(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float16)


def _close(got, want, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    bad = np.abs(got - want) > FP16_RTOL * np.abs(want) + FP16_REL_ATOL * top
    assert not bad.any(), (name, float(np.abs(got - want).max()), top)


def test_fp16_layer_norm_plain_versions_match_reference_kernels():
    rng = np.random.RandomState(5)
    x, g = _fp16(rng, 32, 128), _fp16(rng, 32, 128)
    w, b = _fp16(rng, 128, scale=0.5) + 1, _fp16(rng, 128, scale=0.1)
    y = tfused._ln_reference(*(torch.from_numpy(a) for a in (x, w, b)))
    assert y.dtype == torch.float16
    with jax.enable_x64(False):
        want = pl.pallas_call(
            functools.partial(jfused._ln_kernel, eps=1e-5),
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float16),
            interpret=True)(jnp.asarray(x), jnp.asarray(w)[None],
                            jnp.asarray(b)[None])
    _close(y.numpy(), want, "y")
    dx, dw, db = tfused._ln_bwd_reference(
        *(torch.from_numpy(a) for a in (x, w, g)))
    assert dx.dtype == dw.dtype == db.dtype == torch.float16
    with jax.enable_x64(False):
        wdx, wdw, wdb = pl.pallas_call(
            functools.partial(jfused._ln_bwd_kernel, eps=1e-5), grid=(1,),
            out_shape=[jax.ShapeDtypeStruct(x.shape, jnp.float16),
                       jax.ShapeDtypeStruct((8, 128), jnp.float32),
                       jax.ShapeDtypeStruct((8, 128), jnp.float32)],
            interpret=True)(jnp.asarray(x), jnp.asarray(w)[None],
                            jnp.asarray(g))
    _close(dx.numpy(), wdx, "dx")
    _close(dw.numpy(), np.asarray(wdw)[0].astype(np.float16), "dw")
    _close(db.numpy(), np.asarray(wdb)[0].astype(np.float16), "db")


def _qkv16(shape, seed, n=3):
    rng = np.random.RandomState(seed)
    return [_fp16(rng, *shape) for _ in range(n)]


# d = 64 only: the reference's kernels round q·scale to the operand type,
# which is exact at 1/sqrt(64) and which the port (like its kernels) does
# not do
@pytest.mark.parametrize("b,L,H,d,block", [(1, 64, 2, 64, 64),
                                           (2, 64, 1, 64, 32)])
def test_fp16_flash_plain_versions_match_reference_kernels(b, L, H, d,
                                                           block):
    """The forward against ``_fwd_kernel`` (which rounds P to fp16 as the
    P·V operand, where ``_flash_reference`` keeps f32: a P rounding of
    2^-11 of each term, 2^-9 of the output's largest magnitude) and the
    backward with fp16 operands against ``_dq_kernel``/``_dkv_kernel``."""
    q, k, v, do = _qkv16((b, L, H, d), seed=L + d, n=4)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tflash._flash_reference(tq, tk, tv)
    assert out.dtype == torch.float16
    r3 = lambda a: jnp.asarray(a.reshape(b, L, H * d))
    full = pl.BlockSpec((1, L, H * d), lambda ib, iq: (ib, 0, 0))
    blk = pl.BlockSpec((1, block, H * d), lambda ib, iq: (ib, iq, 0))
    with jax.enable_x64(False):
        wout, wlse = pl.pallas_call(
            functools.partial(jflash._fwd_kernel, H=H, d=d, bq=block,
                              bk=block, scale=1.0 / math.sqrt(d)),
            grid=(b, L // block), in_specs=[blk, full, full],
            out_specs=[blk, pl.BlockSpec((1, H, block),
                                         lambda ib, iq: (ib, 0, iq))],
            out_shape=[jax.ShapeDtypeStruct((b, L, H * d), jnp.float16),
                       jax.ShapeDtypeStruct((b, H, L), jnp.float32)],
            interpret=True)(r3(q), r3(k), r3(v))
    wout = np.asarray(wout, np.float32).reshape(b, L, H, d)
    err = float(np.abs(out.float().numpy() - wout).max())
    assert err <= 2.0 ** -9 * float(np.abs(wout).max()), err
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse), atol=1e-3)
    grads = tflash._flash_bwd_reference(tq, tk, tv, out, lse, tdo,
                                        operand_dtype=torch.float16)
    f = lambda t: t.float().numpy()
    want = _pallas_bwd(f(tq), f(tk), f(tv), f(out), lse.numpy(), f(tdo),
                       block, jnp.float16)
    for got, w, name in zip(grads, want, ("dq", "dk", "dv")):
        assert got.dtype == torch.float16
        _close(f(got), w, name)


def test_fp16_operands_round_p_and_ds_to_fp16_not_bf16():
    """The plain backward rounds P and dS to the operand type it is
    given: fp16's rounding is finer than bf16's."""
    q, k, v, do = (torch.from_numpy(a).float()
                   for a in _qkv16((1, 64, 2, 32), seed=3, n=4))
    out, lse = tflash._flash_reference(q, k, v)
    args = (q, k, v, out, lse, do)
    as16 = tflash._flash_bwd_reference(*args, operand_dtype=torch.float16)
    asbf = tflash._flash_bwd_reference(*args, operand_dtype=torch.bfloat16)
    exact = tflash._flash_bwd_reference(*args)
    for a16, abf, ex in zip(as16, asbf, exact):
        assert 0 < (a16 - ex).abs().max() < (abf - ex).abs().max()


# ---------------------------------------------------------------------------
# on the card: each fp16 kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# fp16 outputs rounded once from f32 in both: one fp16 ulp apart at most,
# a few 2^-10 of |ref|, over sums in another order
CUDA_LN_TOL = dict(atol=4e-3, rtol=2.0 ** -9)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hidden", [(8192, 1024), (4096, 768),
                                         (37, 100)])
def test_cuda_fp16_layer_norm_matches_plain(cuda_device, rows, hidden):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x, g = (torch.randn(rows, hidden, device=cuda_device, generator=gen)
            .half() for _ in range(2))
    w = (1 + 0.1 * torch.randn(hidden, device=cuda_device,
                                generator=gen)).half()
    b = (0.1 * torch.randn(hidden, device=cuda_device, generator=gen)).half()
    n_fwd, n_bwd = (tfused.fused_layer_norm.launches,
                    tfused.layer_norm_bwd.launches)
    y = tfused.fused_layer_norm(x, w, b)
    dx, dw, db = tfused.layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    assert tfused.fused_layer_norm.launches == n_fwd + 1
    assert tfused.layer_norm_bwd.launches == n_bwd + 2
    assert y.dtype == dx.dtype == dw.dtype == torch.float16
    torch.testing.assert_close(y, tfused._ln_reference(x, w, b),
                               **CUDA_LN_TOL)
    rdx, rdw, rdb = tfused._ln_bwd_reference(x, w, g)
    torch.testing.assert_close(dx, rdx, **CUDA_LN_TOL)
    # dw, db: sums over the rows in another order, then one rounding
    for got, want in ((dw, rdw), (db, rdb)):
        top = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -9 * top + 1e-3


# the forward against the f32-P plain version: P rounded to fp16 as the
# P·V operand, 2^-11 of each term (bf16's tolerance scaled by 8)
CUDA_FP16_OUT_TOL = 2e-3


def _cuda_qkv(shape, dev, seed, n=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*shape, device=dev, generator=gen).half()
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,biased", [
    ((8, 1024, 16, 64), True, False), ((2, 77, 4, 128), True, False),
    ((1, 100, 2, 32), True, False), ((32, 128, 12, 64), False, True),
    ((2, 77, 4, 128), False, False)])
def test_cuda_fp16_attention_matches_plain(cuda_device, shape, causal,
                                           biased):
    q, k, v, dout = _cuda_qkv(shape, cuda_device, shape[1], n=4)
    bias = None
    if biased:
        bias = torch.zeros(shape[0], shape[1], device=cuda_device)
        for i in range(shape[0]):
            bias[i, shape[1] - 7 * i % shape[1]:] = -1e9
    if causal:
        out, lse = tflash.flash_attention_blhd(q, k, v)
        dq, delta = tflash.flash_bwd_dq(q, k, v, dout, lse, out)
        dk, dv = tflash.flash_bwd_dkv(q, k, v, dout, lse, delta)
    else:
        out, lse = tflash.flash_attention_full(q, k, v, key_bias=bias)
        dq, delta = tflash.flash_bwd_dq_full(q, k, v, dout, lse, out, bias)
        dk, dv = tflash.flash_bwd_dkv_full(q, k, v, dout, lse, delta, bias)
    torch.cuda.synchronize()
    ref_out, ref_lse = tflash._flash_reference(q, k, v, causal, bias)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=CUDA_FP16_OUT_TOL,
                               rtol=CUDA_FP16_OUT_TOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    ref = tflash._flash_bwd_reference(q, k, v, out, lse, dout, causal, bias,
                                      operand_dtype=torch.float16)
    for got, want, name in zip((dq, dk, dv), ref, ("dq", "dk", "dv")):
        assert got.dtype == torch.float16
        got, want = got.float(), want.float()
        top = float(want.abs().max())
        # one fp16 ulp of each element, and P or dS elements at a
        # rounding boundary flipped between the sum orders
        bad = (got - want).abs() > 2.0 ** -10 * want.abs() + 2.0 ** -12 * top
        assert not bool(bad.any()), (name, float((got - want).abs().max()),
                                     top)
