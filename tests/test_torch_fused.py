"""Port LayerNorm (paddle_tpu_torch.ops.fused) against the reference:
the plain forward against the Pallas `_ln_kernel` run in interpret mode
and against `_ln_reference`; the plain backward against `_ln_bwd_kernel`
in interpret mode, against `jax.vjp` of `_ln_reference` and of the GPT
model's `_ln_manual`; the CUDA kernels against the plain path on a card
(marked `cuda`)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu.nn.functional.norm import _ln_manual
from paddle_tpu.ops import fused as jfused
from paddle_tpu_torch.ops import fused as tfused
import torch_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-5  # f32 on both sides; two-pass statistics, different sum order
# backward: dw/db are sums over every row (up to 512 terms of |g·x̂| ~ 3)
BWD_TOL = 2e-5
# against the model's one-pass (E[x²] − E[x]²) LayerNorm of the reference
MANUAL_TOL = 1e-4


def _pallas_ln(x, w, b, eps, block_rows):
    """The reference's own `_ln_kernel`, launched as `_fused_ln_fwd_impl`
    launches it, in interpret mode."""
    rows, hidden = x.shape
    with jax.enable_x64(False):
        return np.asarray(pl.pallas_call(
            functools.partial(jfused._ln_kernel, eps=eps),
            grid=(rows // block_rows,),
            in_specs=[pl.BlockSpec((block_rows, hidden), lambda i: (i, 0)),
                      pl.BlockSpec((hidden,), lambda i: (0,)),
                      pl.BlockSpec((hidden,), lambda i: (0,))],
            out_specs=pl.BlockSpec((block_rows, hidden), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((rows, hidden), jnp.float32),
            interpret=True)(x, w, b))


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    return x, w, b


def _port(x, w, b, eps=1e-5):
    return tfused.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), eps).numpy()


@pytest.mark.parametrize("rows,hidden,block_rows,eps", [
    (256, 128, 128, 1e-5), (512, 256, 256, 1e-5), (128, 384, 64, 1e-6),
    (64, 1024, 64, 1e-5)])
def test_matches_pallas_kernel_in_interpret_mode(rows, hidden, block_rows,
                                                 eps):
    x, w, b = _inputs((rows, hidden), seed=rows + hidden)
    ref = _pallas_ln(x, w, b, eps, block_rows)
    np.testing.assert_allclose(_port(x, w, b, eps), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(
        _port(x, w, b, eps),
        np.asarray(jfused._ln_reference(x, w, b, eps)), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 128), (3, 77), (2, 5, 96),
                                   (7, 1024), (1, 1, 4096)])
def test_ragged_rows_match_reference(shape):
    """Row counts the TPU kernel's gate refused (decode batches of 1-8)."""
    x, w, b = _inputs(shape, seed=sum(shape))
    ref = np.asarray(jfused._ln_reference(x, w, b, 1e-5))
    got = _port(x, w, b)
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_bf16_plain_path_rounds_once_from_f32():
    x, w, b = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((4, 256), seed=3))
    got = tfused.fused_layer_norm(x, w, b)
    assert got.dtype == torch.bfloat16
    exact = tfused._ln_reference(x.float(), w.float(), b.float())
    assert torch.equal(got, exact.to(torch.bfloat16))


def test_cpu_path_launches_no_kernel():
    before = tfused.fused_layer_norm.launches
    _port(*_inputs((2, 64), seed=0))
    assert tfused.fused_layer_norm.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.fused_layer_norm(x, w, w)


def _pallas_ln_bwd(x, w, g, eps, block_rows):
    """The reference's own `_ln_bwd_kernel`, launched as `_fused_ln_bwd`
    launches it, in interpret mode; returns (dx, dw, db)."""
    rows, hidden = x.shape
    row_spec = pl.BlockSpec((block_rows, hidden), lambda i: (i, 0))
    acc_spec = pl.BlockSpec((8, hidden), lambda i: (0, 0))
    with jax.enable_x64(False):
        dx, dw, db = pl.pallas_call(
            functools.partial(jfused._ln_bwd_kernel, eps=eps),
            grid=(rows // block_rows,),
            in_specs=[row_spec, pl.BlockSpec((hidden,), lambda i: (0,)),
                      row_spec],
            out_specs=[row_spec, acc_spec, acc_spec],
            out_shape=[jax.ShapeDtypeStruct((rows, hidden), jnp.float32),
                       jax.ShapeDtypeStruct((8, hidden), jnp.float32),
                       jax.ShapeDtypeStruct((8, hidden), jnp.float32)],
            interpret=True)(x, w, g)
    return np.asarray(dx), np.asarray(dw)[0], np.asarray(db)[0]


def _port_bwd(x, w, g, eps=1e-5):
    return [t.numpy() for t in tfused._ln_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), eps)]


def _jax_vjp(fn, x, w, b, g):
    _, vjp = jax.vjp(fn, x, w, b)
    return [np.asarray(t) for t in vjp(g)]


@pytest.mark.parametrize("rows,hidden,block_rows", [
    (512, 256, 256), (256, 128, 128)])
def test_backward_matches_pallas_kernel_in_interpret_mode(rows, hidden,
                                                          block_rows):
    x, w, _ = _inputs((rows, hidden), seed=rows)
    g = np.random.RandomState(hidden).randn(rows, hidden).astype(np.float32)
    ref = _pallas_ln_bwd(x, w, g, 1e-5, block_rows)
    for got, want, name in zip(_port_bwd(x, w, g), ref, ("dx", "dw", "db")):
        np.testing.assert_allclose(got, want, atol=BWD_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(1, 128), (3, 77), (2, 5, 96), (7, 1024)])
def test_backward_ragged_rows_match_vjp_of_reference(shape):
    """Row counts the TPU kernel's gate refused."""
    x, w, b = _inputs(shape, seed=sum(shape) + 1)
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    ref = _jax_vjp(lambda a, w_, b_: jfused._ln_reference(a, w_, b_, 1e-5),
                   x, w, b, g)
    for got, want, name in zip(_port_bwd(x, w, g), ref, ("dx", "dw", "db")):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=BWD_TOL, rtol=0,
                                   err_msg=name)


def _autograd(fn, x, w, b, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = fn(*ts)
    return [t.numpy() for t in torch.autograd.grad(y, ts,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("shape", [(2, 64, 128), (5, 256)])
def test_autograd_matches_vjp_of_the_models_manual_layer_norm(shape):
    """The GPT model's LayerNorm in the reference is `_ln_manual`
    (one-pass statistics, hand-written backward)."""
    x, w, b = _inputs(shape, seed=11)
    g = np.random.RandomState(4).randn(*shape).astype(np.float32)
    ref = _jax_vjp(lambda a, w_, b_: _ln_manual(a, w_, b_, 1e-5), x, w, b, g)
    got = _autograd(tfused.fused_layer_norm, x, w, b, g)
    for a, want, name in zip(got, ref, ("dx", "dw", "db")):
        np.testing.assert_allclose(a, want, atol=MANUAL_TOL, rtol=0,
                                   err_msg=name)


def test_cpu_backward_matches_autograd_of_the_plain_forward():
    x, w, b = _inputs((33, 96), seed=5)
    g = np.random.RandomState(6).randn(33, 96).astype(np.float32)
    got = _autograd(tfused.fused_layer_norm, x, w, b, g)
    ref = _autograd(tfused._ln_reference, x, w, b, g)
    for a, want in zip(got, ref):
        np.testing.assert_allclose(a, want, atol=TOL, rtol=0)


def test_cpu_backward_launches_no_kernel():
    before = tfused.layer_norm_bwd.launches
    x, w, b = _inputs((4, 32), seed=0)
    _autograd(tfused.fused_layer_norm, x, w, b, x)
    assert tfused.layer_norm_bwd.launches == before


def test_backward_on_other_devices_raises():
    x = torch.empty(2, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.layer_norm_bwd(x, w, x)


# every width of the port's model configurations: gpt2_tiny / bert_tiny,
# BERT-base and GPT-2 small, GPT-2 345M and BERT-large, ERNIE 1.5B
CONFIG_WIDTHS = (128, 768, 1024, 2048)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", CONFIG_WIDTHS)
@pytest.mark.parametrize("backward", [False, True])
def test_plan_takes_every_config_width_to_the_warp_kernels(hidden, dtype,
                                                            backward):
    plan = tfused._ln_plan(8192, hidden, dtype, 16, backward)
    assert plan.variant == "warp"
    assert plan.rows_per_block == tfused._LN_WARP_ROWS


@pytest.mark.parametrize("hidden,dtype,alignment,why", [
    (1020, torch.bfloat16, 16, "not a multiple of 8 bf16"),
    (1022, torch.float32, 16, "not a multiple of 4 f32"),
    (77, torch.float32, 16, "not a multiple of 4 f32"),
    (4096, torch.bfloat16, 16, "over 64 values a lane"),
    (2052, torch.float32, 16, "over 64 values a lane"),
    (1024, torch.bfloat16, 2, "a pointer 2 bytes off"),
    (768, torch.float32, 4, "a pointer 4 bytes off"),
    (1024, torch.float32, 8, "a pointer 8 bytes off")])
@pytest.mark.parametrize("backward", [False, True])
def test_plan_sends_other_calls_to_the_block_kernels(hidden, dtype,
                                                     alignment, why,
                                                     backward):
    assert tfused._ln_plan(4096, hidden, dtype, alignment,
                           backward).variant == "block", why


def test_plan_takes_a_predicated_tail_to_the_warp_kernels():
    """1000 is 125 bf16 vectors (250 f32): not a multiple of 32 vectors,
    so the last vectors of some lanes are predicated off."""
    for dtype in (torch.float32, torch.bfloat16):
        assert tfused._ln_plan(64, 1000, dtype, 16).variant == "warp"


def _rows_of_plan(plan, rows):
    """The rows each block of ``plan`` takes, as the kernels walk them."""
    if plan.variant == "block":
        return [list(range(i * plan.rows_per_block,
                           min(rows, (i + 1) * plan.rows_per_block)))
                for i in range(plan.grid)]
    warps = plan.grid * plan.rows_per_block  # each warp strides over rows
    return [[r for w in range(i * plan.rows_per_block,
                              (i + 1) * plan.rows_per_block)
             for r in range(w, rows, warps)] for i in range(plan.grid)]


@pytest.mark.parametrize("rows", [1, 7, 8, 4096, 8191, 8192])
@pytest.mark.parametrize("hidden,alignment", [(1024, 16), (768, 16),
                                              (1020, 16), (1024, 2)])
@pytest.mark.parametrize("backward", [False, True])
def test_plan_grid_covers_every_row_once(rows, hidden, alignment, backward):
    plan = tfused._ln_plan(rows, hidden, torch.bfloat16, alignment, backward)
    blocks = _rows_of_plan(plan, rows)
    assert sorted(r for b in blocks for r in b) == list(range(rows))
    assert all(blocks), "a block without rows"
    if plan.variant == "warp":
        assert plan.rows_per_block == min(tfused._LN_WARP_ROWS, rows)
        if backward:
            assert plan.grid <= tfused._LN_BWD_WARP_GRID
    if backward:
        assert plan.partials == (plan.grid, hidden)
    else:
        assert plan.partials is None


def test_plan_decode_rows_are_one_small_block():
    for rows in range(1, 9):
        plan = tfused._ln_plan(rows, 1024, torch.bfloat16, 16)
        assert (plan.variant, plan.rows_per_block, plan.grid) == \
            ("warp", rows, 1)


def test_alignment_is_the_largest_power_of_two_dividing_every_pointer():
    buf = torch.zeros(64, dtype=torch.bfloat16)  # 64-byte aligned
    assert buf.data_ptr() % 16 == 0
    assert tfused._alignment(buf) == tfused._alignment(buf[8:]) == 16
    assert tfused._alignment(buf[4:]) == 8
    assert tfused._alignment(buf, buf[1:]) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the kernels' tolerances of chip_smoke.py (LN_TOL, LN_BWD_TOL)
LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LN_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
CUDA_ROWS = (1, 8, 4096, 8191, 8192)
CUDA_HIDDEN = (768, 1024, 1000)


def _on_card(a, dev, dtype, misaligned):
    """``a`` on the card; ``misaligned``: a contiguous view whose data
    pointer is one element past an allocation's start, so the plan takes
    the block kernels."""
    t = torch.from_numpy(a).to(dev, dtype)
    if not misaligned:
        return t
    buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype, variant):
    tol = LN_TOL[dtype]
    shapes = [(r, h) for r in CUDA_ROWS for h in CUDA_HIDDEN] + [(300, 1024)]
    for rows, hidden in shapes:
        x, w, b = _inputs((rows, hidden), seed=rows)
        x = _on_card(x, cuda_device, dtype, variant == "block")
        w, b = (_on_card(a, cuda_device, dtype, False) for a in (w, b))
        plan = tfused._ln_plan(rows, hidden, dtype,
                               tfused._alignment(x, w, b))
        assert plan.variant == variant
        before = tfused.fused_layer_norm.launches
        got = tfused.fused_layer_norm(x, w, b)
        torch.cuda.synchronize()
        assert tfused.fused_layer_norm.launches == before + 1
        ref = tfused._ln_reference(x, w, b)
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=f"{rows} x {hidden}")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_kernel_matches_plain(cuda_device, dtype, variant):
    atol, rtol = LN_BWD_TOL[dtype]
    shapes = ([(r, h) for r in CUDA_ROWS for h in CUDA_HIDDEN]
              + [(1000, 1024), (3, 4096)])
    for rows, hidden in shapes:
        x, w, _ = _inputs((rows, hidden), seed=rows)
        x = _on_card(x, cuda_device, dtype, variant == "block")
        w = _on_card(w, cuda_device, dtype, False)
        g = torch.randn(rows, hidden, device=cuda_device).to(dtype)
        plan = tfused._ln_plan(rows, hidden, dtype,
                               tfused._alignment(x, w, g), backward=True)
        assert plan.variant == ("block" if hidden > 2048 else variant)
        before = tfused.layer_norm_bwd.launches
        got = tfused.layer_norm_bwd(x, w, g)
        torch.cuda.synchronize()
        assert tfused.layer_norm_bwd.launches == before + 2
        for a, ref, name in zip(got, tfused._ln_bwd_reference(x, w, g),
                                ("dx", "dw", "db")):
            torch.testing.assert_close(a.float(), ref.float(), atol=atol,
                                       rtol=rtol,
                                       msg=f"{name} {rows} x {hidden}")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_sums_are_deterministic(cuda_device, dtype, variant):
    """dγ and dβ come from per-block partials summed in a fixed order, so
    two calls on the same inputs agree bit for bit."""
    x, w, _ = _inputs((8192, 1024), seed=9)
    x = _on_card(x, cuda_device, dtype, variant == "block")
    w = _on_card(w, cuda_device, dtype, False)
    g = torch.randn(8192, 1024, device=cuda_device).to(dtype)
    first = tfused.layer_norm_bwd(x, w, g)
    second = tfused.layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dx", "dw", "db")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_warp_kernels_take_every_config_width(cuda_device, dtype):
    """The widest row (2048: x and g in shared memory) and the narrowest
    (128: half the lanes idle) through both warp kernels, and 1536 (48
    values a lane in the 64-value kernels)."""
    for hidden in CONFIG_WIDTHS + (1536,):
        x, w, b = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs((257, hidden), seed=hidden))
        g = torch.randn(257, hidden, device=cuda_device).to(dtype)
        assert tfused._ln_plan(257, hidden, dtype,
                               tfused._alignment(x, w, b, g)).variant == "warp"
        torch.testing.assert_close(
            tfused.fused_layer_norm(x, w, b).float(),
            tfused._ln_reference(x, w, b).float(), atol=LN_TOL[dtype],
            rtol=LN_TOL[dtype])
        atol, rtol = LN_BWD_TOL[dtype]
        for a, ref in zip(tfused.layer_norm_bwd(x, w, g),
                          tfused._ln_bwd_reference(x, w, g)):
            torch.testing.assert_close(a.float(), ref.float(), atol=atol,
                                       rtol=rtol, msg=f"hidden {hidden}")
