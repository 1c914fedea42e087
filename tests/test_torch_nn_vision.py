"""The port's spatial warps (`nn.functional.vision`) against the
reference's on the same seeded numpy inputs, f32: `grid_sample` in both
modes, the three padding modes and both `align_corners` (grids reaching
past the image, so every edge rule is exercised), `affine_grid` and
`temporal_shift` (NCHW; NHWC, which the reference refuses, against its
NCHW result transposed). Values and the gradients of the image, the grid
and theta for one cotangent."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF
from torch_parity import assert_close, port_call, ref_call
import torch_threads  # noqa: F401  (one torch thread a worker)

# f32: the four-corner blends are summed in the same order; the affine
# product in another
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _image_and_grid(r, spread=1.3):
    x = r.randn(2, 3, 5, 6).astype(np.float32)
    grid = (r.rand(2, 4, 7, 2) * 2 - 1).astype(np.float32) * spread
    return x, grid


def _cases():
    cases = {}
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border", "reflection"):
            for ac in (True, False):
                cases[f"grid_sample_{mode}_{pad}_{int(ac)}"] = (
                    "grid_sample", _image_and_grid,
                    dict(mode=mode, padding_mode=pad, align_corners=ac),
                    (0, 1) if mode == "bilinear" else (0,))
    for ac in (True, False):
        cases[f"affine_grid_{int(ac)}"] = (
            "affine_grid", lambda r: (r.randn(2, 2, 3).astype(np.float32),
                                      [2, 3, 4, 5]),
            dict(align_corners=ac), (0,))
    cases["temporal_shift"] = ("temporal_shift", lambda r: (
        r.randn(6, 8, 3, 3).astype(np.float32), 3), {}, (0,))
    cases["temporal_shift_ratio"] = ("temporal_shift", lambda r: (
        r.randn(4, 10, 2, 2).astype(np.float32), 2),
        dict(shift_ratio=0.3), (0,))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_matches_the_reference(name):
    fn, build, kw, grad = CASES[name]
    args = build(np.random.RandomState(0))
    want = ref_call(getattr(JF, fn), args, kw, grad)
    got = port_call(getattr(TF, fn), args, kw, grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)


def test_affine_grid_takes_the_shape_as_a_tensor():
    theta = np.random.RandomState(1).randn(1, 2, 3).astype(np.float32)
    got = TF.affine_grid(torch.from_numpy(theta), torch.tensor([1, 2, 3, 4]))
    want = JF.affine_grid(paddle.to_tensor(theta), [1, 2, 3, 4])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **VALUE_TOL)


def test_temporal_shift_nhwc_is_the_nchw_shift_transposed():
    """The reference refuses NHWC; the port moves the channels and gives
    the reference's NCHW shift, transposed."""
    x = np.random.RandomState(2).randn(6, 8, 3, 3).astype(np.float32)
    want = JF.temporal_shift(paddle.to_tensor(x), 3).numpy()
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    got = TF.temporal_shift(torch.from_numpy(nhwc), 3, data_format="NHWC")
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 2, 3, 1))
    with pytest.raises(ValueError, match="supports NCHW"):
        JF.temporal_shift(paddle.to_tensor(nhwc), 3, data_format="NHWC")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_unknown_modes_raise_as_in_the_reference(mode):
    x, grid = (torch.from_numpy(a) for a in _image_and_grid(
        np.random.RandomState(0)))
    with pytest.raises(ValueError, match="padding_mode"):
        TF.grid_sample(x, grid, mode=mode, padding_mode="wrap")
    with pytest.raises(ValueError, match="mode"):
        TF.grid_sample(x, grid, mode="bicubic")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_on_the_card_matches_the_cpu(name):
    fn, build, kw, grad = CASES[name]
    args = build(np.random.RandomState(0))
    cpu = port_call(getattr(TF, fn), args, kw, grad)
    card = port_call(getattr(TF, fn), args, kw, grad, "cuda")
    assert_close([card[0]], [cpu[0]], what=name, **VALUE_TOL)
    assert_close(card[1], cpu[1], what=name, **GRAD_TOL)
