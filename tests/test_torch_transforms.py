"""The port's vision transforms (paddle_tpu_torch.vision.transforms)
against the reference's on the CPU, on the same seeded numpy images:

- the deterministic transforms and functional forms (to_tensor,
  normalize, hflip, vflip, crop, center_crop, Transpose, Pad, Grayscale,
  Compose) bit for bit;
- the random ones (RandomCrop with padding, RandomHorizontalFlip,
  RandomVerticalFlip, BrightnessTransform, RandomRotation) under the same
  seed: the reference draws from Python's global `random`, the port from
  `generator=random.Random(seed)` or, without one, from the global module
  seeded alike — bit for bit; a random transform pickles (it holds no
  module), as the loader's spawned workers need;
- `resize` in each mode (bilinear, nearest, bicubic), up and down, f32
  and uint8: f32 within 1e-4 absolute on a 0-255 scale (the port applies
  the reference's weights one axis after the other in f32, XLA in one
  contraction: measured 6.1e-5), uint8 at most 1 level apart on at most
  0.1% of the pixels (measured: equal).
"""
import pickle
import random

import numpy as np
import pytest
import torch

from paddle_tpu.vision import transforms as J
from paddle_tpu_torch.vision import transforms as T
import torch_threads  # noqa: F401  (one torch thread a worker)

RESIZE_F32_ATOL = 1e-4
RESIZE_U8_LEVELS = 1
RESIZE_U8_SHARE = 1e-3


def _img(dtype=np.uint8, shape=(37, 53, 3), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape) * 255
    return x.astype(dtype)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("to_tensor", ()), ("to_tensor", ("HWC",)), ("hflip", ()),
    ("vflip", ()), ("crop", (3, 5, 20, 17)), ("center_crop", (24,)),
    ("center_crop", ((30, 10),)), ("normalize", ([120, 110, 100],
                                                 [60, 50, 70], "HWC"))])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_functional_forms_match_reference(name, args, dtype):
    img = _img(dtype)
    _same(getattr(T, name)(img, *args), getattr(J, name)(img, *args))


def test_normalize_chw_tensor_and_grey_to_tensor_match_reference():
    img = _img(np.float32, (3, 16, 20))
    _same(T.normalize(torch.from_numpy(img), [0.5] * 3, [0.2] * 3),
          J.normalize(J.to_tensor(img, "HWC"), [0.5] * 3, [0.2] * 3))
    grey = _img(np.uint8, (12, 9))
    _same(T.to_tensor(grey), J.to_tensor(grey))


@pytest.mark.parametrize("make", [
    lambda M: M.Transpose(), lambda M: M.Transpose((1, 0, 2)),
    lambda M: M.Pad(3), lambda M: M.Pad([1, 2, 3, 4], fill=9),
    lambda M: M.Grayscale(), lambda M: M.Grayscale(3),
    lambda M: M.CenterCrop(16), lambda M: M.ToTensor(),
    lambda M: M.Normalize(127.5, 64.0, data_format="HWC"),
    lambda M: M.Compose([M.CenterCrop(30), M.Normalize(
        [1, 2, 3], [4, 5, 6], data_format="HWC"), M.Transpose()])])
def test_deterministic_transforms_match_reference(make):
    img = _img()
    _same(make(T)(img), make(J)(img))


_RANDOM = {
    "crop": lambda M, **kw: M.RandomCrop(24, **kw),
    "crop_padded": lambda M, **kw: M.RandomCrop((30, 40), padding=4, **kw),
    "hflip": lambda M, **kw: M.RandomHorizontalFlip(**kw),
    "vflip": lambda M, **kw: M.RandomVerticalFlip(0.7, **kw),
    "brightness": lambda M, **kw: M.BrightnessTransform(0.4, **kw),
    "rotation": lambda M, **kw: M.RandomRotation(30, **kw),
    "imagenet": lambda M, **kw: M.Compose([
        M.RandomCrop(24, **kw), M.RandomHorizontalFlip(**kw),
        M.Normalize([123.7, 116.3, 103.5], [58.4, 57.1, 57.4],
                    data_format="HWC"), M.Transpose()]),
}


@pytest.mark.parametrize("kind", sorted(_RANDOM))
def test_random_transforms_match_reference_under_the_same_seed(kind):
    imgs = [_img(seed=s) for s in range(6)]
    random.seed(11)
    want = [_RANDOM[kind](J)(im) for im in imgs]
    t = _RANDOM[kind](T, generator=random.Random(11))
    for im, w in zip(imgs, want):
        _same(t(im), w)
    # without a generator: Python's global random, as the reference
    random.seed(11)
    t = _RANDOM[kind](T)
    for im, w in zip(imgs, want):
        _same(t(im), w)


def test_random_transform_pickles_with_and_without_a_generator():
    for kw in ({}, {"generator": random.Random(3)}):
        t = T.Compose([T.RandomCrop(8, **kw), T.RandomHorizontalFlip(**kw)])
        back = pickle.loads(pickle.dumps(t))
        assert back(_img()).shape == (8, 8, 3)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("size", [(17, 20), (80, 101), 24, (37, 90)])
def test_resize_matches_reference(mode, size):
    for dtype in (np.float32, np.uint8):
        img = _img(dtype)
        want = J.resize(img, size, mode)
        got = T.resize(img, size, mode)
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        if dtype == np.float32:
            assert diff.max() <= RESIZE_F32_ATOL
        else:
            assert diff.max() <= RESIZE_U8_LEVELS
            assert (diff > 0).mean() <= RESIZE_U8_SHARE
    resized = T.Resize(size, mode)(_img())
    assert resized.shape == want.shape


def test_resize_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="interpolation"):
        T.resize(_img(), 8, "area")
