"""Vision transforms — counterpart of ``paddle_tpu.vision.transforms``: the
classes (``Compose``, ``ToTensor``, ``Normalize``, ``Resize``,
``RandomCrop``, ``CenterCrop``, ``RandomHorizontalFlip``,
``RandomVerticalFlip``, ``Transpose``, ``Pad``, ``BrightnessTransform``,
``RandomRotation``, ``Grayscale``) and the functional forms.

They run on the host, on numpy, as the reference's do: HWC images (uint8
or float) in, numpy out; ``to_tensor`` gives a CHW f32 CPU tensor (uint8
scaled to [0, 1]). ``RandomRotation`` uses ``scipy.ndimage``.

Random draws come from ``generator=``, a ``random.Random``; without one
(the default) they come from Python's global ``random`` module, looked up
at call time, as the reference's ``pyrandom`` calls do. So seeding both
packages' generators alike gives the same crops, flips and angles; and a
transform holds no module, so it pickles into spawned loader workers.

``resize`` gives the reference's values, which are ``jax.image.resize``'s
and not ``torch``'s: it antialiases when it downsamples (the kernel is
widened by the downsampling factor); ``"nearest"`` samples at half-pixel
centres (torch's ``"nearest-exact"``); ``"bicubic"`` is Keys' kernel with
a = −0.5 (torch's is −0.75); the resize runs in f32, and a uint8 result
is truncated by ``astype``, not rounded. The port computes
``scale_and_translate``'s weight matrices in numpy (f64, cast to f32) and
applies them one axis after the other in f32.
"""
from __future__ import annotations

import numbers
import random
from typing import Optional

import numpy as np
import torch

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
    "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
    "Transpose", "Pad", "BrightnessTransform", "RandomRotation",
    "Grayscale", "to_tensor", "normalize", "resize", "hflip", "vflip",
    "center_crop", "crop",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def _as_np(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _rng(generator: Optional[random.Random]):
    return random if generator is None else generator


def to_tensor(pic, data_format="CHW") -> torch.Tensor:
    arr = _as_np(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if data_format == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(arr))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _as_np(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        arr = (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    else:
        arr = (arr - mean) / std
    return torch.from_numpy(arr) if isinstance(img, torch.Tensor) else arr


# --- resize: jax.image.resize's sampling, in numpy -------------------------
def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def _weight_mat(in_size: int, out_size: int, kernel) -> np.ndarray:
    """[in_size, out_size] f32 resampling weights of one axis
    (``jax.image.scale_and_translate``'s ``compute_weight_mat`` with
    translation 0 and antialiasing)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale \
        - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)
               [:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize_f32(x: np.ndarray, target, interpolation: str) -> np.ndarray:
    for axis, (m, n) in enumerate(zip(x.shape, target)):
        if m == n:
            continue
        if interpolation == "nearest":
            idx = np.floor((np.arange(n, dtype=np.float32) + 0.5) * m / n
                           ).astype(np.int32)
            x = np.take(x, idx, axis=axis)
        else:
            w = _weight_mat(m, n, _KERNELS[interpolation])
            x = np.moveaxis(np.tensordot(x, w, axes=([axis], [0])), -1,
                            axis)
    return x


def resize(img, size, interpolation="bilinear"):
    """``img`` (HW or HWC) resized to ``size`` — (h, w), or an int for
    the shorter side — by ``"bilinear"``, ``"nearest"`` or
    ``"bicubic"``; a uint8 image comes back uint8, any other f32."""
    arr = _as_np(img)
    if interpolation not in ("bilinear", "nearest", "bicubic"):
        raise ValueError(f"resize: unknown interpolation {interpolation!r}")
    if isinstance(size, int):
        h, w = arr.shape[:2]
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    target = tuple(size) + arr.shape[2:]
    out = _resize_f32(arr.astype(np.float32), target, interpolation)
    return out.astype(arr.dtype) if arr.dtype == np.uint8 else out


def hflip(img):
    return _as_np(img)[:, ::-1].copy()


def vflip(img):
    return _as_np(img)[::-1].copy()


def crop(img, top, left, height, width):
    return _as_np(img)[top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    arr = _as_np(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = arr.shape[:2]
    th, tw = output_size
    top = max((h - th) // 2, 0)
    left = max((w - tw) // 2, 0)
    return crop(arr, top, left, th, tw)


class ToTensor:
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize:
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


class RandomCrop:
    """A random ``size`` crop (after zero ``padding`` when given); the
    reference takes ``pad_if_needed``, ``fill`` and ``padding_mode`` and
    ignores them, and so does the port."""

    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None, generator=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.generator = generator

    def __call__(self, img):
        arr = _as_np(img)
        if self.padding:
            p = self.padding if not isinstance(self.padding, int) \
                else [self.padding] * 4
            arr = np.pad(arr, [(p[1], p[3]), (p[0], p[2])]
                         + [(0, 0)] * (arr.ndim - 2))
        h, w = arr.shape[:2]
        th, tw = self.size
        rng = _rng(self.generator)
        top = rng.randint(0, max(h - th, 0))
        left = rng.randint(0, max(w - tw, 0))
        return crop(arr, top, left, th, tw)


class CenterCrop:
    def __init__(self, size, keys=None):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, keys=None, generator=None):
        self.prob = prob
        self.generator = generator

    def __call__(self, img):
        if _rng(self.generator).random() < self.prob:
            return hflip(img)
        return _as_np(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5, keys=None, generator=None):
        self.prob = prob
        self.generator = generator

    def __call__(self, img):
        if _rng(self.generator).random() < self.prob:
            return vflip(img)
        return _as_np(img)


class Transpose:
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def __call__(self, img):
        arr = _as_np(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        if isinstance(padding, int):
            padding = [padding] * 4
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        arr = _as_np(img)
        p = self.padding
        return np.pad(
            arr, [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2),
            constant_values=self.fill)


class BrightnessTransform:
    def __init__(self, value, keys=None, generator=None):
        self.value = float(value)
        self.generator = generator

    def __call__(self, img):
        arr = _as_np(img).astype(np.float32)
        factor = 1.0 + _rng(self.generator).uniform(-self.value, self.value)
        return np.clip(arr * factor, 0, 255 if arr.max() > 1 else 1.0)


class RandomRotation:
    """A rotation by a random angle in ``degrees``, bilinear, keeping the
    shape; the reference takes ``interpolation``, ``expand``, ``center``
    and ``fill`` and ignores them, and so does the port."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None, generator=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.generator = generator

    def __call__(self, img):
        import scipy.ndimage as ndi

        arr = _as_np(img)
        angle = _rng(self.generator).uniform(*self.degrees)
        return ndi.rotate(arr, angle, reshape=False, order=1)


class Grayscale:
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        arr = _as_np(img).astype(np.float32)
        if arr.ndim == 3 and arr.shape[2] == 3:
            g = arr @ np.asarray([0.299, 0.587, 0.114], np.float32)
        else:
            g = arr.squeeze()
        if self.num_output_channels == 3:
            return np.stack([g] * 3, axis=-1)
        return g[..., None]
