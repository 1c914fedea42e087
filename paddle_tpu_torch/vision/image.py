"""Image loading backend — counterpart of ``paddle_tpu.vision.image``:
``set_image_backend``, ``get_image_backend`` and ``image_load``. 'pil'
returns a PIL Image, 'cv2' a BGR uint8 array of 3 channels (as
``cv2.imread`` decodes), 'tensor' a CPU tensor of the decoded pixels.

PIL is imported when an image is loaded, not when the module is; where it
is missing, ``image_load`` raises an ``ImportError`` that names it.
"""
from __future__ import annotations

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKENDS = ("pil", "cv2", "tensor")
_image_backend = "pil"


def _check(backend):
    if backend not in _BACKENDS:
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2', 'tensor'], "
            f"but got {backend}")


def set_image_backend(backend):
    global _image_backend
    _check(backend)
    _image_backend = backend


def get_image_backend():
    return _image_backend


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "vision.image.image_load needs the PIL package (Pillow), "
            "which is not installed") from e
    return Image


def image_load(path, backend=None):
    """The image at ``path`` as a PIL Image ('pil'), a BGR ndarray
    ('cv2') or a tensor ('tensor')."""
    backend = backend or _image_backend
    _check(backend)
    img = _pil_image().open(path)
    if backend == "pil":
        return img
    import numpy as np

    if backend == "cv2":
        # every format decodes to 3-channel BGR (palette expanded, alpha
        # dropped), as cv2.imread's default does
        return np.asarray(img.convert("RGB"))[..., ::-1]
    import torch

    return torch.from_numpy(np.array(img))
