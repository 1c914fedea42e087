"""Dtypes — counterpart of ``paddle_tpu.core.dtype``.

The reference's names and aliases map onto torch dtypes (the float8
formats onto torch's own). ``convert_dtype`` takes a name, a torch dtype,
a numpy dtype or type, or a Python type; the package's default float
dtype (``set_default_dtype``) is its own and leaves torch's global
default as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from .enforce import InvalidArgumentError

__all__ = ["convert_dtype", "dtype_name", "set_default_dtype",
           "get_default_dtype", "is_floating_point", "is_integer",
           "is_complex", "bool_", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "float8_e4m3fn", "float8_e5m2"]

# canonical name -> torch dtype
_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_TO_NAME = {d: n for n, d in _NAME_TO_DTYPE.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
    "bool_": "bool",
}

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_default_dtype = torch.float32


def convert_dtype(dtype):
    """Any dtype spec as a torch dtype (None stays None). Raises
    ``InvalidArgumentError`` (a ``ValueError``) for an unknown name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "").replace("torch.", "")
        name = _ALIASES.get(name, name)
    elif dtype is bool:
        name = "bool"
    elif dtype is int:
        name = "int64"
    elif dtype is float:
        name = "float64"
    elif dtype is complex:
        name = "complex128"
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "name", None) or str(dtype)
    try:
        return _NAME_TO_DTYPE[name]
    except KeyError:
        raise InvalidArgumentError(f"unknown dtype {dtype!r}") from None


def dtype_name(dtype) -> str:
    """The reference's name of ``dtype`` ("float32", "bfloat16", ...)."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def set_default_dtype(d) -> None:
    """The float dtype that creation functions use when given none."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in (torch.float16, torch.bfloat16, torch.float32,
                 torch.float64):
        raise TypeError(
            "set_default_dtype only supports float16/bfloat16/float32/"
            f"float64, got {dtype_name(d)}")
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex
