"""Random sampling — counterpart of ``paddle_tpu.tensor.random``.

Every draw comes from ``core.rng.default_generator()``'s
``torch.Generator`` for the device the result lies on (the current
device for the functions that take no tensor), so ``paddle.seed`` and
``get_rng_state`` / ``set_rng_state`` govern it. ``uniform(seed=s)``
with ``s != 0`` draws from a generator of its own seeded with ``s``, as
the reference's per-call seed does. The numbers are torch's, not JAX's.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core import rng as rng_mod
from ..core.place import current_device
from ._util import as_tensor, dtype_arg, shape_arg

__all__ = [
    "rand", "randn", "randint", "randint_like", "uniform", "normal",
    "standard_normal", "randperm", "bernoulli", "multinomial", "poisson",
    "uniform_", "normal_", "exponential_",
]


def _gen(device) -> torch.Generator:
    return rng_mod.default_generator().torch_generator(device)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = current_device()
    return torch.randn(shape_arg(shape), dtype=dtype_arg(dtype), device=dev,
                       generator=_gen(dev))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m = as_tensor(mean, like).to(dtype_mod.get_default_dtype())
        s = as_tensor(std, like).to(dtype_mod.get_default_dtype())
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, dtype=m.dtype, device=like.device,
                        generator=_gen(like.device))
        return z * s + m
    dev = current_device()
    shp = shape_arg(shape) if shape is not None else ()
    z = torch.randn(shp, dtype=dtype_mod.get_default_dtype(), device=dev,
                    generator=_gen(dev))
    return z * std + mean


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    gen = (torch.Generator(device=dev).manual_seed(int(seed)) if seed
           else _gen(dev))
    out = torch.empty(shape_arg(shape), dtype=dtype_arg(dtype), device=dev)
    return out.uniform_(min, max, generator=gen)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return torch.randint(int(low), int(high), shape_arg(shape),
                         dtype=dtype_arg(dtype, torch.int64), device=dev,
                         generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    x = as_tensor(x)
    d = dtype_mod.convert_dtype(dtype) or x.dtype
    return torch.randint(int(low), int(high), tuple(x.shape), dtype=d,
                         device=x.device, generator=_gen(x.device))


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return torch.randperm(int(n), dtype=dtype_arg(dtype, torch.int64),
                          device=dev, generator=_gen(dev))


def bernoulli(x, name=None):
    p = as_tensor(x)
    return torch.bernoulli(p.detach().float(),
                           generator=_gen(p.device)).to(p.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = as_tensor(x).detach()
    return torch.multinomial(p.float(), num_samples, replacement,
                             generator=_gen(p.device))


def poisson(x, name=None):
    p = as_tensor(x).detach()
    return torch.poisson(p.float(), generator=_gen(p.device)).to(p.dtype)


# -- in place ---------------------------------------------------------------
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    gen = (torch.Generator(device=x.device).manual_seed(int(seed)) if seed
           else _gen(x.device))
    with torch.no_grad():
        return x.uniform_(min, max, generator=gen)


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))
