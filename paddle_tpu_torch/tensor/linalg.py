"""Linear algebra — counterpart of ``paddle_tpu.tensor.linalg``.

Over ``torch.linalg``: the factorizations that report failure through a
status (``inv``, ``cholesky``, ``solve``) use the ``_ex`` forms, which
leave the status on the device instead of reading it back. Results that
are unique only up to signs or order (``svd``, ``qr``, ``eigh``'s
vectors, ``eig``) are those of torch's drivers. ``lstsq`` has only the
``gels`` driver on CUDA: there ``driver`` None or "gels" runs it and any
other raises; its rank and singular values are then empty, as torch
gives them. ``histogram`` and ``bincount`` read their output size from
the data, on the device. ``cov`` and ``corrcoef`` are numpy's formulas
in tensor ops (``torch.cov`` reads its degrees of freedom on the host).
"""
from __future__ import annotations

import math

import torch

from ._util import as_tensor, pair, promote, to_float

__all__ = [
    "norm", "cholesky", "qr", "svd", "inv", "det", "slogdet", "eig", "eigh",
    "eigvals", "eigvalsh", "solve", "triangular_solve", "lstsq", "matrix_power",
    "pinv", "cross", "t", "dist", "cond", "matrix_rank", "mv", "histogram",
    "bincount", "cov", "corrcoef",
]


def _float(x):
    return to_float(as_tensor(x))


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    a = _float(x)
    inf = (p == math.inf or p == "inf")
    if axis is None:
        flat = a.reshape(-1).abs()
        if p in ("fro", 2):
            return flat.square().sum().sqrt()
        if p == 1:
            return flat.sum()
        if inf:
            return flat.amax()
        if p == -math.inf:
            return flat.amin()
        return flat.pow(p).sum().pow(1.0 / p)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)
    if isinstance(ax, tuple) and p == "fro":
        return a.square().sum(ax, keepdim=keepdim).sqrt()
    if inf:
        return a.abs().amax(ax, keepdim=keepdim)
    if p == -math.inf:
        return a.abs().amin(ax, keepdim=keepdim)
    if p == 0:
        return (a != 0).to(a.dtype).sum(ax, keepdim=keepdim)
    return torch.linalg.norm(a, ord=None if p == "fro" else p, dim=ax,
                             keepdim=keepdim)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky_ex(_float(x), upper=upper).L


def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(_float(x), mode=mode))


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(_float(x), full_matrices=full_matrices))


def inv(x, name=None):
    return torch.linalg.inv_ex(_float(x)).inverse


def det(x, name=None):
    return torch.linalg.det(_float(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(_float(x))
    return torch.stack([sign, logdet])


def eig(x, name=None):
    w, v = torch.linalg.eig(_float(x))
    return w, v


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_float(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(_float(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_float(x), UPLO=UPLO)


def solve(x, y, name=None):
    a, b = promote(*pair(x, y))
    return torch.linalg.solve_ex(a, b).result


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = promote(*pair(x, y))
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, b, upper=upper, left=True,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values). The CPU runs
    ``gelsd`` (all four, as jnp gives them); CUDA has ``gels`` only."""
    a, b = promote(_float(x), _float(y))
    if a.device.type == "cuda":
        if driver not in (None, "gels"):
            raise ValueError(
                f"lstsq: driver {driver!r} does not exist on CUDA; torch "
                "solves least squares there with 'gels' only")
        driver = "gels"
    else:
        driver = driver or "gelsd"
    vec = b.dim() == a.dim() - 1
    sol, res, rank, sv = torch.linalg.lstsq(
        a, b.unsqueeze(-1) if vec else b, rcond=rcond, driver=driver)
    if vec:
        sol = sol.squeeze(-1)
        res = res.squeeze(-1) if res.numel() else res
    return sol, res, rank.to(torch.int64), sv


def matrix_power(x, n, name=None):
    t = as_tensor(x)
    if n < 0:
        # the inverse through inv_ex: its status stays on the device
        t, n = torch.linalg.inv_ex(to_float(t)).inverse, -n
    return torch.linalg.matrix_power(t, n)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(_float(x), rtol=rcond, hermitian=hermitian)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (by default the first axis of
    size 3)."""
    a, b = promote(*pair(x, y))
    ax = axis if axis != 9 else next(i for i, s in enumerate(a.shape)
                                     if s == 3)
    return torch.linalg.cross(a, b, dim=ax)


def t(x, name=None):
    x = as_tensor(x)
    return x.clone() if x.dim() < 2 else x.transpose(-1, -2)


def dist(x, y, p=2, name=None):
    a, b = promote(*pair(x, y))
    d = (a - b).reshape(-1)
    if p == 0:
        return (d != 0).to(a.dtype).sum()
    if p == math.inf:
        return d.abs().amax()
    if p == -math.inf:
        return d.abs().amin()
    return d.abs().pow(p).sum().pow(1.0 / p)


def cond(x, p=None, name=None):
    return torch.linalg.cond(_float(x), p)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    a = _float(x)
    if tol is None:
        return torch.linalg.matrix_rank(a, hermitian=hermitian)
    return torch.linalg.matrix_rank(a, atol=tol, rtol=0.0,
                                    hermitian=hermitian)


def mv(x, vec, name=None):
    return torch.matmul(*promote(*pair(x, vec)))


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts (int64) of ``bins`` equal bins over [min, max] (the data's
    range when both are 0); the last bin holds ``max``."""
    a = _float(input).reshape(-1)
    return torch.histc(a, bins=bins, min=min, max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    t = as_tensor(x)
    w = as_tensor(weights, t) if weights is not None else None
    return torch.bincount(t, weights=w, minlength=minlength)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """numpy's covariance, computed in tensor ops (``torch.cov`` reads its
    degrees of freedom on the host)."""
    a = _float(x)
    a = a if rowvar or a.dim() < 2 else a.T
    a = a if a.dim() == 2 else a.reshape(1, -1)
    n = a.shape[1]
    w = None
    if fweights is not None:
        w = as_tensor(fweights, a).to(a.dtype)
    if aweights is not None:
        aw = as_tensor(aweights, a).to(a.dtype)
        w = aw if w is None else w * aw
    if w is None:
        mean = a.mean(1, keepdim=True)
        fact = n - (1 if ddof else 0)
    else:
        total = w.sum()
        mean = (a * w).sum(1, keepdim=True) / total
        if not ddof:
            fact = total
        elif aweights is None:
            fact = total - 1
        else:
            fact = total - (w * aw).sum() / total
    xm = a - mean
    xw = xm if w is None else xm * w
    return (xw @ xm.T.conj() / fact).squeeze()


def corrcoef(x, rowvar=True, name=None):
    c = cov(x, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    out = c / d.unsqueeze(1) / d.unsqueeze(0)
    return out.clamp(-1, 1) if not out.is_complex() else out
