"""One case for every function of the tensor namespace (the reference's
``paddle_tpu.tensor`` ``__all__`` lists), shared by the CPU parity tests
(reference against port) and ``chip_smoke.py``'s phase 21a (port on the
card against port on the CPU). It imports neither jax nor either package.

A case is ``Case(inputs, call, grad, tol, kind)``:
- ``inputs(rng)`` gives the arguments: numpy arrays become tensors of the
  package under test, anything else is passed as it is;
- ``call(T, *args)`` calls the function through ``T``, the package's
  ``tensor`` module;
- ``grad`` are the positions of the array arguments to differentiate
  (through the first output, with ``cotangent``);
- ``tol`` is (rtol, atol) for values and gradients;
- ``kind`` says how outputs are compared: "value" (every output, values
  and dtype), "sets" (complex eigenvalues, sorted), "recon" (a
  factorization, by the product of its factors), "random" (the
  ``RANDOM_STATS`` moments of the first output: two generators give
  other numbers).
``SYNCS`` lists the cases whose output size depends on the data, or
that read a value on the host as the reference does: on the card they
read it back once; ``TORCH_SYNCS`` the linalg cases whose torch
implementation reads cuSOLVER's status back. No other case may
synchronize with the card.
"""
from collections import namedtuple

import numpy as np

Case = namedtuple("Case", "inputs call grad tol kind", defaults=(
    (), (2e-5, 2e-6), "value"))

F32 = np.float32
TOL = (2e-5, 2e-6)
# transcendental functions: XLA's and torch's approximations differ by a
# few f32 ulps, more in their derivatives
TRANS_TOL = (1e-4, 1e-5)
# factorizations and solves: LAPACK drivers of two libraries, f32
LINALG_TOL = (1e-3, 1e-4)
# random draws: moments over RANDOM_N samples within this much
RANDOM_N = 20000

# the cases that may synchronize with the card (exact case names), and why:
# their output size depends on the data (read back once), or they read a
# value on the host as the reference does (an index check, a tensor shape
# or bound, a Python list)
SYNCS = {
    # data-dependent output size
    "masked_select", "nonzero", "nonzero@tuple", "where@nonzero",
    "unique", "unique@all", "unique@axis", "unique_consecutive",
    "repeat_interleave@tensor", "bincount", "histogram",
    "sequence_mask", "sequence_pad", "sequence_pad@maxlen",
    "sequence_unpad", "sequence_expand", "sequence_expand_as",
    "sequence_concat", "sequence_slice",
    # a value read on the host
    "multiplex", "tolist", "reshape@tensor", "arange@tensor",
    # computed on the host by torch on CUDA (its magma geev)
    "eig", "eigvals",
    # the initializer draws on the host (one seed, the same weights on
    # every device) and copies the weights over
    "create_parameter",
}
# linalg cases whose torch implementation on CUDA reads cuSOLVER's status
# back on its own, to raise on a failed factorization (phase 21a lists
# which did)
TORCH_SYNCS = {
    "svd", "eigh", "eigvalsh", "pinv", "cond", "cond@fro", "matrix_rank",
    "matrix_rank@tol", "lstsq", "qr", "det", "slogdet", "norm@2",
    "inverse", "inv",
}


def f32(r, *s):
    return r.randn(*s).astype(F32)


def pos(r, *s, lo=0.5, hi=2.0):
    return (r.rand(*s) * (hi - lo) + lo).astype(F32)


def ints(r, lo, hi, *s, dtype=np.int64):
    return r.randint(lo, hi, s).astype(dtype)


def spd(r, n=4):
    a = r.randn(n, n).astype(F32)
    return (a @ a.T + n * np.eye(n)).astype(F32)


def cplx(r, *s):
    return (r.randn(*s) + 1j * r.randn(*s)).astype(np.complex64)


def cotangent(shape, seed=1):
    return np.asarray(np.random.RandomState(seed).rand(*shape) + 0.5, F32)


def _c(inputs, call, grad=(), tol=TOL, kind="value"):
    return Case(inputs, call, grad, tol, kind)


def _unary(name, lo=-2.0, hi=2.0, grad=True, tol=TRANS_TOL):
    return _c(lambda r: [(r.rand(3, 4) * (hi - lo) + lo).astype(F32)],
              lambda T, x: getattr(T, name)(x), (0,) if grad else (), tol)


def _binary(name, grad=(0, 1), tol=TOL, inputs=None):
    return _c(inputs or (lambda r: [f32(r, 3, 4), f32(r, 4)]),
              lambda T, x, y: getattr(T, name)(x, y), grad, tol)


def _reduce(name, grad=True, **kw):
    return _c(lambda r: [f32(r, 3, 4, 5)],
              lambda T, x: getattr(T, name)(x, **kw), (0,) if grad else ())


def _inplace(name, inputs, *args):
    return _c(inputs, lambda T, x: getattr(T, name)(x, *args))


def math_cases():
    c = {}
    for name in ("add", "subtract", "multiply", "maximum", "minimum",
                 "fmax", "fmin"):
        c[name] = _binary(name)
    c["add@scalar"] = _c(lambda r: [f32(r, 3, 4)],
                         lambda T, x: T.add(x, 2), (0,))
    c["multiply@int_scalar"] = _c(lambda r: [ints(r, -5, 5, 3, 4)],
                                  lambda T, x: T.multiply(x, 3))
    c["divide"] = _binary("divide", inputs=lambda r: [f32(r, 3, 4),
                                                      pos(r, 3, 4)])
    # integer rule: the result is float (the port: the default float dtype;
    # the reference: float64 under its x64 setting) with the same values
    c["divide@int"] = _c(lambda r: [ints(r, -9, 9, 3, 4),
                                    ints(r, 1, 4, 3, 4)],
                         lambda T, x, y: T.cast(T.divide(x, y), "float32"))
    # floor toward -inf for negative operands, the sign of mod follows the
    # divisor
    ipair = lambda r: [ints(r, -9, 9, 3, 4),  # noqa: E731
                       np.array([[3, -3, 2, -2]] * 3, np.int64)]
    fpair = lambda r: [f32(r, 3, 4) * 3,  # noqa: E731
                       np.array([[1.5, -1.5, 0.7, -0.7]] * 3, F32)]
    c["floor_divide"] = _c(ipair, lambda T, x, y: T.floor_divide(x, y))
    c["floor_divide@float"] = _c(fpair, lambda T, x, y: T.floor_divide(x, y))
    for name in ("mod", "remainder", "floor_mod"):
        c[name] = _c(ipair, lambda T, x, y, n=name: getattr(T, n)(x, y))
    c["mod@float"] = _c(fpair, lambda T, x, y: T.mod(x, y), (0,))
    c["pow"] = _c(lambda r: [pos(r, 3, 4), f32(r, 3, 4)],
                  lambda T, x, y: T.pow(x, y), (0, 1), TRANS_TOL)
    c["pow@scalar"] = _c(lambda r: [f32(r, 3, 4)],
                         lambda T, x: T.pow(x, 3.0), (0,))
    for name, lo, hi in (("sqrt", 0.5, 2), ("rsqrt", 0.5, 2), ("exp", -2, 2),
                         ("expm1", -1, 1), ("log", 0.5, 3),
                         ("log2", 0.5, 3), ("log10", 0.5, 3),
                         ("log1p", -0.5, 2), ("sin", -2, 2), ("cos", -2, 2),
                         ("tan", -1, 1), ("asin", -0.9, 0.9),
                         ("acos", -0.9, 0.9), ("atan", -2, 2),
                         ("sinh", -2, 2), ("cosh", -2, 2), ("tanh", -2, 2),
                         ("asinh", -2, 2), ("acosh", 1.1, 3),
                         ("atanh", -0.9, 0.9), ("sigmoid", -3, 3),
                         ("square", -2, 2), ("reciprocal", 0.5, 2),
                         ("neg", -2, 2), ("erf", -2, 2),
                         ("erfinv", -0.9, 0.9), ("digamma", 0.5, 3),
                         ("lgamma", 0.5, 3), ("abs", -2, 2),
                         ("frac", -3, 3), ("rad2deg", -3, 3),
                         ("deg2rad", -100, 100)):
        c[name] = _unary(name, lo, hi)
    for name in ("ceil", "floor", "round", "trunc", "sign", "isnan",
                 "isinf", "isfinite"):
        c[name] = _unary(name, -3, 3, grad=False)
    c["angle"] = _c(lambda r: [cplx(r, 3, 4)], lambda T, x: T.angle(x),
                    (), TRANS_TOL)
    c["isnan@special"] = _c(
        lambda r: [np.array([1.0, np.nan, np.inf, -np.inf], F32)],
        lambda T, x: T.stack([T.cast(T.isnan(x), "int32"),
                              T.cast(T.isinf(x), "int32"),
                              T.cast(T.isfinite(x), "int32")]))
    c["atan2"] = _binary("atan2", tol=TRANS_TOL)
    c["hypot"] = _binary("hypot", tol=TRANS_TOL)
    c["logaddexp"] = _binary("logaddexp", tol=TRANS_TOL)
    c["heaviside"] = _c(lambda r: [np.array([[-1.0, 0.0, 2.0]], F32),
                                   np.array([0.5, 0.5, 0.5], F32)],
                        lambda T, x, y: T.heaviside(x, y))
    c["gcd"] = _c(lambda r: [ints(r, -20, 20, 3, 4), ints(r, 1, 12, 3, 4)],
                  lambda T, x, y: T.gcd(x, y))
    c["lcm"] = _c(lambda r: [ints(r, 1, 12, 3, 4), ints(r, 1, 12, 3, 4)],
                  lambda T, x, y: T.lcm(x, y))
    c["kron"] = _c(lambda r: [f32(r, 2, 3), f32(r, 2, 2)],
                   lambda T, x, y: T.kron(x, y), (0, 1))
    c["logit"] = _c(lambda r: [pos(r, 3, 4, lo=0.05, hi=0.95)],
                    lambda T, x: T.logit(x), (0,), TRANS_TOL)
    c["logit@eps"] = _c(lambda r: [pos(r, 3, 4, lo=0.0, hi=1.0)],
                        lambda T, x: T.logit(x, eps=0.1), (), TRANS_TOL)
    c["stanh"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.stanh(x),
                    (0,), TRANS_TOL)
    c["softplus"] = _c(lambda r: [f32(r, 3, 4) * 8],
                       lambda T, x: T.softplus(x, beta=2, threshold=5),
                       (0,), TRANS_TOL)
    c["nan_to_num"] = _c(
        lambda r: [np.array([1.0, np.nan, np.inf, -np.inf], F32)],
        lambda T, x: T.nan_to_num(x, nan=0.5, posinf=9.0, neginf=-9.0))
    c["lerp"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
                   lambda T, x, y: T.lerp(x, y, 0.3), (0, 1))
    c["lerp@tensor"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4),
                                     pos(r, 3, 4, lo=0, hi=1)],
                          lambda T, x, y, w: T.lerp(x, y, w), (0, 1, 2))
    c["clip"] = _c(lambda r: [f32(r, 3, 4)],
                   lambda T, x: T.clip(x, -0.5, 0.7), (0,))
    c["clip@min"] = _c(lambda r: [f32(r, 3, 4)],
                       lambda T, x: T.clip(x, min=0.1), (0,))
    c["scale"] = _c(lambda r: [f32(r, 3, 4)],
                    lambda T, x: T.scale(x, 2.0, 0.5), (0,))
    c["scale@before"] = _c(lambda r: [f32(r, 3, 4)],
                           lambda T, x: T.scale(x, 2.0, 0.5,
                                                bias_after_scale=False), (0,))
    c["increment"] = _c(lambda r: [f32(r, 1)],
                        lambda T, x: T.increment(x, 2.0))
    for name in ("sum", "nansum", "mean", "nanmean", "prod", "amax", "amin",
                 "max", "min", "logsumexp"):
        c[name] = _reduce(name)
        c[name + "@axis"] = _reduce(name, axis=1)
        c[name + "@axes_keepdim"] = _reduce(name, axis=[0, 2], keepdim=True)
    c["prod@zero"] = _c(lambda r: [np.array([[1.5, 0.0, 2.0, -1.0],
                                             [0.0, 3.0, 0.0, 2.0],
                                             [1.0, 2.0, 0.5, 4.0]], F32)],
                        lambda T, x: T.prod(x, axis=1), (0,))
    for name in ("sum", "max", "prod", "mean"):
        c[name + "@keepdim_all"] = _reduce(name, keepdim=True)
    c["sum@dtype"] = _c(lambda r: [ints(r, 0, 5, 3, 4, dtype=np.int32)],
                        lambda T, x: T.sum(x, axis=0))
    c["sum@bool"] = _c(lambda r: [r.rand(3, 4) > 0.5],
                       lambda T, x: T.sum(x))
    c["nansum@nan"] = _c(lambda r: [np.array([[1.0, np.nan], [2.0, 3.0]],
                                             F32)],
                         lambda T, x: T.nansum(x, axis=1))
    c["nanmean@nan"] = _c(lambda r: [np.array([[1.0, np.nan], [2.0, 3.0]],
                                              F32)],
                          lambda T, x: T.nanmean(x, axis=1))
    c["all"] = _c(lambda r: [r.rand(3, 4) > 0.2], lambda T, x: T.all(x))
    c["all@axis"] = _c(lambda r: [r.rand(3, 4) > 0.2],
                       lambda T, x: T.all(x, axis=1, keepdim=True))
    c["any"] = _c(lambda r: [r.rand(3, 4) > 0.8], lambda T, x: T.any(x))
    c["any@axis"] = _c(lambda r: [r.rand(3, 4) > 0.8],
                       lambda T, x: T.any(x, axis=[0]))
    c["count_nonzero"] = _c(lambda r: [ints(r, 0, 2, 3, 4).astype(F32)],
                            lambda T, x: T.count_nonzero(x, axis=1))
    c["cumsum"] = _c(lambda r: [f32(r, 3, 4)],
                     lambda T, x: T.cumsum(x, axis=1), (0,))
    c["cumsum@flat"] = _c(lambda r: [f32(r, 3, 4)],
                          lambda T, x: T.cumsum(x), (0,))
    c["cumprod"] = _c(lambda r: [pos(r, 3, 4)],
                      lambda T, x: T.cumprod(x, dim=1), (0,))
    c["cumprod@zero"] = _c(lambda r: [np.array(
        [[1.5, 0.0, 2.0, -1.0, 0.5], [0.0, 3.0, 0.0, 2.0, 1.0],
         [1.0, 2.0, 0.5, 4.0, 0.0]], F32)],
        lambda T, x: T.cumprod(x, dim=1), (0,))
    c["cumprod@flat"] = _c(lambda r: [f32(r, 3, 5)],
                           lambda T, x: T.cumprod(x), (0,))
    # ties: the running extreme's index is its latest occurrence
    tied = lambda r: [np.array([[1, 3, 3, 2, 5, 5, 0],  # noqa: E731
                                [4, 4, 1, 4, 0, 7, 7]], F32)]
    c["cummax"] = _c(tied, lambda T, x: T.cummax(x, axis=1))
    c["cummin"] = _c(tied, lambda T, x: T.cummin(x, axis=1))
    c["cummax@flat"] = _c(lambda r: [f32(r, 3, 4)],
                          lambda T, x: T.cummax(x), (0,))
    c["cummin@flat"] = _c(lambda r: [f32(r, 3, 4)],
                          lambda T, x: T.cummin(x), (0,))
    c["diff"] = _c(lambda r: [f32(r, 3, 5)],
                   lambda T, x: T.diff(x, n=2, axis=1), (0,))
    c["diff@prepend"] = _c(lambda r: [f32(r, 3, 5), f32(r, 3, 1)],
                           lambda T, x, p: T.diff(x, axis=1, prepend=p),
                           (0, 1))
    c["trace"] = _c(lambda r: [f32(r, 4, 5)],
                    lambda T, x: T.trace(x, offset=1), (0,))
    c["matmul"] = _c(lambda r: [f32(r, 2, 3, 4), f32(r, 4, 5)],
                     lambda T, x, y: T.matmul(x, y), (0, 1), (1e-5, 1e-5))
    c["matmul@transpose"] = _c(lambda r: [f32(r, 4, 3), f32(r, 5, 4)],
                               lambda T, x, y: T.matmul(x, y, True, True),
                               (0, 1), (1e-5, 1e-5))
    # mixed dtypes promote, as jnp does (torch's matmul refuses them)
    c["matmul@mixed"] = _c(lambda r: [f32(r, 3, 4),
                                      f32(r, 4, 2).astype(np.float64)],
                           lambda T, x, y: T.matmul(x, y), (), (1e-5, 1e-5))
    c["mm"] = _c(lambda r: [f32(r, 3, 4), f32(r, 4, 2)],
                 lambda T, x, y: T.mm(x, y), (0, 1), (1e-5, 1e-5))
    c["bmm"] = _c(lambda r: [f32(r, 2, 3, 4), f32(r, 2, 4, 2)],
                  lambda T, x, y: T.bmm(x, y), (0, 1), (1e-5, 1e-5))
    c["inner"] = _c(lambda r: [f32(r, 3, 4), f32(r, 2, 4)],
                    lambda T, x, y: T.inner(x, y), (0, 1), (1e-5, 1e-5))
    c["outer"] = _c(lambda r: [f32(r, 3), f32(r, 4)],
                    lambda T, x, y: T.outer(x, y), (0, 1))
    c["dot"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
                  lambda T, x, y: T.dot(x, y), (0, 1), (1e-5, 1e-5))
    c["addmm"] = _c(lambda r: [f32(r, 3, 2), f32(r, 3, 4), f32(r, 4, 2)],
                    lambda T, i, x, y: T.addmm(i, x, y, beta=0.5, alpha=2.0),
                    (0, 1, 2), (1e-5, 1e-5))
    c["add_n"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4), f32(r, 3, 4)],
                    lambda T, a, b, d: T.add_n([a, b, d]), (0, 1, 2))
    c["broadcast_shape"] = _c(lambda r: [],
                              lambda T: T.broadcast_shape([3, 1, 4], [2, 1]))
    c["multiply_"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
                        lambda T, x, y: T.multiply_(x, y))
    c["log_softmax_"] = _c(lambda r: [f32(r, 3, 4)],
                           lambda T, x: T.log_softmax_(x, axis=1), (),
                           TRANS_TOL)
    for name, lo, hi, args in (("exp_", -2, 2, ()), ("sqrt_", 0.5, 3, ()),
                               ("rsqrt_", 0.5, 3, ()), ("ceil_", -3, 3, ()),
                               ("floor_", -3, 3, ()), ("round_", -3, 3, ()),
                               ("reciprocal_", 0.5, 2, ()),
                               ("tanh_", -2, 2, ()),
                               ("clip_", -2, 2, (-1.0, 1.0)),
                               ("scale_", -2, 2, (3.0, 1.0))):
        c[name] = _inplace(name, lambda r, lo=lo, hi=hi: [
            (r.rand(3, 4) * (hi - lo) + lo).astype(F32)], *args)
        c[name] = c[name]._replace(tol=TRANS_TOL)
    c["add_"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
                   lambda T, x, y: T.add_(x, y))
    c["subtract_"] = _c(lambda r: [f32(r, 3, 4), f32(r, 4)],
                        lambda T, x, y: T.subtract_(x, y))
    c["inverse"] = _c(lambda r: [spd(r)], lambda T, x: T.inverse(x), (0,),
                      LINALG_TOL)
    return c


def creation_cases():
    c = {}
    c["to_tensor"] = _c(lambda r: [],
                        lambda T: T.to_tensor([[1.5, 2.0], [3.0, 4.0]]))
    c["to_tensor@int"] = _c(lambda r: [], lambda T: T.to_tensor([[1, 2]]))
    c["to_tensor@numpy"] = _c(lambda r: [], lambda T: T.to_tensor(
        np.arange(6, dtype=np.float64).reshape(2, 3)))
    c["to_tensor@dtype"] = _c(lambda r: [],
                              lambda T: T.to_tensor(3, dtype="float32"))
    c["zeros"] = _c(lambda r: [], lambda T: T.zeros([2, 3]))
    c["zeros@int"] = _c(lambda r: [], lambda T: T.zeros([2], "int32"))
    c["ones"] = _c(lambda r: [], lambda T: T.ones([2, 3], "float64"))
    c["full"] = _c(lambda r: [], lambda T: T.full([2, 2], 1.5))
    c["full@int"] = _c(lambda r: [], lambda T: T.full([2], 3))
    c["full@bool"] = _c(lambda r: [], lambda T: T.full([2], True))
    c["full@tensor"] = _c(lambda r: [np.array([2.5], F32)],
                          lambda T, v: T.full([2, 3], v))
    c["empty"] = _c(lambda r: [], lambda T: T.shape(T.empty([3, 2])))
    for name in ("zeros_like", "ones_like"):
        c[name] = _c(lambda r: [f32(r, 2, 3)],
                     lambda T, x, n=name: getattr(T, n)(x))
        c[name + "@dtype"] = _c(lambda r: [f32(r, 2, 3)],
                                lambda T, x, n=name: getattr(T, n)(
                                    x, "int64"))
    c["full_like"] = _c(lambda r: [f32(r, 2, 3)],
                        lambda T, x: T.full_like(x, 7.0))
    c["empty_like"] = _c(lambda r: [f32(r, 2, 3)],
                         lambda T, x: T.shape(T.empty_like(x)))
    c["arange"] = _c(lambda r: [], lambda T: T.arange(5))
    c["arange@float"] = _c(lambda r: [], lambda T: T.arange(0, 1, 0.25))
    c["arange@step"] = _c(lambda r: [], lambda T: T.arange(1, 10, 3))
    c["arange@tensor"] = _c(lambda r: [np.array(4, np.int64)],
                            lambda T, n: T.arange(n))
    c["linspace"] = _c(lambda r: [], lambda T: T.linspace(0, 1, 5))
    c["logspace"] = _c(lambda r: [], lambda T: T.logspace(0, 2, 5),
                       tol=(1e-5, 1e-5))
    c["eye"] = _c(lambda r: [], lambda T: T.eye(3, 4))
    c["diag"] = _c(lambda r: [f32(r, 3)],
                   lambda T, x: T.diag(x, offset=1, padding_value=2.0), (0,))
    c["diag@matrix"] = _c(lambda r: [f32(r, 3, 4)],
                          lambda T, x: T.diag(x, offset=-1), (0,))
    c["diagflat"] = _c(lambda r: [f32(r, 2, 2)],
                       lambda T, x: T.diagflat(x, offset=1), (0,))
    c["tril"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.tril(x, -1),
                   (0,))
    c["triu"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.triu(x, 1),
                   (0,))
    c["meshgrid"] = _c(lambda r: [f32(r, 3), f32(r, 4)],
                       lambda T, a, b: T.meshgrid(a, b), (0,))
    c["meshgrid@list"] = _c(lambda r: [f32(r, 2), f32(r, 3)],
                            lambda T, a, b: T.meshgrid([a, b]), (0,))
    c["assign"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.assign(x),
                     (0,))
    c["assign@output"] = _c(lambda r: [f32(r, 3, 4), np.zeros((3, 4), F32)],
                            lambda T, x, o: T.assign(x, o))
    c["clone"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.clone(x), (0,))
    c["numel"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.numel(x))
    c["complex"] = _c(lambda r: [f32(r, 3), f32(r, 3)],
                      lambda T, a, b: T.complex(a, b))
    c["tril_indices"] = _c(lambda r: [], lambda T: T.tril_indices(4, 5, 1))
    c["triu_indices"] = _c(lambda r: [],
                           lambda T: T.triu_indices(4, None, -1))
    c["one_hot"] = _c(lambda r: [ints(r, 0, 5, 2, 3)],
                      lambda T, x: T.one_hot(x, 5))
    c["create_parameter"] = _c(lambda r: [], lambda T: T.shape(
        T.create_parameter([2, 3], "float32")))
    return c


def attribute_cases():
    c = {}
    c["shape"] = _c(lambda r: [f32(r, 2, 3)], lambda T, x: T.shape(x))
    c["rank"] = _c(lambda r: [f32(r, 2, 3)], lambda T, x: T.rank(x))
    for name in ("is_floating_point", "is_integer", "is_complex"):
        c[name] = _c(lambda r: [f32(r, 2)],
                     lambda T, x, n=name: getattr(T, n)(x))
        c[name + "@int"] = _c(lambda r: [ints(r, 0, 3, 2)],
                              lambda T, x, n=name: getattr(T, n)(x))
    for name in ("real", "imag", "conj"):
        c[name] = _c(lambda r: [cplx(r, 2, 3)],
                     lambda T, x, n=name: getattr(T, n)(x))
    c["einsum"] = _c(lambda r: [f32(r, 3, 4), f32(r, 4, 2)],
                     lambda T, a, b: T.einsum("ij,jk->ik", a, b), (0, 1),
                     (1e-5, 1e-5))
    c["einsum@batch"] = _c(lambda r: [f32(r, 2, 3, 4), f32(r, 2, 4)],
                           lambda T, a, b: T.einsum("bij,bj->bi", a, b),
                           (0, 1), (1e-5, 1e-5))
    c["Tensor"] = _c(lambda r: [f32(r, 2)],
                     lambda T, x: isinstance(x, T.Tensor))
    return c


def logic_cases():
    c = {}
    small = lambda r: [ints(r, 0, 3, 3, 4).astype(F32),  # noqa: E731
                       ints(r, 0, 3, 4).astype(F32)]
    for name in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal"):
        c[name] = _c(small, lambda T, x, y, n=name: getattr(T, n)(x, y))
    c["equal@scalar"] = _c(lambda r: [ints(r, 0, 3, 3, 4)],
                           lambda T, x: T.equal(x, 1))
    c["equal_all"] = _c(lambda r: [f32(r, 3), f32(r, 3)],
                        lambda T, x, y: T.equal_all(x, x))
    c["equal_all@differ"] = _c(lambda r: [f32(r, 3), f32(r, 3)],
                               lambda T, x, y: T.equal_all(x, y))
    c["equal_all@shape"] = _c(lambda r: [f32(r, 3), f32(r, 4)],
                              lambda T, x, y: T.equal_all(x, y))
    c["allclose"] = _c(lambda r: [f32(r, 3, 4)],
                       lambda T, x: T.allclose(x, x + 1e-7))
    c["allclose@far"] = _c(lambda r: [f32(r, 3, 4)],
                           lambda T, x: T.allclose(x, x + 1e-2))
    c["isclose"] = _c(lambda r: [f32(r, 3, 4), f32(r, 3, 4) * 1e-4],
                      lambda T, x, d: T.isclose(x, x + d, rtol=1e-4,
                                                atol=1e-5))
    bools = lambda r: [r.rand(3, 4) > 0.5, r.rand(3, 4) > 0.5]  # noqa: E731
    for name in ("logical_and", "logical_or", "logical_xor"):
        c[name] = _c(bools, lambda T, x, y, n=name: getattr(T, n)(x, y))
    c["logical_not"] = _c(bools, lambda T, x, y: T.logical_not(x))
    i32 = lambda r: [ints(r, -50, 50, 3, 4, dtype=np.int32),  # noqa: E731
                     ints(r, -50, 50, 3, 4, dtype=np.int32)]
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        c[name] = _c(i32, lambda T, x, y, n=name: getattr(T, n)(x, y))
        c[name + "@bool"] = _c(bools,
                               lambda T, x, y, n=name: getattr(T, n)(x, y))
    c["bitwise_not"] = _c(i32, lambda T, x, y: T.bitwise_not(x))
    c["is_empty"] = _c(lambda r: [np.zeros((0, 3), F32)],
                       lambda T, x: T.is_empty(x))
    c["is_empty@full"] = _c(lambda r: [f32(r, 2)],
                            lambda T, x: T.is_empty(x))
    c["is_tensor"] = _c(lambda r: [f32(r, 2)],
                        lambda T, x: (T.is_tensor(x), T.is_tensor([1.0])))
    return c


def manipulation_cases():
    c = {}
    x34 = lambda r: [f32(r, 3, 4)]  # noqa: E731
    x234 = lambda r: [f32(r, 2, 3, 4)]  # noqa: E731
    c["reshape"] = _c(x234, lambda T, x: T.reshape(x, [6, -1]), (0,))
    c["reshape@tensor"] = _c(x234, lambda T, x: T.reshape(
        x, T.to_tensor([4, 6])), (0,))
    c["reshape_"] = _c(x234, lambda T, x: T.reshape_(x, [4, 6]))
    c["flatten"] = _c(x234, lambda T, x: T.flatten(x, 1, 2), (0,))
    c["flatten_"] = _c(x234, lambda T, x: T.flatten_(x, 1, 2))
    c["transpose"] = _c(x234, lambda T, x: T.transpose(x, [2, 0, 1]), (0,))
    c["moveaxis"] = _c(x234, lambda T, x: T.moveaxis(x, [0, 1], [2, 0]),
                       (0,))
    c["swapaxes"] = _c(x234, lambda T, x: T.swapaxes(x, 0, 2), (0,))
    c["squeeze"] = _c(lambda r: [f32(r, 1, 3, 1, 2)],
                      lambda T, x: T.squeeze(x), (0,))
    c["squeeze@axis"] = _c(lambda r: [f32(r, 1, 3, 1, 2)],
                           lambda T, x: T.squeeze(x, axis=[2, 1]), (0,))
    c["squeeze_"] = _c(lambda r: [f32(r, 1, 3, 1, 2)],
                       lambda T, x: T.squeeze_(x, axis=0))
    c["unsqueeze"] = _c(x34, lambda T, x: T.unsqueeze(x, [0, -1]), (0,))
    c["unsqueeze@int"] = _c(x34, lambda T, x: T.unsqueeze(x, 1), (0,))
    c["unsqueeze_"] = _c(x34, lambda T, x: T.unsqueeze_(x, [1]))
    c["concat"] = _c(lambda r: [f32(r, 2, 3), f32(r, 2, 2)],
                     lambda T, a, b: T.concat([a, b], axis=1), (0, 1))
    c["stack"] = _c(lambda r: [f32(r, 2, 3), f32(r, 2, 3)],
                    lambda T, a, b: T.stack([a, b], axis=1), (0, 1))
    c["split"] = _c(lambda r: [f32(r, 6, 4)],
                    lambda T, x: T.split(x, 3), (0,))
    c["split@sections"] = _c(lambda r: [f32(r, 3, 7)],
                             lambda T, x: T.split(x, [2, -1, 1], axis=1),
                             (0,))
    c["chunk"] = _c(lambda r: [f32(r, 4, 6)],
                    lambda T, x: T.chunk(x, 2, axis=1), (0,))
    c["unbind"] = _c(x234, lambda T, x: T.unbind(x, axis=1), (0,))
    c["unstack"] = _c(x234, lambda T, x: T.unstack(x), (0,))
    c["tile"] = _c(x34, lambda T, x: T.tile(x, [2, 1, 3]), (0,))
    c["expand"] = _c(lambda r: [f32(r, 3, 1)],
                     lambda T, x: T.expand(x, [2, 3, 4]), (0,))
    c["expand@keep"] = _c(lambda r: [f32(r, 3, 1)],
                          lambda T, x: T.expand(x, [-1, 5]), (0,))
    c["expand_as"] = _c(lambda r: [f32(r, 3, 1), f32(r, 2, 3, 4)],
                        lambda T, x, y: T.expand_as(x, y), (0,))
    c["broadcast_to"] = _c(lambda r: [f32(r, 1, 4)],
                           lambda T, x: T.broadcast_to(x, [3, 4]), (0,))
    c["gather"] = _c(lambda r: [f32(r, 5, 3), np.array([4, 0, 2, 0])],
                     lambda T, x, i: T.gather(x, i), (0,))
    c["gather@axis"] = _c(lambda r: [f32(r, 3, 5), np.array([[1], [3]])],
                          lambda T, x, i: T.gather(x, i, axis=1), (0,))
    c["gather_nd"] = _c(lambda r: [f32(r, 3, 4, 2),
                                   np.array([[0, 1], [2, 3], [1, 0]])],
                        lambda T, x, i: T.gather_nd(x, i), (0,))
    upd = lambda r: [f32(r, 5, 3), np.array([3, 0, 1]),  # noqa: E731
                     f32(r, 3, 3)]
    c["scatter"] = _c(upd, lambda T, x, i, u: T.scatter(x, i, u), (0, 2))
    c["scatter@add"] = _c(
        lambda r: [f32(r, 5, 3), np.array([3, 0, 3]), f32(r, 3, 3)],
        lambda T, x, i, u: T.scatter(x, i, u, overwrite=False), (0, 2))
    c["scatter_"] = _c(upd, lambda T, x, i, u: T.scatter_(x, i, u))
    c["scatter_nd"] = _c(lambda r: [np.array([[1, 0], [2, 2], [1, 0]]),
                                    f32(r, 3)],
                         lambda T, i, u: T.scatter_nd(i, u, [3, 3]), (1,))
    c["scatter_nd_add"] = _c(lambda r: [f32(r, 3, 4),
                                        np.array([[1], [2], [1]]),
                                        f32(r, 3, 4)],
                             lambda T, x, i, u: T.scatter_nd_add(x, i, u),
                             (0, 2))
    c["slice"] = _c(x234, lambda T, x: T.slice(x, [1, 2], [0, 1], [2, -1]),
                    (0,))
    c["strided_slice"] = _c(x234, lambda T, x: T.strided_slice(
        x, [0, 2], [0, 3], [2, 0], [1, -2]), (0,))
    c["strided_slice@pos"] = _c(x234, lambda T, x: T.strided_slice(
        x, [1, 2], [0, 0], [3, 4], [2, 3]), (0,))
    c["index_select"] = _c(lambda r: [f32(r, 3, 5), np.array([4, 0, 4])],
                           lambda T, x, i: T.index_select(x, i, axis=1),
                           (0,))
    c["index_sample"] = _c(lambda r: [f32(r, 3, 5),
                                      np.array([[0, 4], [1, 1], [3, 2]])],
                           lambda T, x, i: T.index_sample(x, i), (0,))
    # the reference computes masked_select and repeat_interleave with
    # tensor repeats on the host, without a gradient
    c["masked_select"] = _c(lambda r: [f32(r, 3, 4), r.rand(3, 4) > 0.5],
                            lambda T, x, m: T.masked_select(x, m))
    c["masked_fill"] = _c(lambda r: [f32(r, 3, 4), r.rand(4) > 0.5],
                          lambda T, x, m: T.masked_fill(x, m, -1.5), (0,))
    c["masked_fill@tensor"] = _c(
        lambda r: [f32(r, 3, 4), r.rand(3, 4) > 0.5, np.array(2.0, F32)],
        lambda T, x, m, v: T.masked_fill(x, m, v), (0,))
    c["where"] = _c(lambda r: [r.rand(3, 4) > 0.5, f32(r, 3, 4),
                               f32(r, 4)],
                    lambda T, c_, x, y: T.where(c_, x, y), (1, 2))
    c["where@scalar"] = _c(lambda r: [r.rand(3, 4) > 0.5, f32(r, 3, 4)],
                           lambda T, c_, x: T.where(c_, x, 0.5), (1,))
    c["where@nonzero"] = _c(lambda r: [r.rand(3, 4) > 0.5],
                            lambda T, c_: T.where(c_))
    c["nonzero"] = _c(lambda r: [ints(r, 0, 2, 3, 4)],
                      lambda T, x: T.nonzero(x))
    c["nonzero@tuple"] = _c(lambda r: [ints(r, 0, 2, 3, 4)],
                            lambda T, x: T.nonzero(x, as_tuple=True))
    c["roll"] = _c(x34, lambda T, x: T.roll(x, 2), (0,))
    c["roll@axis"] = _c(x34, lambda T, x: T.roll(x, [1, -1], [0, 1]), (0,))
    c["flip"] = _c(x234, lambda T, x: T.flip(x, [0, 2]), (0,))
    c["reverse"] = _c(x234, lambda T, x: T.reverse(x, [1]), (0,))
    c["rot90"] = _c(x234, lambda T, x: T.rot90(x, 3, (1, 2)), (0,))
    dup = lambda r: [np.array([[3, 1, 3], [2, 1, 1]], np.int64)]  # noqa
    c["unique"] = _c(dup, lambda T, x: T.unique(x))
    c["unique@all"] = _c(dup, lambda T, x: T.unique(
        x, return_index=True, return_inverse=True, return_counts=True))
    c["unique@axis"] = _c(lambda r: [np.array([[1, 2], [0, 5], [1, 2]],
                                              np.int64)],
                          lambda T, x: T.unique(x, return_counts=True,
                                                axis=0))
    c["unique_consecutive"] = _c(
        lambda r: [np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64)],
        lambda T, x: T.unique_consecutive(x, return_inverse=True,
                                          return_counts=True))
    c["pad"] = _c(x234, lambda T, x: T.pad(x, [1, 2]), (0,))
    c["pad@all"] = _c(x234, lambda T, x: T.pad(
        x, [0, 1, 1, 0, 2, 2], value=0.5), (0,))
    for mode in ("reflect", "replicate", "circular"):
        c["pad@" + mode] = _c(lambda r: [f32(r, 1, 2, 4, 5)],
                              lambda T, x, m=mode: T.pad(x, [2, 1, 1, 2],
                                                         mode=m), (0,))
    c["pad@nhwc"] = _c(lambda r: [f32(r, 1, 4, 5, 2)],
                       lambda T, x: T.pad(x, [1, 1, 2, 0],
                                          data_format="NHWC"), (0,))
    c["repeat_interleave"] = _c(x34, lambda T, x: T.repeat_interleave(
        x, 2, axis=1), (0,))
    c["repeat_interleave@tensor"] = _c(
        lambda r: [f32(r, 3, 2), np.array([1, 0, 2])],
        lambda T, x, k: T.repeat_interleave(x, k, axis=0))
    c["take_along_axis"] = _c(lambda r: [f32(r, 3, 4),
                                         np.array([[0, 3], [1, 1], [2, 0]])],
                              lambda T, x, i: T.take_along_axis(x, i, 1),
                              (0,))
    c["take_along_axis@broadcast"] = _c(
        lambda r: [f32(r, 3, 4), np.array([[0, 3]])],
        lambda T, x, i: T.take_along_axis(x, i, 1), (0,))
    for red in ("assign", "add", "multiply"):
        c["put_along_axis@" + red] = _c(
            lambda r: [f32(r, 3, 4), np.array([[0], [3], [1]]),
                       f32(r, 3, 1)],
            lambda T, x, i, v, m=red: T.put_along_axis(x, i, v, 1,
                                                       reduce=m),
            (0, 2) if red != "multiply" else ())
    c["put_along_axis"] = _c(lambda r: [f32(r, 3, 4),
                                        np.array([[0], [3], [1]])],
                             lambda T, x, i: T.put_along_axis(x, i, 9.0, 1),
                             (0,))
    c["cast"] = _c(x34, lambda T, x: T.cast(x * 3, "int32"))
    c["cast@bf16"] = _c(x34, lambda T, x: T.cast(x, "bfloat16"), (),
                        (2 ** -8, 0.0))
    c["crop"] = _c(x234, lambda T, x: T.crop(x, [2, 2, -1], [0, 1, 1]),
                   (0,))
    c["tensordot"] = _c(lambda r: [f32(r, 2, 3, 4), f32(r, 3, 4, 5)],
                        lambda T, x, y: T.tensordot(x, y, 2), (0, 1),
                        (1e-5, 1e-5))
    c["tensordot@axes"] = _c(lambda r: [f32(r, 2, 3, 4), f32(r, 4, 2)],
                             lambda T, x, y: T.tensordot(x, y,
                                                         [[2, 0], [0, 1]]),
                             (0, 1), (1e-5, 1e-5))
    c["as_complex"] = _c(lambda r: [f32(r, 3, 2)],
                         lambda T, x: T.as_complex(x))
    c["as_real"] = _c(lambda r: [cplx(r, 3)], lambda T, x: T.as_real(x))
    c["tolist"] = _c(lambda r: [ints(r, 0, 9, 2, 3)],
                     lambda T, x: T.tolist(x))
    c["shard_index"] = _c(lambda r: [ints(r, 0, 20, 6, 1)],
                          lambda T, x: T.shard_index(x, 20, 3, 1))
    c["multiplex"] = _c(lambda r: [f32(r, 4, 3), f32(r, 4, 3),
                                   np.array([[1], [0], [1], [1]])],
                        lambda T, a, b, i: T.multiplex([a, b], i), (0, 1))
    return c


def search_cases():
    c = {}
    tied = lambda r: [np.array([[2.0, 1.0, 2.0, 0.5, 1.0],  # noqa: E731
                                [3.0, 3.0, 1.0, 3.0, 1.0]], F32)]
    for name in ("argmax", "argmin"):
        c[name] = _c(tied, lambda T, x, n=name: getattr(T, n)(x, axis=1))
        c[name + "@flat"] = _c(tied, lambda T, x, n=name: getattr(T, n)(
            x, keepdim=True))
    # ties: stable (lowest index first, descending too)
    c["argsort"] = _c(tied, lambda T, x: T.argsort(x, axis=1))
    c["argsort@descending"] = _c(tied, lambda T, x: T.argsort(
        x, axis=1, descending=True))
    c["sort"] = _c(lambda r: [f32(r, 3, 5)],
                   lambda T, x: T.sort(x, axis=0), (0,))
    c["sort@descending"] = _c(lambda r: [f32(r, 3, 5)],
                              lambda T, x: T.sort(x, descending=True), (0,))
    c["topk"] = _c(tied, lambda T, x: T.topk(x, 3))
    c["topk@smallest"] = _c(tied, lambda T, x: T.topk(x, 2, largest=False))
    c["topk@axis"] = _c(lambda r: [f32(r, 4, 3)],
                        lambda T, x: T.topk(x, 2, axis=0), (0,))
    c["searchsorted"] = _c(lambda r: [np.array([1.0, 2.0, 2.0, 5.0], F32),
                                      np.array([[2.0, 0.0], [5.0, 3.0]],
                                               F32)],
                           lambda T, s, v: T.searchsorted(s, v))
    c["searchsorted@right"] = _c(
        lambda r: [np.array([[1.0, 2.0, 2.0], [0.0, 1.0, 4.0]], F32),
                   np.array([[2.0], [1.0]], F32)],
        lambda T, s, v: T.searchsorted(s, v, out_int32=True, right=True))
    c["kthvalue"] = _c(tied, lambda T, x: T.kthvalue(x, 2, axis=1))
    c["kthvalue@keepdim"] = _c(lambda r: [f32(r, 3, 5)],
                               lambda T, x: T.kthvalue(x, 3, axis=0,
                                                       keepdim=True), (0,))
    # ties: the largest of the most frequent values, at its last position
    c["mode"] = _c(lambda r: [np.array([[1, 2, 2, 1, 3],
                                        [4, 4, 0, 0, 0],
                                        [7, 5, 5, 7, 6]], F32)],
                   lambda T, x: T.mode(x))
    c["mode@axis"] = _c(lambda r: [ints(r, 0, 3, 5, 4)],
                        lambda T, x: T.mode(x, axis=0, keepdim=True))
    return c


def stat_cases():
    c = {}
    x = lambda r: [f32(r, 3, 4, 5)]  # noqa: E731
    for name in ("std", "var"):
        c[name] = _c(x, lambda T, a, n=name: getattr(T, n)(a), (0,),
                     (1e-5, 1e-5))
        c[name + "@axis"] = _c(x, lambda T, a, n=name: getattr(T, n)(
            a, axis=[0, 2], unbiased=False, keepdim=True), (0,),
            (1e-5, 1e-5))
    c["median"] = _c(lambda r: [f32(r, 3, 4)],
                     lambda T, a: T.median(a, axis=1), (0,))
    c["median@odd"] = _c(lambda r: [f32(r, 3, 5)],
                         lambda T, a: T.median(a), (0,))
    c["median@min"] = _c(lambda r: [f32(r, 3, 4)],
                         lambda T, a: T.median(a, axis=1, mode="min"))
    c["nanmedian"] = _c(lambda r: [np.array([[1.0, np.nan, 3.0, 0.5],
                                             [2.0, 4.0, 1.0, 3.0]], F32)],
                        lambda T, a: T.nanmedian(a, axis=1, keepdim=True))
    c["quantile"] = _c(x, lambda T, a: T.quantile(a, [0.25, 0.5], axis=1),
                       (0,), (1e-5, 1e-5))
    c["quantile@axes"] = _c(x, lambda T, a: T.quantile(
        a, 0.3, axis=[0, 2], keepdim=True), (0,), (1e-5, 1e-5))
    c["nanquantile"] = _c(lambda r: [np.array([[1.0, np.nan, 3.0, 0.5],
                                               [2.0, 4.0, 1.0, 3.0]], F32)],
                          lambda T, a: T.nanquantile(a, 0.4, axis=1),
                          (), (1e-5, 1e-5))
    return c


def linalg_cases():
    c = {}
    sq = lambda r: [f32(r, 4, 4) + 4 * np.eye(4, dtype=F32)]  # noqa: E731
    for p in ("fro", 1, 2, 3, np.inf, -np.inf):
        c[f"norm@{p}"] = _c(lambda r: [f32(r, 3, 4)],
                            lambda T, x, p=p: T.norm(x, p=p), (0,),
                            (1e-5, 1e-5))
    c["norm"] = _c(lambda r: [f32(r, 3, 4)],
                   lambda T, x: T.norm(x, p=2, axis=1, keepdim=True), (0,),
                   (1e-5, 1e-5))
    c["norm@matrix"] = _c(lambda r: [f32(r, 2, 3, 4)],
                          lambda T, x: T.norm(x, p="fro", axis=[1, 2]),
                          (0,), (1e-5, 1e-5))
    c["norm@zero"] = _c(lambda r: [ints(r, 0, 2, 3, 4).astype(F32)],
                        lambda T, x: T.norm(x, p=0, axis=1))
    c["cholesky"] = _c(lambda r: [spd(r)], lambda T, x: T.cholesky(x),
                       (0,), LINALG_TOL)
    c["cholesky@upper"] = _c(lambda r: [spd(r)],
                             lambda T, x: T.cholesky(x, upper=True), (),
                             LINALG_TOL)
    c["qr"] = _c(lambda r: [f32(r, 5, 3)], lambda T, x: T.qr(x), (),
                 LINALG_TOL, "recon")
    c["svd"] = _c(lambda r: [f32(r, 4, 3)], lambda T, x: T.svd(x), (),
                  LINALG_TOL, "recon")
    c["inv"] = _c(sq, lambda T, x: T.inv(x), (0,), LINALG_TOL)
    c["det"] = _c(sq, lambda T, x: T.det(x), (0,), LINALG_TOL)
    c["slogdet"] = _c(sq, lambda T, x: T.slogdet(x), (0,), LINALG_TOL)
    # eigenvalues 1, 3 and a complex pair near ±2i
    rot = lambda r: [np.array([[0, -2, 0, 0], [2, 0, 0, 0],  # noqa: E731
                               [0, 0, 1, 1], [0, 0, 0, 3]], F32)
                     + 0.05 * f32(r, 4, 4)]
    c["eig"] = _c(rot, lambda T, x: T.eig(x), (), LINALG_TOL, "sets")
    c["eigvals"] = _c(rot, lambda T, x: T.eigvals(x), (), LINALG_TOL,
                      "sets")
    c["eigh"] = _c(lambda r: [spd(r)], lambda T, x: T.eigh(x), (),
                   LINALG_TOL, "recon")
    c["eigvalsh"] = _c(lambda r: [spd(r)], lambda T, x: T.eigvalsh(x),
                       (0,), LINALG_TOL)
    c["solve"] = _c(lambda r: [spd(r), f32(r, 4, 2)],
                    lambda T, a, b: T.solve(a, b), (0, 1), LINALG_TOL)
    c["solve@vector"] = _c(lambda r: [spd(r), f32(r, 4)],
                           lambda T, a, b: T.solve(a, b), (0, 1), LINALG_TOL)
    tri = lambda r: [np.triu(f32(r, 4, 4)) + 3 * np.eye(4,  # noqa: E731
                                                         dtype=F32),
                     f32(r, 4, 2)]
    c["triangular_solve"] = _c(tri, lambda T, a, b: T.triangular_solve(a, b),
                               (0, 1), LINALG_TOL)
    c["triangular_solve@transpose"] = _c(
        tri, lambda T, a, b: T.triangular_solve(a, b, transpose=True,
                                                unitriangular=True),
        (1,), LINALG_TOL)
    c["lstsq"] = _c(lambda r: [f32(r, 6, 3), f32(r, 6, 2)],
                    lambda T, a, b: T.lstsq(a, b), (), LINALG_TOL)
    c["matrix_power"] = _c(lambda r: [f32(r, 3, 3) * 0.5],
                           lambda T, x: T.matrix_power(x, 3), (0,),
                           (1e-5, 1e-5))
    c["matrix_power@inverse"] = _c(sq, lambda T, x: T.matrix_power(x, -2),
                                   (), LINALG_TOL)
    c["pinv"] = _c(lambda r: [f32(r, 5, 3)], lambda T, x: T.pinv(x), (),
                   LINALG_TOL)
    c["cross"] = _c(lambda r: [f32(r, 4, 3), f32(r, 4, 3)],
                    lambda T, x, y: T.cross(x, y), (0, 1))
    c["cross@axis"] = _c(lambda r: [f32(r, 3, 2), f32(r, 3, 2)],
                         lambda T, x, y: T.cross(x, y, axis=0), (0, 1))
    c["t"] = _c(lambda r: [f32(r, 3, 4)], lambda T, x: T.t(x), (0,))
    c["t@vector"] = _c(lambda r: [f32(r, 3)], lambda T, x: T.t(x), (0,))
    for p in (2, 1, 0, np.inf, -np.inf, 3):
        c[f"dist@{p}"] = _c(lambda r: [f32(r, 3, 4), f32(r, 4)],
                            lambda T, x, y, p=p: T.dist(x, y, p),
                            (0, 1) if p not in (0,) else (), (1e-5, 1e-5))
    c["dist"] = c.pop("dist@2")
    c["cond"] = _c(sq, lambda T, x: T.cond(x), (), LINALG_TOL)
    c["cond@fro"] = _c(sq, lambda T, x: T.cond(x, "fro"), (), LINALG_TOL)
    c["matrix_rank"] = _c(lambda r: [np.array([[1, 2, 3], [2, 4, 6],
                                               [0, 1, 1]], F32)],
                          lambda T, x: T.matrix_rank(x))
    c["matrix_rank@tol"] = _c(lambda r: [np.diag([1.0, 0.5, 1e-3]).astype(
        F32)], lambda T, x: T.matrix_rank(x, tol=1e-2))
    c["mv"] = _c(lambda r: [f32(r, 3, 4), f32(r, 4)],
                 lambda T, x, v: T.mv(x, v), (0, 1), (1e-5, 1e-5))
    c["histogram"] = _c(lambda r: [f32(r, 50)],
                        lambda T, x: T.histogram(x, bins=7))
    c["histogram@range"] = _c(lambda r: [f32(r, 50)],
                              lambda T, x: T.histogram(x, 5, -1.0, 1.0))
    c["bincount"] = _c(lambda r: [ints(r, 0, 6, 20)],
                       lambda T, x: T.bincount(x, minlength=8))
    c["cov"] = _c(lambda r: [f32(r, 3, 6)], lambda T, x: T.cov(x), (0,),
                  (1e-5, 1e-5))
    c["cov@cols"] = _c(lambda r: [f32(r, 6, 3), pos(r, 6)],
                       lambda T, x, w: T.cov(x, rowvar=False, ddof=False,
                                             aweights=w), (0,),
                       (1e-5, 1e-5))
    c["corrcoef"] = _c(lambda r: [f32(r, 3, 6)], lambda T, x: T.corrcoef(x),
                       (0,), (1e-5, 1e-5))
    return c


def random_cases():
    """Moments over RANDOM_N draws: ``RANDOM_STATS[name]`` is (mean, std,
    tolerance) of the distribution, checked on each side."""
    n = RANDOM_N
    c = {}
    r = "random"
    c["rand"] = _c(lambda _: [], lambda T: T.rand([n]), kind=r)
    c["randn"] = _c(lambda _: [], lambda T: T.randn([n]), kind=r)
    c["standard_normal"] = _c(lambda _: [],
                              lambda T: T.standard_normal([n], "float64"),
                              kind=r)
    c["uniform"] = _c(lambda _: [], lambda T: T.uniform([n], min=2.0,
                                                        max=4.0), kind=r)
    c["normal"] = _c(lambda _: [], lambda T: T.normal(1.0, 2.0, [n]),
                     kind=r)
    c["normal@tensor"] = _c(lambda _: [np.full(n, 3.0, F32)],
                            lambda T, m: T.normal(m, 0.5), kind=r)
    c["randint"] = _c(lambda _: [], lambda T: T.randint(0, 10, [n]),
                      kind=r)
    c["randint_like"] = _c(lambda _: [np.zeros(n, np.int32)],
                           lambda T, x: T.randint_like(x, 5, 9), kind=r)
    c["randperm"] = _c(lambda _: [],
                       lambda T: T.sort(T.randperm(64)), kind="value")
    c["bernoulli"] = _c(lambda _: [np.full(n, 0.3, F32)],
                        lambda T, p: T.bernoulli(p), kind=r)
    c["multinomial"] = _c(lambda _: [np.array([0.1, 0.2, 0.7], F32)],
                          lambda T, p: T.multinomial(p, n, True), kind=r)
    # without replacement: each index once in every row
    c["multinomial@unique"] = _c(
        lambda _: [np.tile(np.array([0.1, 0.2, 0.3, 0.4], F32), (3, 1))],
        lambda T, p: T.sort(T.multinomial(p, 4), axis=1), kind="value")
    c["poisson"] = _c(lambda _: [np.full(n, 4.0, F32)],
                      lambda T, lam: T.poisson(lam), kind=r)
    c["uniform_"] = _c(lambda _: [np.zeros(n, F32)],
                       lambda T, x: T.uniform_(x, -3.0, 1.0), kind=r)
    c["normal_"] = _c(lambda _: [np.zeros(n, F32)],
                      lambda T, x: T.normal_(x, -1.0, 0.5), kind=r)
    c["exponential_"] = _c(lambda _: [np.zeros(n, F32)],
                           lambda T, x: T.exponential_(x, 2.0), kind=r)
    return c


RANDOM_STATS = {
    "rand": (0.5, 12 ** -0.5), "randn": (0.0, 1.0),
    "standard_normal": (0.0, 1.0), "uniform": (3.0, 2 * 12 ** -0.5),
    "normal": (1.0, 2.0), "normal@tensor": (3.0, 0.5),
    "randint": (4.5, (99 / 12) ** 0.5), "randint_like": (6.5, 1.25 ** 0.5),
    "bernoulli": (0.3, (0.21) ** 0.5), "multinomial": (1.6, 0.44 ** 0.5),
    "poisson": (4.0, 2.0), "uniform_": (-1.0, 4 * 12 ** -0.5),
    "normal_": (-1.0, 0.5), "exponential_": (0.5, 0.5),
}


def sequence_cases():
    c = {}
    lens = np.array([3, 1, 0, 4], np.int64)
    batch = lambda r: [f32(r, 4, 5, 2), lens]  # noqa: E731
    c["sequence_mask"] = _c(lambda r: [lens],
                            lambda T, n: T.sequence_mask(n))
    c["sequence_mask@maxlen"] = _c(lambda r: [lens],
                                   lambda T, n: T.sequence_mask(
                                       n, maxlen=6, dtype="float32"))
    for pt in ("sum", "average", "sqrt", "max", "min", "first", "last"):
        c["sequence_pool@" + pt] = _c(
            batch, lambda T, x, n, pt=pt: T.sequence_pool(x, pt, n,
                                                          pad_value=-1.0),
            (0,) if pt not in ("max", "min") else ())
    c["sequence_pool"] = c.pop("sequence_pool@sum")
    c["sequence_first_step"] = _c(batch, lambda T, x, n:
                                  T.sequence_first_step(x, n), (0,))
    c["sequence_last_step"] = _c(batch, lambda T, x, n:
                                 T.sequence_last_step(x, n), (0,))
    c["sequence_softmax"] = _c(lambda r: [f32(r, 4, 5),
                                          np.array([3, 1, 5, 2])],
                               lambda T, x, n: T.sequence_softmax(x, n),
                               (0,), TRANS_TOL)
    c["sequence_reverse"] = _c(batch, lambda T, x, n:
                               T.sequence_reverse(x, n), (0,))
    c["sequence_enumerate"] = _c(
        lambda r: [ints(r, 1, 9, 3, 5), np.array([5, 2, 3])],
        lambda T, x, n: T.sequence_enumerate(x, 3, pad_value=0, lengths=n))
    c["sequence_pad"] = _c(lambda r: [f32(r, 6, 2), np.array([2, 3, 1])],
                           lambda T, x, n: T.sequence_pad(x, 0.5, length=n))
    c["sequence_pad@maxlen"] = _c(
        lambda r: [f32(r, 3, 4), np.array([3, 1, 4])],
        lambda T, x, n: T.sequence_pad(x, maxlen=2, length=n))
    c["sequence_unpad"] = _c(batch, lambda T, x, n: T.sequence_unpad(x, n))
    c["sequence_expand"] = _c(lambda r: [f32(r, 3, 2), np.array([2, 0, 3])],
                              lambda T, x, n: T.sequence_expand(x, n))
    c["sequence_expand_as"] = _c(lambda r: [f32(r, 3, 2),
                                            np.array([1, 2, 1])],
                                 lambda T, x, n: T.sequence_expand_as(x, n))
    c["sequence_concat"] = _c(
        lambda r: [f32(r, 3, 4, 2), np.array([2, 4, 1]), f32(r, 3, 3, 2),
                   np.array([3, 0, 2])],
        lambda T, a, na, b, nb: T.sequence_concat([a, b], [na, nb]))
    c["sequence_slice"] = _c(
        lambda r: [f32(r, 3, 5), np.array([5, 3, 4]), np.array([1, 0, 2]),
                   np.array([3, 2, 2])],
        lambda T, x, n, o, ln: T.sequence_slice(x, o, ln, lengths=n))
    return c


def array_cases():
    def write_read(T, x, y):
        arr = T.create_array("float32")
        T.array_write(x, 0, arr)
        T.array_write(y, 2, arr)
        return T.array_read(arr, 2), T.array_length(arr)

    c = {"array_write": _c(lambda r: [f32(r, 2), f32(r, 3)], write_read),
         "array_read": _c(lambda r: [f32(r, 2), f32(r, 3)], write_read),
         "array_length": _c(lambda r: [f32(r, 2), f32(r, 3)], write_read),
         "create_array": _c(lambda r: [f32(r, 2)],
                            lambda T, x: T.array_read(
                                T.create_array("float32", [x]), 0))}
    return c


GROUPS = {
    "math": math_cases, "creation": creation_cases,
    "attribute": attribute_cases, "logic": logic_cases,
    "manipulation": manipulation_cases, "search": search_cases,
    "stat": stat_cases, "linalg": linalg_cases, "random": random_cases,
    "sequence": sequence_cases, "array": array_cases,
}


def all_cases():
    out = {}
    for group in GROUPS.values():
        out.update(group())
    return out


def base_name(case_name: str) -> str:
    return case_name.split("@")[0]


def recon(name, outs):
    """The product of a factorization's factors (numpy, f64)."""
    if name == "qr":
        q, r = outs
        return [q @ r]
    if name == "svd":
        u, s, vh = outs
        return [(u * s[..., None, :]) @ vh, s]
    if name == "eigh":
        w, v = outs
        return [(v * w[..., None, :]) @ np.swapaxes(v, -1, -2), w]
    raise KeyError(name)


def sets(outs):
    """Complex eigenvalues in one order: by real part, then imaginary
    (each rounded for the ordering only)."""
    w = np.asarray(outs[0]).astype(np.complex128)
    order = np.lexsort((np.round(w.imag, 3), np.round(w.real, 3)))
    return [w[order]]


# ---------------------------------------------------------------------------
# running a case
# ---------------------------------------------------------------------------
def flatten(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in flatten(o)]
    return [out]


class PortAdapter:
    """Runs cases through ``paddle_tpu_torch.tensor`` on ``device``."""

    def __init__(self, T, device="cpu"):
        import torch

        self.torch, self.T, self.device = torch, T, torch.device(device)

    def tensor(self, a, requires_grad):
        t = self.torch.from_numpy(np.array(a)).to(self.device)
        return t.requires_grad_(requires_grad)

    def is_tensor(self, o):
        return isinstance(o, self.torch.Tensor)

    def numpy(self, o):
        """(array, dtype name) of an output."""
        if not self.is_tensor(o):
            return np.asarray(o), None
        name = str(o.dtype).replace("torch.", "")
        o = o.detach().cpu()
        if o.dtype == self.torch.bfloat16:
            o = o.float()
        return o.resolve_conj().numpy(), name

    def backward(self, out, ct):
        (out * ct).sum().backward()

    def grad(self, t):
        return t.grad.detach().cpu().numpy()


def run(name, case, adapter, seed=0, guard=None):
    """(values as [(array, dtype name)], gradients) of ``case`` through
    ``adapter``. ``guard(name)``, when given, is a context around the call
    and around the backward alone (the inputs and the cotangent are made
    outside it)."""
    import contextlib

    guard = guard or (lambda _: contextlib.nullcontext())
    args = case.inputs(np.random.RandomState(seed))
    targs = [adapter.tensor(a, i in case.grad)
             if isinstance(a, np.ndarray) else a
             for i, a in enumerate(args)]
    with guard(name):
        flat = flatten(case.call(adapter.T, *targs))
    values = [adapter.numpy(o) for o in flat]
    grads = []
    if case.grad:
        first = flat[0]
        ct = adapter.tensor(cotangent(tuple(first.shape)), False)
        with guard(name):
            adapter.backward(first, ct)
        grads = [adapter.grad(targs[i]) for i in case.grad]
    return values, grads


def _worst(got, want, rtol, atol):
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return np.inf
    if got.dtype == bool or want.dtype == bool:
        return 0.0 if np.array_equal(got, want) else np.inf
    g = got.astype(np.complex128 if np.iscomplexobj(got)
                   or np.iscomplexobj(want) else np.float64)
    w = want.astype(g.dtype)
    both_nan = np.isnan(g) & np.isnan(w)
    ex = np.where(both_nan, 0.0, np.abs(g - w) - rtol * np.abs(w))
    ex = np.where(np.isnan(ex), np.inf, ex)
    return float(max(ex.max(initial=0.0), 0.0)) if ex.size else 0.0


def compare(name, case, got, want, check_dtype=True):
    """The worst error beyond ``rtol·|want|`` of values and of gradients;
    raises AssertionError where one is beyond ``atol`` or a dtype or shape
    differs."""
    (gv, gg), (wv, wg) = got, want
    rtol, atol = case.tol
    base = base_name(name)
    if case.kind == "random":
        return compare_random(name, gv)
    assert len(gv) == len(wv), (name, len(gv), len(wv))
    if check_dtype:
        for (_, gd), (_, wd) in zip(gv, wv):
            assert gd == wd, f"{name}: dtype {gd} != {wd}"
    ga, wa = [v for v, _ in gv], [v for v, _ in wv]
    if case.kind == "recon":
        ga, wa = recon(base, ga), recon(base, wa)
    elif case.kind == "sets":
        ga, wa = sets(ga), sets(wa)
    worst_v = max((_worst(g, w, rtol, atol) for g, w in zip(ga, wa)),
                  default=0.0)
    worst_g = max((_worst(g, w, rtol, atol) for g, w in zip(gg, wg)),
                  default=0.0)
    assert len(gg) == len(wg), name
    assert worst_v <= atol, f"{name}: values off by {worst_v:.3g}"
    assert worst_g <= atol, f"{name}: gradients off by {worst_g:.3g}"
    return worst_v, worst_g


def compare_random(name, values):
    """A random case's first output against its distribution's mean and
    standard deviation (each within 5 standard errors of ``RANDOM_N``
    draws)."""
    arr = np.asarray(values[0][0], np.float64).reshape(-1)
    mean, std = RANDOM_STATS[name]
    se = std / np.sqrt(arr.size)
    assert abs(arr.mean() - mean) <= 5 * se, (name, arr.mean(), mean)
    # the sample deviation's standard error, for a kurtosis up to 9 (the
    # exponential's)
    assert abs(arr.std() - std) <= 5 * std * np.sqrt(2 / arr.size) + 1e-6, (
        name, arr.std(), std)
    return 0.0, 0.0
