"""Shared helpers of the port's parity tests: call a function (or layer)
of the reference and of the port on the same numpy inputs and return the
first output and the gradients of the chosen inputs for one cotangent —
the reference's through its autograd tape (its ``jax.vjp`` per op), the
port's through torch autograd."""
import numpy as np
import torch

import paddle_tpu as paddle


def cotangent(shape, seed=1):
    return np.asarray(np.random.RandomState(seed).rand(*shape) + 0.5,
                      np.float32)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def ref_call(fn, args, kwargs=None, grad=()):
    """``(output, [grads])`` of the reference's ``fn``: numpy arrays
    become tensors (those at positions ``grad`` differentiable)."""
    targs = [paddle.to_tensor(a, stop_gradient=i not in grad)
             if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    out = _first(fn(*targs, **(kwargs or {})))
    value = np.asarray(out.numpy())
    if not grad:
        return value, []
    ct = cotangent(value.shape)
    (out * paddle.to_tensor(ct)).sum().backward()
    return value, [np.asarray(targs[i].grad.numpy()) for i in grad]


def port_call(fn, args, kwargs=None, grad=(), device="cpu"):
    """``(output, [grads])`` of the port's ``fn`` on ``device``."""
    targs = [torch.from_numpy(np.array(a)).to(device).requires_grad_(
        i in grad) if isinstance(a, np.ndarray) else a
        for i, a in enumerate(args)]
    out = _first(fn(*targs, **(kwargs or {})))
    value = out.detach().cpu().numpy()
    if not grad:
        return value, []
    ct = torch.from_numpy(cotangent(value.shape)).to(device)
    (out * ct).sum().backward()
    return value, [targs[i].grad.cpu().numpy() for i in grad]


def assert_close(got, want, rtol, atol, what=""):
    got, want = list(got), list(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def ref_jit_call(fn, args, kwargs=None, grad=()):
    """``ref_call`` compiled: the reference's ``fn`` and its vjp traced
    into one ``jax.jit`` (numpy arrays in ``kwargs`` become constant
    tensors), so a function whose eager form dispatches op by op runs
    once as one program. Gradients are those of the positions ``grad``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import wrap_raw

    def wrap(v):
        return wrap_raw(jnp.asarray(v)) if isinstance(v, np.ndarray) else v

    def value(*diff):
        full = [wrap(a) for a in args]
        for i, v in zip(grad, diff):
            full[i] = wrap_raw(v)
        out = _first(fn(*full, **{k: wrap(v) for k, v in
                                  (kwargs or {}).items()}))
        return out._value

    if not grad:
        return np.asarray(jax.jit(value)()), []

    def with_grads(*diff):
        out, vjp = jax.vjp(value, *diff)
        return out, vjp(jnp.asarray(cotangent(out.shape)))

    out, grads = jax.jit(with_grads)(*[args[i] for i in grad])
    return np.asarray(out), [np.asarray(g) for g in grads]
