"""The port's ring attention (``ops.attention.ring_attention``) against
the reference's ``shard_map`` ring and its whole-sequence attention, on
the CPU: the port in a gloo world of 4 ranks (a (4 / sp, sp) mesh, so sp
= 2 and 4, and 1: one causal hop), the reference on 4 devices of its
virtual CPU mesh; causal and over every key, the forward (rtol 2e-4,
atol 1e-5) and the gradients of sum(out²) (rtol 5e-3, atol 1e-4), the
reference's tolerances (``tests/test_distributed.py``). Also the hop
schedule of 4 ranks run in one process (what ``chip_smoke.py`` phase 24b
feeds the kernels), the ``PADDLE_TPU_ATTN_POLICY=ring`` dispatch over a
registered axis, and ``ring_position_offset``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
import torch_threads  # noqa: F401  (one torch thread a worker)
from torch_dist_world import World

FWD_RTOL, FWD_ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
B, H, L, D = 2, 2, 32, 16


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("ring4")))
    yield w
    w.close()


def _qkv(seed=0, b=B, h=H, l=L, d=D):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(b, h, l, d).astype(np.float32) for _ in range(3))


def _reference_ring(q, k, v, sp, causal):
    """The reference's ring under shard_map on sp devices: the output and
    the gradients of sum(out²)."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, None, "sp")
    f = jatt._shard_map_fn()(
        lambda a, b_, c: jatt.ring_attention(a, b_, c, "sp", causal),
        mesh, (spec,) * 3, spec)
    loss = lambda *t: jnp.sum(f(*t) ** 2)
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _full(q, k, v, causal):
    return np.asarray(jatt.xla_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_matches_the_references_ring(world, sp, causal):
    q, k, v = _qkv(seed=sp)
    ref_out, ref_grads = _reference_ring(q, k, v, max(sp, 1), causal)
    np.testing.assert_allclose(ref_out, _full(q, k, v, causal),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    res = world.run("ring", q=q, k=k, v=v, sp=sp, causal=causal)
    n = L // sp
    for r in res:
        sl = slice(r["coord"] * n, (r["coord"] + 1) * n)
        np.testing.assert_allclose(r["out"], ref_out[:, :, sl],
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        for g, rg in zip(r["grads"], ref_grads):
            np.testing.assert_allclose(g, rg[:, :, sl], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
        # the forced policy dispatches the same ring; positions offset
        np.testing.assert_allclose(r["dispatched"], r["out"], rtol=1e-6,
                                   atol=1e-7)
        assert r["offset"] == r["coord"] * n


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_hop_schedule_in_one_process_matches_whole_attention(causal,
                                                             monkeypatch):
    """Four ranks of the ring's own schedule (``ring_forward`` and
    ``ring_backward``) in one process, the rotation a list
    (``ring_list_rotate``, what ``chip_smoke.py`` phase 24b runs): forward
    merged in f32, backward with the merged lse and the dK/dV partials
    travelling with their shard, against the reference's attention over
    the whole sequence and its autodiff."""
    n = 4
    q, k, v = _qkv(seed=7)
    blhd = [torch.from_numpy(a).transpose(1, 2).contiguous()
            for a in (q, k, v)]
    c = L // n
    qs, ks, vs = [[t[:, i * c:(i + 1) * c].contiguous() for i in range(n)]
                  for t in blhd]
    hops = []
    hop_forward = tatt.ring_hop_forward

    def counted(*a):
        res = hop_forward(*a)
        hops.append(res is not None)
        return res

    monkeypatch.setattr(tatt, "ring_hop_forward", counted)
    ranks, rotate = list(range(n)), tatt.ring_list_rotate
    outs, lses = tatt.ring_forward(qs, ks, vs, ranks, n, causal, rotate)
    assert sum(hops) == (n * (n + 1) // 2 if causal else n * n)
    out = torch.cat(outs, 1).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, _full(q, k, v, causal), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    # backward of sum(out²): dout = 2·out
    grads = tatt.ring_backward(qs, ks, vs, [2 * o for o in outs], lses,
                               outs, ranks, n, causal, rotate)
    loss = lambda *t: jnp.sum(jatt.xla_attention(*t, causal=causal) ** 2)
    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for got, want in zip(grads, ref):
        g = torch.cat(got, 1).transpose(1, 2).numpy()
        np.testing.assert_allclose(g, np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_ring_without_a_registered_axis_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ATTN_POLICY", "ring")
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    with pytest.raises(NotImplementedError, match="no ring is registered"):
        tatt.dot_product_attention(q, k, v, causal=True)
    assert tatt.ring_position_offset(16) == 0
