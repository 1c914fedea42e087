"""Port attention (paddle_tpu_torch.ops.attention) against the reference:
both paged tiers against the reference's `_paged_gather_impl` /
`_paged_scan_impl` on random pages, tables, positions and lengths (stale
slots past kv_len, padded rows with kv_len 0), and the dense dispatch
against `xla_attention`, with and without an additive bias."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import quant as jquant
from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import tier_policy
import torch_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-5


def _paged_case(B, T, seed, N=12, bs=4, H=2, D=8, M=5):
    rng = np.random.RandomState(seed)
    # every page holds random values: slots past kv_len are stale data the
    # mask must keep unreadable, never zeros that would hide a leak
    k_pages = rng.randn(N, bs, H, D).astype(np.float32)
    v_pages = rng.randn(N, bs, H, D).astype(np.float32)
    q = rng.randn(B, T, H, D).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    qpos = np.zeros((B, T), np.int32)
    lens = np.zeros((B,), np.int32)
    for i in range(B - 1):  # the last row is padding: kv_len 0
        n = rng.randint(T, M * bs + 1)
        used = -(-n // bs)
        tables[i, :used] = rng.choice(np.arange(1, N), used, replace=False)
        lens[i] = n
        qpos[i] = n - T + np.arange(T)
    return q, k_pages, v_pages, tables, qpos, lens


@pytest.mark.parametrize("impl", ["_paged_gather_impl", "_paged_scan_impl"])
@pytest.mark.parametrize("B,T,seed", [(3, 1, 0), (4, 1, 1), (2, 4, 2),
                                      (3, 6, 3)])
def test_paged_tier_matches_reference(impl, B, T, seed):
    case = _paged_case(B, T, seed)
    ref = np.asarray(getattr(jatt, impl)(*(jnp.asarray(a) for a in case)))
    got = getattr(tatt, impl)(*(torch.from_numpy(a) for a in case)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_paged_tiers_agree_and_dispatch_follows_heuristic():
    case = [torch.from_numpy(a) for a in _paged_case(3, 2, seed=9)]
    gather = tatt._paged_gather_impl(*case)
    scan = tatt._paged_scan_impl(*case)
    torch.testing.assert_close(gather, scan, atol=TOL, rtol=0)
    assert torch.equal(tatt.paged_attention(*case), gather)  # 5·4 <= 4096
    assert tier_policy._paged_heuristic(256, 16) == "paged_gather"
    assert tier_policy._paged_heuristic(257, 16) == "paged_scan"


def test_paged_int8_scales_wait_for_quant():
    """int8 pages, which used to wait for the quant port: both tiers with
    the reference's int8 pages and per-token-head scales against the
    reference's tiers on the same pages, and a scale passed alone
    refused."""
    q, k, v, tables, qpos, lens = _paged_case(3, 2, seed=1)
    (kq, ks), (vq, vs) = (jquant.quantize_kv(jnp.asarray(a)) for a in (k, v))
    args = [q, kq, vq, tables, qpos, lens]
    t = [torch.from_numpy(np.asarray(a)) for a in args + [ks, vs]]
    for impl in ("_paged_gather_impl", "_paged_scan_impl"):
        ref = np.asarray(getattr(jatt, impl)(
            *(jnp.asarray(a) for a in args), ks, vs))
        got = getattr(tatt, impl)(*t).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    t = t[:6]
    with pytest.raises(ValueError, match="both"):
        tatt.paged_attention(*t, k_scale=torch.from_numpy(np.asarray(ks)))


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_dispatch_matches_xla_attention(layout, causal):
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 24, 3, 16).astype(np.float32) for _ in range(3))
    ref = np.asarray(jatt.xla_attention(q, k, v, causal=causal,
                                        layout=layout))
    got = tatt.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        layout=layout).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_biased_attention_matches_reference(causal):
    """An additive bias broadcast to [b, h, Lq, Lk] (BERT's padding mask)
    against the reference's `xla_attention` and its dispatch (blockwise
    off the TPU); the port takes it in either layout."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 3, 24, 16).astype(np.float32) for _ in range(3))
    keep = np.ones((2, 24), np.float32)
    keep[1, 17:] = 0.0
    bias = ((1.0 - keep)[:, None, None, :] * -1e9).astype(np.float32)
    ref = np.asarray(jatt.xla_attention(q, k, v, causal=causal, bias=bias))
    ref_dispatch = np.asarray(jatt.dot_product_attention(
        q, k, v, causal=causal, bias=bias))
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    got = tatt.dot_product_attention(tq, tk, tv, causal=causal, bias=tb)
    tr = lambda t: t.transpose(1, 2)
    got_blhd = tatt.xla_attention(tr(tq), tr(tk), tr(tv), causal=causal,
                                  bias=tb, layout="blhd")
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref_dispatch, atol=TOL, rtol=0)
    np.testing.assert_allclose(tr(got_blhd).numpy(), ref, atol=TOL, rtol=0)
