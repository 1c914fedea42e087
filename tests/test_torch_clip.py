"""The port's gradient clipping (paddle_tpu_torch.nn.clip) against the
reference's (paddle_tpu.nn.clip): the three clip classes and the raw
global-norm form, in f32 and bf16, `need_clip` honoured; in bf16 the
scaled and re-rounded gradients are bitwise equal. The global norm's
plain version against the reference's arithmetic, and on a card
(marked `cuda`) the sum-of-squares kernel and the clip folded into the
multi-tensor Adam kernel against their plain versions."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import wrap_raw
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops import fused
import torch_threads  # noqa: F401  (one torch thread a worker)

SIZES = (1, 7, 300, 4096, 5000)
# f32: the squares are summed in another order (XLA's against torch's),
# so the norm and the scale may differ in the last bits
F32_RTOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _grads(seed, scale=3.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * scale).astype(np.float32) for n in SIZES]


def _pairs(arrays, dtype, need_clip=None):
    """The same gradients as reference and port (params, grads) pairs."""
    jd, td = DTYPES[dtype]
    flags = need_clip or [True] * len(arrays)
    ref, port = [], []
    for a, c in zip(arrays, flags):
        ref.append((types.SimpleNamespace(need_clip=c),
                    wrap_raw(jnp.asarray(a).astype(jd))))
        p = torch.nn.Parameter(torch.zeros(a.shape))
        p.need_clip = c
        port.append((p, torch.from_numpy(a).to(td)))
    return ref, port


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(getattr(t, "_value", t), np.float32)


def _assert_same(got, want, dtype, exact=False):
    for g, w in zip(got, want):
        if dtype == "bfloat16" or exact:
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=F32_RTOL, atol=0)


def _clip_classes():
    return {"value": (jclip.ClipGradByValue(0.5, -0.25),
                      tclip.ClipGradByValue(0.5, -0.25)),
            "norm": (jclip.ClipGradByNorm(5.0), tclip.ClipGradByNorm(5.0)),
            "global_norm": (jclip.ClipGradByGlobalNorm(1.0),
                            tclip.ClipGradByGlobalNorm(1.0))}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_clip_matches_the_reference(kind, dtype):
    ref_clip, port_clip = _clip_classes()[kind]
    ref, port = _pairs(_grads(1), dtype)
    want = [g for _, g in ref_clip(ref)]
    got = [g for _, g in port_clip(port)]
    assert all(g.dtype == DTYPES[dtype][1] for g in got)
    _assert_same(got, want, dtype, exact=kind == "value")
    # the clip did something: no gradient came out unchanged
    assert all(not np.array_equal(_np(g), _np(p[1]))
               for g, p in zip(got, port) if g.numel() > 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_need_clip_false_is_left_out(kind, dtype):
    ref_clip, port_clip = _clip_classes()[kind]
    flags = [True, False, True, False, True]
    ref, port = _pairs(_grads(2), dtype, flags)
    port.append((torch.nn.Parameter(torch.zeros(3)), None))
    ref.append((types.SimpleNamespace(need_clip=True), None))
    want = ref_clip(ref)
    got = port_clip(port)
    assert got[-1][1] is None and want[-1][1] is None
    _assert_same([g for _, g in got[:-1]], [g for _, g in want[:-1]], dtype,
                 exact=kind == "value")
    for (p, g), (_, g0) in zip(got, port):
        if g is not None and not p.need_clip:
            assert g is g0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_raw_global_norm_matches_the_reference(dtype):
    jd, td = DTYPES[dtype]
    arrays = _grads(3)
    names = [f"g{i}" for i in range(len(arrays))]
    want = jclip.clip_grads_global_norm_raw(
        {n: jnp.asarray(a).astype(jd) for n, a in zip(names, arrays)}, 2.0)
    got = tclip.clip_grads_global_norm_raw(
        {n: torch.from_numpy(a).to(td) for n, a in zip(names, arrays)}, 2.0)
    assert list(got) == names
    _assert_same([got[n] for n in names], [want[n] for n in names], dtype)
    as_list = tclip.clip_grads_global_norm_raw(
        [torch.from_numpy(a).to(td) for a in arrays], 2.0)
    _assert_same(as_list, [got[n] for n in names], dtype, exact=True)


def test_global_norm_within_the_clip_leaves_gradients_as_they_are():
    arrays = _grads(4, scale=1e-3)
    ref, port = _pairs(arrays, "float32")
    got = tclip.ClipGradByGlobalNorm(10.0)(port)
    _assert_same([g for _, g in got], [g for _, g in port], "float32",
                 exact=True)


def test_global_norm_plain_version_is_the_references_arithmetic():
    arrays = _grads(5)
    grads = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    norm, scale = fused._global_norm_reference(grads, 1.5)
    sq = sum(jnp.sum(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32) ** 2) for a in arrays)
    want = float(jnp.sqrt(sq))
    assert float(norm) == pytest.approx(want, rel=F32_RTOL)
    assert float(scale) == pytest.approx(1.5 / want, rel=F32_RTOL)
    # need_clip leaves a gradient out of the sum; the CPU path of
    # grad_global_norm is the plain version, launching nothing
    before = fused.grad_global_norm.launches
    part = fused.grad_global_norm(grads, 1.5, [True, False, True, True,
                                               True])
    assert fused.grad_global_norm.launches == before
    left = torch.cat([g.float() for i, g in enumerate(grads) if i != 1])
    assert float(part[0]) == pytest.approx(float(left.square().sum().sqrt()),
                                           rel=F32_RTOL)
    # within the clip the scale is exactly 1
    assert float(fused.grad_global_norm(grads, 1e6)[1]) == 1.0


def test_sparse_gradients_and_other_devices_raise():
    """Row-sparse gradients are clipped since (as the reference's
    `RowSparseGrad`s, merged first: the dense clip of the same gradient);
    a gradient on a device with no kernel and no plain version still
    raises."""
    from paddle_tpu.core.selected_rows import RowSparseGrad as JRows
    from paddle_tpu_torch.core.selected_rows import RowSparseGrad

    rows = np.array([1, 3, 1], np.int64)
    vals = np.random.RandomState(2).randn(3, 2).astype(np.float32) * 3
    p = torch.nn.Parameter(torch.zeros(4, 2))
    g = torch.sparse_coo_tensor(torch.from_numpy(rows)[None],
                                torch.from_numpy(vals), (4, 2))
    jp = types.SimpleNamespace(need_clip=True)
    jg = JRows(jnp.asarray(rows, jnp.int32), jnp.asarray(vals), 4)
    for name, clip in _clip_classes().items():
        (_, got), = clip[1]([(p, g)])
        (_, want), = clip[0]([(jp, jg)])
        assert isinstance(got, RowSparseGrad) == isinstance(want, JRows)
        got = got.to_dense() if isinstance(got, RowSparseGrad) else got
        want = want.to_dense() if isinstance(want, JRows) else want._value
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.grad_global_norm([torch.empty(4, device="meta")], 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_grads(dev, dtype, sizes=(1, 1000, 65536, 300001, 1024 * 1024)):
    gen = torch.Generator(device=dev).manual_seed(0)
    return [torch.randn(n, device=dev, generator=gen).to(dtype)
            for n in sizes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_global_norm_matches_plain_and_repeats_its_bits(cuda_device,
                                                             dtype):
    grads = _card_grads(cuda_device, dtype)
    # a misaligned view takes the kernel's scalar loads
    grads.append(torch.randn(4097, device=cuda_device).to(dtype)[1:])
    flags = [True, True, False, True, True, True]
    before = fused.grad_global_norm.launches
    got = fused.grad_global_norm(grads, 1.0, flags)
    again = fused.grad_global_norm(grads, 1.0, flags)
    assert fused.grad_global_norm.launches == before + 4
    want = fused._global_norm_reference(grads, 1.0, flags)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("master", [True, False])
def test_cuda_adam_with_the_clip_matches_plain(cuda_device, master):
    low = torch.bfloat16 if master else torch.float32
    f32 = _card_grads(cuda_device, torch.float32)
    l2 = [0.0, 0.01, 0.0, 0.1, 0.01]
    flags = [True, True, False, True, True]

    def state():
        return dict(P=[p.to(low, copy=True) for p in f32],
                    M=[torch.zeros_like(p) for p in f32],
                    V=[torch.zeros_like(p) for p in f32],
                    P1=[torch.ones((), device=cuda_device) for _ in f32],
                    P2=[torch.ones((), device=cuda_device) for _ in f32],
                    MS=[p.clone() for p in f32] if master else None)

    got, want = state(), state()
    lr = torch.full((), 1e-3, device=cuda_device)
    for step in range(3):
        grads = [g * 3 for g in _card_grads(cuda_device, low)]
        before = (fused.fused_adam_step.launches,
                  fused.grad_global_norm.launches)
        norm = fused.fused_adam_step(
            got["P"], grads, got["M"], got["V"], got["P1"], got["P2"], lr,
            masters=got["MS"], weight_decay=l2, clip_norm=1.0,
            need_clip=flags)
        assert (fused.fused_adam_step.launches,
                fused.grad_global_norm.launches) == (before[0] + 2,
                                                     before[1] + 2)
        ref = fused._global_norm_reference(grads, 1.0, flags)
        fused._adam_reference(want["P"], grads, want["M"], want["V"],
                              want["P1"], want["P2"], lr,
                              masters=want["MS"], weight_decay=l2,
                              grad_scale=norm[1], need_clip=flags)
        torch.cuda.synchronize()
        torch.testing.assert_close(norm, ref, rtol=1e-5, atol=0)
        assert float(norm[1]) < 1.0  # it clips
    for key in ("P", "M", "V", "P1", "P2", "MS"):
        for a, b in zip(got[key] or [], want[key] or []):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
