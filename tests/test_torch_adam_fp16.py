"""The Adam kernel's fp16 instance and per-tensor learning-rate scale
(#7, `csrc/adam.cu` through `ops.fused`): on the card against the plain
version (fp16 gradients and resident copies over f32 masters, scales,
the clip's fp16 sum of squares, the check pass); here, the device table
that carries the scale column and the routing rules that need no card."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build, flash_tpu, fused
import torch_threads  # noqa: F401  (one torch thread a worker)

ADAM_TOL = dict(rtol=0, atol=1e-6)  # the same IEEE f32 ops in one order


def test_table_holds_the_scale_and_a_new_scale_makes_a_new_table():
    """Column 11 holds each tensor's f32 scale bits, the dtype column the
    fp16 code; the table cache keys on the rows, so a changed scale
    builds a new table instead of reusing a stale one."""
    p = [torch.zeros(5, dtype=torch.float16), torch.zeros(3)]
    g = [torch.zeros(5, dtype=torch.float16), torch.zeros(3)]
    st = lambda n: torch.zeros(n)  # noqa: E731
    args = (p, g, [st(5), st(3)], [st(5), st(3)],
            [torch.ones(()), torch.ones(())],
            [torch.ones(()), torch.ones(())], [torch.zeros(5), None],
            [0.0, 0.0], [0.0, 0.0], [False, False])
    t1, _ = fused._adam_table(*args, [0.5, 1.0])
    t2, _ = fused._adam_table(*args, [0.25, 1.0])
    assert t1.tab.shape == (2, fused._TABLE_COLS) == (2, 12)
    bits = lambda x: int(np.float32(x).view(np.int32))  # noqa: E731
    assert t1.tab[:, 11].tolist() == [bits(0.5), bits(1.0)]
    assert t2.tab[:, 11].tolist() == [bits(0.25), bits(1.0)]
    assert t1.tab[:, 7].tolist() == [_build.DTYPE_CODES[torch.float16], 0]
    assert t1.tab.data_ptr() != t2.tab.data_ptr()


def test_fp16_rules_of_the_table():
    """An fp16 param with an f32 master is taken as a bf16 one is; an
    fp16 param without one and a sparse gradient are still refused; the
    LayerNorm and attention kernels take fp16 (their fp16 instances)."""
    st = [torch.zeros(4)], [torch.zeros(4)], [torch.ones(())], \
        [torch.ones(())]
    p16 = [torch.zeros(4, dtype=torch.float16)]
    g16 = [torch.zeros(4, dtype=torch.float16)]
    fused._adam_table(p16, g16, *st, [torch.zeros(4)], [0.0], [0.0],
                      [False], [1.0])
    with pytest.raises(NotImplementedError, match="f32 master"):
        fused._adam_table(p16, g16, *st, [None], [0.0], [0.0], [False],
                          [1.0])
    with pytest.raises(NotImplementedError, match="row path"):
        fused._check_grad("fused_adam_step", 0,
                          torch.zeros(4, 2).to_sparse(), torch.device("cpu"))
    assert torch.float16 in _build.ACT_DTYPES
    q = torch.zeros(1, 16, 2, 64, dtype=torch.float16, device="meta")
    # past every dtype, shape and stride rule: only the meta device is
    # refused
    with pytest.raises(ValueError, match="unsupported device meta"):
        flash_tpu._check_cuda_args("flash_attention", q, q, q)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(dev, numels, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    masters = [torch.randn(n, device=dev, generator=gen) for n in numels]
    return dict(P=[m.half() for m in masters],
                M=[torch.zeros(n, device=dev) for n in numels],
                V=[torch.zeros(n, device=dev) for n in numels],
                P1=[torch.ones((), device=dev) for _ in numels],
                P2=[torch.ones((), device=dev) for _ in numels],
                MS=masters), [(torch.randn(n, device=dev, generator=gen)
                               * 0.1).half() for n in numels]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [None, 1.0])
def test_cuda_fp16_adam_with_lr_scales_matches_plain(cuda_device, clip):
    numels = (1, 1000, 65536, 300001)
    scales, decay = [1.0, 0.5, 0.0, 2.0], [0.0, 0.01, 0.01, 0.0]
    got, grads = _state(cuda_device, numels, 0)
    want = {k: [t.clone() for t in v] for k, v in got.items()}
    lr = torch.full((), 1e-3, device=cuda_device)
    keys = ("M", "V", "P1", "P2")
    before = fused.fused_adam_step.launches
    for _ in range(3):
        norm = fused.fused_adam_step(
            got["P"], grads, *[got[k] for k in keys], lr, masters=got["MS"],
            decoupled_decay=decay, lr_scale=scales, clip_norm=clip)
        fused._adam_reference(
            want["P"], grads, *[want[k] for k in keys], lr,
            masters=want["MS"], decoupled_decay=decay, lr_scale=scales,
            grad_scale=None if norm is None else norm[1])
    torch.cuda.synchronize()
    assert fused.fused_adam_step.launches == before + 6
    for k in ("P", "MS", "M", "V", "P1", "P2"):
        for a, b in zip(got[k], want[k]):
            torch.testing.assert_close(a.float(), b.float(), **ADAM_TOL)
    for p, m in zip(got["P"], got["MS"]):
        assert torch.equal(p, m.half())
    if clip is not None:
        torch.testing.assert_close(
            norm, fused._global_norm_reference(grads, clip), rtol=1e-5,
            atol=0)


@pytest.mark.cuda
def test_cuda_fp16_check_pass_flags_an_overflowing_copy(cuda_device):
    p = [torch.tensor([65504.0, 1.0], device=cuda_device).half()]
    ms = [torch.tensor([65519.0, 1.0], device=cuda_device)]
    g = [torch.tensor([-1.0, 0.5], device=cuda_device).half()]
    z = lambda: [torch.zeros(2, device=cuda_device)]  # noqa: E731
    o = lambda: [torch.ones((), device=cuda_device)]  # noqa: E731
    lr = torch.full((), 100.0, device=cuda_device)
    flags, ok = fused.adam_finite_check(p, g, z(), z(), o(), o(), lr,
                                        masters=ms)
    want = fused._adam_check_reference(p, g, z(), z(), o(), o(), lr,
                                       masters=ms)
    assert torch.equal(flags.cpu(), want.cpu()) and int(ok) == 0
