"""The port's detection operators (`paddle_tpu_torch.vision.ops`) against
the reference's (`paddle_tpu.vision.ops`) on the same seeded numpy inputs,
f32, on the CPU: values and, where the reference differentiates, the
gradients of the chosen inputs for one cotangent. `multiclass_nms` is
held to the reference's bits (keep masks, padded blocks, counts and
indices) on inputs with tied scores and IoUs exactly at the threshold,
with `nms_eta < 1`, and to a numpy greedy NMS."""
import math
from functools import partial

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import wrap_raw
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch.vision import ops as TV
from torch_parity import assert_close, port_call, ref_jit_call
import torch_threads  # noqa: F401  (one torch thread a worker)

# f32: the same formulas; sums of the gathers and contractions run in
# another order
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _boxes(r, n, m, scale=10.0):
    xy = r.rand(n, m, 2) * scale
    wh = r.rand(n, m, 2) * scale * 0.4 + 1.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _rois(r, count, hw):
    h, w = hw
    x1 = r.rand(count) * (w - 2)
    y1 = r.rand(count) * (h - 2)
    x2 = x1 + r.rand(count) * (w - x1) + 0.5
    y2 = y1 + r.rand(count) * (h - y1) + 0.5
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


def _dcn(r, mask, groups=1, dg=1, stride=1, pad=1, dil=1):
    n, cin, h, w, cout, k = 2, 4, 6, 7, 6, 3
    ho = (h + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    wo = (w + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    args = [r.randn(n, cin, h, w).astype(np.float32),
            (r.randn(n, dg * 2 * k * k, ho, wo) * 1.5).astype(np.float32),
            r.randn(cout, cin // groups, k, k).astype(np.float32),
            r.randn(cout).astype(np.float32)]
    kw = dict(stride=stride, padding=pad, dilation=dil,
              deformable_groups=dg, groups=groups)
    if mask:
        args.append(r.rand(n, dg * k * k, ho, wo).astype(np.float32))
    return args, kw


def _dcn_call(mod):
    def f(x, off, w, b, *m):
        return mod.deform_conv2d(x, off, w, bias=b, mask=m[0] if m else None,
                                 **_DCN_KW)
    return f


_DCN_KW = {}

# name -> (function name, inputs from a RandomState, kwargs, grad positions)
CASES = {
    "prior_box_max_flip_clip": ("prior_box", lambda r: (
        np.zeros((1, 2, 3, 4), np.float32),
        np.zeros((1, 3, 30, 40), np.float32)),
        dict(min_sizes=[8.0, 12.0], max_sizes=[16.0, 20.0],
             aspect_ratios=[2.0, 3.0], flip=True, clip=True), ()),
    "prior_box_order_steps": ("prior_box", lambda r: (
        np.zeros((1, 2, 5, 5), np.float32),
        np.zeros((1, 3, 50, 50), np.float32)),
        dict(min_sizes=[10.0], max_sizes=[20.0], aspect_ratios=[2.0],
             steps=(8.0, 9.0), offset=0.25,
             min_max_aspect_ratios_order=True), ()),
    "box_coder_encode_var_tensor": ("box_coder", lambda r: (
        _boxes(r, 1, 5)[0], r.rand(5, 4).astype(np.float32) + 0.1,
        _boxes(r, 1, 3)[0]), dict(code_type="encode_center_size"), (0, 2)),
    "box_coder_encode_unnormalized": ("box_coder", lambda r: (
        _boxes(r, 1, 5)[0], None, _boxes(r, 1, 3)[0]),
        dict(code_type="encode_center_size", box_normalized=False), (0, 2)),
    "box_coder_decode_list_axis0": ("box_coder", lambda r: (
        _boxes(r, 1, 5)[0], [0.1, 0.1, 0.2, 0.2],
        r.randn(3, 5, 4).astype(np.float32) * 0.5),
        dict(code_type="decode_center_size", axis=0), (0, 2)),
    "box_coder_decode_tensor_axis1": ("box_coder", lambda r: (
        _boxes(r, 1, 3)[0], r.rand(3, 4).astype(np.float32) + 0.1,
        r.randn(3, 5, 4).astype(np.float32) * 0.5),
        dict(code_type="decode_center_size", axis=1,
             box_normalized=False), (0, 2)),
    "iou_similarity": ("iou_similarity", lambda r: (
        _boxes(r, 1, 6)[0], _boxes(r, 1, 4)[0]), {}, (0, 1)),
    "iou_similarity_unnormalized": ("iou_similarity", lambda r: (
        _boxes(r, 1, 6)[0], _boxes(r, 1, 4)[0]),
        dict(box_normalized=False), (0, 1)),
    "roi_align_aligned": ("roi_align", lambda r: (
        r.randn(2, 3, 8, 9).astype(np.float32),
        _rois(r, 5, (16, 18))),
        dict(output_size=(3, 2), spatial_scale=0.5, sampling_ratio=2,
             boxes_num=np.array([2, 3], np.int32)),
        (0, 1)),
    "roi_align_unaligned_fixed_grid": ("roi_align", lambda r: (
        r.randn(2, 3, 8, 9).astype(np.float32),
        _rois(r, 4, (9, 10)) - 1.5),
        dict(output_size=2, sampling_ratio=-1, aligned=False,
             boxes_num=np.array([3, 1], np.int32)), (0, 1)),
    "roi_align_one_image": ("roi_align", lambda r: (
        r.randn(1, 2, 6, 6).astype(np.float32), _rois(r, 3, (7, 7))),
        dict(output_size=3, sampling_ratio=3), (0,)),
    "psroi_pool": ("psroi_pool", lambda r: (
        r.randn(2, 2 * 3 * 3, 8, 9).astype(np.float32),
        _rois(r, 4, (14, 16)), np.array([1, 3], np.int32)),
        dict(output_size=3, spatial_scale=0.5), (0,)),
    "spp_max": ("spp", lambda r: (r.randn(2, 3, 9, 8).astype(np.float32),),
                dict(pyramid_height=3, pooling_type="max"), (0,)),
    "spp_avg": ("spp", lambda r: (r.randn(2, 3, 8, 8).astype(np.float32),),
                dict(pyramid_height=2, pooling_type="avg"), (0,)),
    "space_to_depth_stem_conv": ("space_to_depth_stem_conv", lambda r: (
        r.randn(2, 3, 10, 12).astype(np.float32),
        r.randn(5, 3, 7, 7).astype(np.float32)), {}, (0, 1)),
}

DCN_CASES = {
    "v1": dict(mask=False),
    "v2_groups_stride": dict(mask=True, groups=2, stride=2, pad=1),
    "v2_deformable_groups_dilation": dict(mask=True, dg=2, dil=2, pad=2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_reference(name):
    fn, build, kw, grad = CASES[name]
    args = build(np.random.RandomState(0))
    want = ref_jit_call(getattr(JV, fn), args, kw, grad)
    got = port_call(getattr(TV, fn), args, kw, grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name + " grads", **GRAD_TOL)


@pytest.mark.parametrize("name", sorted(DCN_CASES))
def test_deform_conv2d_matches_the_reference(name):
    spec = dict(DCN_CASES[name])
    args, kw = _dcn(np.random.RandomState(1), **spec)
    _DCN_KW.clear()
    _DCN_KW.update(kw)
    grad = tuple(range(len(args)))
    want = ref_jit_call(_dcn_call(JV), args, {}, grad)
    got = port_call(_dcn_call(TV), args, {}, grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name + " grads", **GRAD_TOL)


def test_deform_conv2d_zero_offset_is_conv():
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randn(2, 4, 6, 6).astype(np.float32))
    w = torch.from_numpy(r.randn(5, 4, 3, 3).astype(np.float32))
    off = torch.zeros(2, 18, 6, 6)
    got = TV.deform_conv2d(x, off, w, padding=1)
    want = torch.nn.functional.conv2d(x, w, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_yolo_box_matches_the_reference():
    r = np.random.RandomState(3)
    an, cls = 3, 4
    x = r.randn(2, an * (5 + cls), 4, 5).astype(np.float32)
    img = np.array([[64, 80], [50, 70]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23]
    for clip, conf, scale in ((True, 0.5, 1.0), (False, 0.3, 1.2)):
        kw = dict(anchors=anchors, class_num=cls, conf_thresh=conf,
                  downsample_ratio=16, clip_bbox=clip, scale_x_y=scale)
        jb, js = JV.yolo_box(paddle.to_tensor(x), paddle.to_tensor(img),
                             **kw)
        tb, ts = TV.yolo_box(torch.from_numpy(x), torch.from_numpy(img),
                             **kw)
        assert_close([tb.numpy(), ts.numpy()], [jb.numpy(), js.numpy()],
                     what=f"yolo_box clip={clip}", **VALUE_TOL)
        assert (ts.numpy() == 0).any()  # rows below conf_thresh are zeros


# -- multiclass_nms -------------------------------------------------------------
def _tied_inputs(r, n=2, m=14, c=4):
    """Integer boxes on a small grid (exact IoUs: many exactly 0.5 or
    1/3) and scores drawn from a few values (ties)."""
    xy = r.randint(0, 4, size=(n, m, 2)).astype(np.float32)
    wh = r.randint(1, 3, size=(n, m, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = r.choice([0.2, 0.4, 0.5, 0.7, 0.9], size=(n, c, m)).astype(
        np.float32)
    return boxes, scores


NMS_CASES = {
    "ties_at_half": dict(score_threshold=0.3, nms_top_k=10, keep_top_k=12,
                         nms_threshold=0.5, background_label=0),
    "ties_at_third_no_background": dict(
        score_threshold=0.1, nms_top_k=14, keep_top_k=20,
        nms_threshold=1.0 / 3.0, background_label=-1),
    "eta": dict(score_threshold=0.1, nms_top_k=12, keep_top_k=30,
                nms_threshold=0.9, nms_eta=0.7, background_label=1),
    "unnormalized_keep_all": dict(score_threshold=0.3, nms_top_k=6,
                                  keep_top_k=-1, nms_threshold=0.5,
                                  normalized=False, background_label=0),
}


def _ref_nms(boxes, scores, kw):
    """The reference's block, counts, indices and per-class keep masks
    and candidate orders [N, C, K], each from one compiled call."""
    def block(b, s):
        out = JV.multiclass_nms(wrap_raw(b), wrap_raw(s), return_index=True,
                                **kw)
        return tuple(o._value for o in out)

    k = min(kw["nms_top_k"], boxes.shape[1])
    per_class = partial(JV._nms_class, score_threshold=kw["score_threshold"],
                        nms_top_k=k, nms_threshold=kw["nms_threshold"],
                        nms_eta=kw.get("nms_eta", 1.0),
                        normalized=kw.get("normalized", True))
    keeps = jax.vmap(jax.vmap(per_class, in_axes=(None, 0)))
    return [np.asarray(a) for a in jax.jit(block)(boxes, scores)
            + jax.jit(keeps)(boxes, scores)]


@pytest.mark.parametrize("name", sorted(NMS_CASES))
def test_multiclass_nms_same_bits_as_the_reference(name):
    kw = NMS_CASES[name]
    boxes, scores = _tied_inputs(np.random.RandomState(4))
    jo, jc, ji, jkeep, _, jorder = _ref_nms(boxes, scores, kw)
    to, tc, ti = TV.multiclass_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   return_index=True, **kw)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert tc.dtype == torch.int32
    # the candidates' order and the greedy keep masks of every class
    k = jorder.shape[-1]
    s = torch.from_numpy(scores)
    order = torch.sort(-s, dim=-1, stable=True).indices[..., :k]
    np.testing.assert_array_equal(order.numpy(), jorder)
    b = torch.from_numpy(boxes)[:, None].expand(-1, s.shape[1], -1, -1)
    b = torch.gather(b, 2, order[..., None].expand(*order.shape, 4))
    tkeep = TV._greedy_keep(
        TV._iou_matrix(b, b, kw.get("normalized", True)),
        torch.gather(s, 2, order) > kw["score_threshold"],
        kw["nms_threshold"], kw.get("nms_eta", 1.0))
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    assert 0 < int(tkeep.sum()) < tkeep.numel()


def _np_iou(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def test_multiclass_nms_matches_numpy_greedy():
    r = np.random.RandomState(0)
    n, m, c = 2, 12, 3
    boxes = _boxes(r, n, m)
    scores = r.rand(n, c, m).astype(np.float32)
    out, counts = TV.multiclass_nms(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.3, 10, 8,
                                    nms_threshold=0.4, background_label=0)
    for i in range(n):
        expected = []
        for cls in range(1, c):
            kept = []
            for j in np.argsort(-scores[i, cls], kind="stable")[:10]:
                if scores[i, cls, j] > 0.3 and all(
                        _np_iou(boxes[i, j], boxes[i, q]) <= 0.4
                        for q in kept):
                    kept.append(j)
            expected += [(cls, scores[i, cls, q], q) for q in kept]
        expected = sorted(expected, key=lambda t: -t[1])[:8]
        assert int(counts[i]) == len(expected)
        for row, (cls, sc, q) in enumerate(expected):
            assert out[i, row, 0] == cls and out[i, row, 1] == sc
            np.testing.assert_array_equal(out[i, row, 2:].numpy(),
                                          boxes[i, q])
        assert (out[i, len(expected):, 0] == -1).all()


def test_multiclass_nms_edge_cases():
    boxes = torch.tensor([[[0, 0, 1, 1.0]]])
    out, counts = TV.multiclass_nms(boxes, torch.tensor([[[0.1]]]), 0.5, 1,
                                    1, background_label=-1)
    assert int(counts[0]) == 0 and float(out[0, 0, 0]) == -1
    boxes = torch.tensor([[[0, 0, 1, 1.0], [5, 5, 6, 6]]])
    out, counts = TV.multiclass_nms(boxes, torch.tensor([[[0.9, 0.8]]]),
                                    0.1, 2, -1, background_label=-1)
    assert out.shape[1] == 2 and int(counts[0]) == 2


def test_roi_align_needs_boxes_num_for_two_images():
    with pytest.raises(ValueError, match="boxes_num"):
        TV.roi_align(torch.zeros(2, 1, 4, 4), torch.tensor([[0, 0, 3, 3.0]]),
                     output_size=2)


def test_space_to_depth_stem_is_the_strided_conv():
    r = np.random.RandomState(5)
    x = torch.from_numpy(r.randn(2, 3, 16, 16).astype(np.float32))
    w = torch.from_numpy(r.randn(8, 3, 7, 7).astype(np.float32))
    want = torch.nn.functional.conv2d(x, w, stride=2, padding=3)
    torch.testing.assert_close(TV.space_to_depth_stem_conv(x, w), want,
                               rtol=1e-5, atol=1e-4)


def test_every_reference_name_resolves():
    assert sorted(TV.__all__) == sorted(JV.__all__)
    for name in JV.__all__:
        assert callable(getattr(TV, name))
    assert TV.box_iou is TV.iou_similarity
    assert math.isclose(float(TV.iou_similarity(
        torch.tensor([[0, 0, 2, 2.0]]), torch.tensor([[0, 0, 2, 1.0]]))), 0.5)
