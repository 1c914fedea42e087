"""Detection serving pieces of the port against the reference's, on the
CPU: `metric.DetectionMAP` (the reference's four cases, both AP types,
difficult flags, padding rows, tensors as input), `static.nn.
multi_box_head` and `static.nn.deform_conv2d` recorded in both packages
and replayed by each Executor with the same parameters, the image
backend (`vision.image`), and the SSD post-processing chain — priors →
`box_coder` decode → softmax → `multiclass_nms` → mAP — on the same head
outputs through both packages."""
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import static as jstatic
from paddle_tpu.core.tensor import wrap_raw
from paddle_tpu.metric import DetectionMAP as JMAP
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch import static
from paddle_tpu_torch.metric import DetectionMAP
from paddle_tpu_torch.vision import image as timage
from paddle_tpu_torch.vision import ops as TV
import torch_threads  # noqa: F401  (one torch thread a worker)

# f32 priors and decoded boxes: the same formulas, one rounding apart
BOX_TOL = dict(rtol=1e-5, atol=1e-5)
# the conv heads: the same convolution in another summation order
HEAD_TOL = dict(rtol=1e-4, atol=1e-4)


# -- DetectionMAP ---------------------------------------------------------------
def _map(dets, gts, **kw):
    m = DetectionMAP(**kw)
    for d, g in zip(dets, gts):
        m.update(np.asarray(d, np.float32), np.asarray(g, np.float32))
    return m.accumulate()


def test_detection_map_cases():
    gts = [[[1, 0, 0, 10, 10], [2, 20, 20, 30, 30]]]
    perfect = [[[1, 0.9, 0, 0, 10, 10], [2, 0.8, 20, 20, 30, 30]]]
    assert _map(perfect, gts) == pytest.approx(1.0)
    half = [[[1, 0.9, 0, 0, 10, 10]]]
    assert _map(half, gts) == pytest.approx(0.5)
    # a false positive ranked above the hit halves class 1's precision
    fp_first = [[[1, 0.95, 50, 50, 60, 60], [1, 0.9, 0, 0, 10, 10],
                 [2, 0.8, 20, 20, 30, 30]]]
    assert _map(fp_first, gts) == pytest.approx((0.5 + 1.0) / 2)
    # padding rows (label -1) are ignored
    padded = [perfect[0] + [[-1, 0, 0, 0, 0, 0]] * 3]
    assert _map(padded, gts) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="ap_type"):
        DetectionMAP(ap_type="bad")


def _random_eval(r, n_img=5, classes=4):
    dets, gts = [], []
    for _ in range(n_img):
        g = r.randint(1, 5)
        xy = r.rand(g, 2) * 50
        boxes = np.concatenate([xy, xy + r.rand(g, 2) * 30 + 5], 1)
        gt = np.concatenate([r.randint(0, classes, (g, 1)), boxes,
                             (r.rand(g, 1) < 0.3)], 1)
        jitter = boxes[r.randint(0, g, 6)] + r.randn(6, 4) * 3
        d = np.concatenate([r.randint(0, classes, (6, 1)), r.rand(6, 1),
                            jitter], 1)
        d = np.concatenate([d, -np.ones((2, 6))], 0)
        dets.append(d.astype(np.float32))
        gts.append(gt.astype(np.float32))
    return dets, gts


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [False, True])
def test_detection_map_matches_the_reference(ap_type, difficult):
    dets, gts = _random_eval(np.random.RandomState(0))
    kw = dict(overlap_threshold=0.3, ap_type=ap_type,
              evaluate_difficult=difficult)
    ref = JMAP(**kw)
    for d, g in zip(dets, gts):
        ref.update(d, g)
    got = DetectionMAP(**kw)
    for d, g in zip(dets, gts):  # tensors, as the card's NMS gives them
        got.update(torch.from_numpy(d), torch.from_numpy(g))
    assert 0.0 < got.accumulate() == ref.accumulate()
    assert got.name() == "detection_map"


# -- the image backend ------------------------------------------------------------
def test_image_backend(tmp_path, monkeypatch):
    from PIL import Image

    assert timage.get_image_backend() == "pil"
    with pytest.raises(ValueError):
        timage.set_image_backend("nope")
    arr = (np.random.RandomState(0).rand(6, 7, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "im.png")
    Image.fromarray(arr).save(p)
    assert timage.image_load(p).size == (7, 6)
    t = timage.image_load(p, backend="tensor")
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == (6, 7, 3)
    np.testing.assert_array_equal(t.numpy(), arr)
    np.testing.assert_array_equal(timage.image_load(p, backend="cv2"),
                                  arr[..., ::-1])
    try:
        timage.set_image_backend("cv2")
        assert timage.get_image_backend() == "cv2"
    finally:
        timage.set_image_backend("pil")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        timage.image_load(p)


# -- static.nn heads ------------------------------------------------------------------
SSD_HEAD = dict(base_size=60, num_classes=3, min_ratio=20, max_ratio=90,
                aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0]], offset=0.5,
                flip=True, clip=True)
MAPS = ([2, 4, 6, 6], [2, 6, 3, 3], [2, 5, 2, 2])


def _record_both(build, feed_shapes):
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jouts = build(jstatic, lambda n, s: jstatic.data(n, s, "float32"))
    main = static.Program()
    with static.program_guard(main):
        outs = build(static, lambda n, s: static.data(n, s, "float32",
                                                      device="cpu"))
    assert len(main.all_parameters()) == len(jmain.all_parameters())
    with torch.no_grad():
        for tp_, jp in zip(main.all_parameters(), jmain.all_parameters()):
            tp_.copy_(torch.from_numpy(np.array(jp._value)))
    r = np.random.RandomState(1)
    feed = {n: r.randn(*s).astype(np.float32) for n, s in feed_shapes}
    got = static.Executor(static.CPUPlace()).run(main, feed=feed,
                                                  fetch_list=outs)
    want = jstatic.Executor().run(jmain, feed=feed, fetch_list=jouts)
    return [np.asarray(g) for g in got], [np.asarray(w) for w in want]


def test_static_heads_match_the_reference():
    """``multi_box_head`` over three maps and ``deform_conv2d`` (DCNv2)
    recorded in one Program in each package."""
    shapes = [(f"f{i}", s) for i, s in enumerate(MAPS)]
    shapes += [("image", [2, 3, 60, 60]), ("x", [2, 4, 5, 6]),
               ("off", [2, 18, 5, 6]), ("mask", [2, 9, 5, 6])]

    def build(st, data):
        v = {n: data(n, s) for n, s in shapes}
        head = st.nn.multi_box_head([v[f"f{i}"] for i in range(3)],
                                    v["image"], **SSD_HEAD)
        return list(head) + [st.nn.deform_conv2d(
            v["x"], v["off"], v["mask"], 6, 3, padding=1)]

    got, want = _record_both(build, shapes)
    # 4 priors a cell on the first map, 6 on the others
    n_priors = 36 * 4 + 9 * 6 + 4 * 6
    assert got[0].shape == (2, n_priors, 4)
    assert got[1].shape == (2, n_priors, 3)
    assert got[2].shape == got[3].shape == (n_priors, 4)
    assert got[4].shape == (2, 6, 5, 6)
    for g, w in zip(got[:2] + got[4:], want[:2] + want[4:]):
        np.testing.assert_allclose(g, w, **HEAD_TOL)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g, w, **BOX_TOL)


# -- the SSD post-processing chain -------------------------------------------------------
def _ssd_chain_ref(locs, confs, feats, image, gts):
    boxes, variances = [], []
    for f in feats:
        b, v = JV.prior_box(paddle.to_tensor(f), paddle.to_tensor(image),
                            min_sizes=[12.0], max_sizes=[24.0],
                            aspect_ratios=[2.0], flip=True, clip=True)
        boxes.append(b.numpy().reshape(-1, 4))
        variances.append(v.numpy().reshape(-1, 4))
    prior, var = np.concatenate(boxes), np.concatenate(variances)

    def chain(locs, confs):
        dec = JV.box_coder(wrap_raw(prior), wrap_raw(var), wrap_raw(locs),
                           code_type="decode_center_size")
        scores = JF.softmax(wrap_raw(confs), axis=-1).transpose([0, 2, 1])
        out, n = JV.multiclass_nms(dec, scores, **NMS)
        return dec._value, scores._value, out._value, n._value

    dec, scores, out, n = (np.array(a) for a in jax.jit(chain)(locs, confs))
    m = JMAP(ap_type="11point")
    for i in range(len(gts)):
        m.update(out[i], gts[i])
    return prior, dec, scores, out, n, m.accumulate()


NMS = dict(score_threshold=0.01, nms_top_k=40, keep_top_k=20,
           nms_threshold=0.45, background_label=0)


def test_ssd_post_processing_chain_matches_the_reference():
    r = np.random.RandomState(2)
    feats = [np.zeros((2, 1, 4, 4), np.float32),
             np.zeros((2, 1, 2, 2), np.float32)]
    image = np.zeros((2, 3, 64, 64), np.float32)
    p = (16 + 4) * 4  # priors: 4 a cell
    locs = (r.randn(2, p, 4) * 0.3).astype(np.float32)
    confs = (r.randn(2, p, 4) * 2).astype(np.float32)
    gts = [np.concatenate([r.randint(1, 4, (k, 1)),
                           np.sort(r.rand(k, 4), 1)[:, [0, 1, 2, 3]]], 1)
           .astype(np.float32) for k in (3, 5)]
    prior, dec, scores, out, n, mean_ap = _ssd_chain_ref(locs, confs, feats,
                                                         image, gts)
    # the port, end to end
    tb, tv = zip(*(TV.prior_box(torch.from_numpy(f), torch.from_numpy(image),
                                min_sizes=[12.0], max_sizes=[24.0],
                                aspect_ratios=[2.0], flip=True, clip=True)
                   for f in feats))
    tprior = torch.cat([b.reshape(-1, 4) for b in tb])
    tvar = torch.cat([v.reshape(-1, 4) for v in tv])
    np.testing.assert_allclose(tprior.numpy(), prior, **BOX_TOL)
    tdec = TV.box_coder(tprior, tvar, torch.from_numpy(locs),
                        code_type="decode_center_size")
    np.testing.assert_allclose(tdec.numpy(), dec, **BOX_TOL)
    tscores = torch.softmax(torch.from_numpy(confs), -1).transpose(1, 2)
    np.testing.assert_allclose(tscores.numpy(), scores, **BOX_TOL)
    tout, tn = TV.multiclass_nms(tdec, tscores, **NMS)
    m = DetectionMAP(ap_type="11point")
    for i in range(2):
        m.update(tout[i], torch.from_numpy(gts[i]))
    assert m.accumulate() == pytest.approx(mean_ap, abs=1e-6)
    # on the reference's decoded boxes and scores: the same bits
    tout, tn = TV.multiclass_nms(torch.from_numpy(dec),
                                 torch.from_numpy(scores), **NMS)
    np.testing.assert_array_equal(tout.numpy(), out)
    np.testing.assert_array_equal(tn.numpy(), n)
    assert (tn > 0).all()
