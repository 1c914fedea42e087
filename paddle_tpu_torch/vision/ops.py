"""Detection operators — counterpart of ``paddle_tpu.vision.ops``:
``yolo_box``, ``prior_box``, ``box_coder``, ``iou_similarity`` /
``box_iou``, ``multiclass_nms``, ``roi_align``, ``psroi_pool``,
``deform_conv2d``, ``spp`` and ``space_to_depth_stem_conv``.

The reference computes all of them at the XLA level (no Pallas kernel),
so the port is plain PyTorch on the tensors' device with the reference's
static-shape contracts and arithmetic:

- ``multiclass_nms`` returns a padded ``[N, keep_top_k, 6]`` block of
  rows (label, score, x1, y1, x2, y2), label -1 on padding, the per-image
  counts and, with ``return_index``, the candidates' box indices. Each
  class's candidates are its ``nms_top_k`` best scores in the order of a
  stable sort of ``-score`` (equal scores: lowest index first); the
  greedy pass is a loop of K batched steps over every image and class at
  once (step i keeps candidate i unless an already-kept one overlaps it
  by more than the current threshold, which ``nms_eta < 1`` shrinks after
  each kept candidate while it is above 0.5), so it reads nothing back to
  the host;
- ``roi_align`` with ``sampling_ratio=-1`` samples a fixed 2x2 grid a
  bin, zeroes samples outside ``[-1, H]`` x ``[-1, W]``, and needs
  ``boxes_num`` for a batch of more than one image;
- ``deform_conv2d`` samples bilinearly and zeroes each of the four
  corners that falls outside the image on its own (not torchvision's
  rule); its gradients in the input, offsets, mask and weight are
  autograd's of the gather form (a scatter-add on the card);
- ``yolo_box`` zeroes the boxes and scores of predictions whose
  objectness is below ``conf_thresh``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = [
    "yolo_box", "prior_box", "box_coder", "multiclass_nms", "roi_align",
    "iou_similarity", "box_iou", "psroi_pool", "deform_conv2d", "spp",
    "space_to_depth_stem_conv",
]


def _t(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x), device=dev)


def _const(values, device, dtype=torch.float32):
    """A small constant on ``device``. The copy is asynchronous: a
    pageable source is staged before the call returns, and nothing waits
    for the device (a plain ``torch.tensor(..., device=)`` synchronizes)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, np.integer)) else tuple(
        int(i) for i in v)


# ---------------------------------------------------------------------------
# yolo_box
# ---------------------------------------------------------------------------
def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode one YOLOv3 head: ``x`` [N, an*(5+class_num), H, W],
    ``img_size`` [N, 2] (h, w) → (boxes [N, an*H*W, 4] in x1y1x2y2 image
    coordinates, scores [N, an*H*W, class_num]); predictions whose
    objectness is below ``conf_thresh`` give zero boxes and scores."""
    x = _t(x)
    img = _t(img_size, x).detach()
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    an = anchors.shape[0]
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    n, _, h, w = x.shape
    xr = x.reshape(n, an, 5 + class_num, h, w)
    img_h = img[:, 0].float()[:, None, None, None]
    img_w = img[:, 1].float()[:, None, None, None]
    in_h = float(downsample_ratio * h)
    in_w = float(downsample_ratio * w)
    dev = x.device
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    aw = _const(anchors[:, 0], dev)[None, :, None, None]
    ah = _const(anchors[:, 1], dev)[None, :, None, None]

    cx = (gx + torch.sigmoid(xr[:, :, 0]) * scale + bias) * img_w / w
    cy = (gy + torch.sigmoid(xr[:, :, 1]) * scale + bias) * img_h / h
    bw = torch.exp(xr[:, :, 2]) * aw * img_w / in_w
    bh = torch.exp(xr[:, :, 3]) * ah * img_h / in_h
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1.0)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1.0)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1.0)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1.0)
    conf = torch.sigmoid(xr[:, :, 4])  # [n, an, h, w]
    keep = (conf >= conf_thresh).to(x.dtype)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    cls = torch.sigmoid(xr[:, :, 5:])  # [n, an, C, h, w]
    scores = cls * (conf * keep)[:, :, None]
    boxes = boxes.reshape(n, an * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, an * h * w, class_num)
    return boxes, scores


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------
def _expand_aspect_ratios(aspect_ratios, flip):
    """1.0 first, duplicates dropped, ``flip`` adds the reciprocals."""
    ars = [1.0]
    for ar in aspect_ratios:
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    return ars


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD priors of one feature map: (boxes [H, W, P, 4] normalized
    x1y1x2y2, variances [H, W, P, 4]) on ``input``'s device. Per cell and
    min size: the ratio-1 box, the other ratios' boxes, then the
    sqrt(min·max) box (second with ``min_max_aspect_ratios_order``)."""
    min_sizes = [float(s) for s in np.atleast_1d(min_sizes)]
    max_sizes = [float(s) for s in np.atleast_1d(max_sizes)] if max_sizes \
        else []
    ars = _expand_aspect_ratios(aspect_ratios, flip)
    h, w = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = float(image.shape[2]), float(image.shape[3])
    dev = input.device
    step_w = float(steps[0]) or img_w / w
    step_h = float(steps[1]) or img_h / h
    f32 = dict(dtype=torch.float32, device=dev)
    cx = (torch.arange(w, **f32) + offset) * step_w
    cy = (torch.arange(h, **f32) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # [h, w]
    whs = []
    for k, ms in enumerate(min_sizes):
        per = [(ms, ms) if abs(ar - 1.0) < 1e-6
               else (ms * math.sqrt(ar), ms / math.sqrt(ar)) for ar in ars]
        if max_sizes:
            s = math.sqrt(ms * max_sizes[k])
            per = ([per[0], (s, s)] + per[1:] if min_max_aspect_ratios_order
                   else per + [(s, s)])
        whs.extend(per)
    bw = _const([p[0] for p in whs], dev) / img_w / 2
    bh = _const([p[1] for p in whs], dev) / img_h / 2
    ncx = (cxg / img_w)[..., None]
    ncy = (cyg / img_h)[..., None]
    boxes = torch.stack([ncx - bw, ncy - bh, ncx + bw, ncy + bh], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = _const([float(v) for v in variance], dev).expand(
        boxes.shape).contiguous()
    return boxes, var


# ---------------------------------------------------------------------------
# box_coder
# ---------------------------------------------------------------------------
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    """Encode targets against priors (target [N, 4], prior [M, 4] →
    [N, M, 4]) or decode deltas with priors (target [N, M, 4], the prior
    broadcast on ``axis`` → [N, M, 4]). ``prior_box_var`` is None, a
    [M, 4] tensor or 4 floats; ``box_normalized=False`` adds 1 to widths
    and heights."""
    target = _t(target_box)
    prior = _t(prior_box, target)
    norm = 0.0 if box_normalized else 1.0
    if isinstance(prior_box_var, (list, tuple)):
        var = _const([float(v) for v in prior_box_var], target.device)
    else:
        var = None if prior_box_var is None else _t(prior_box_var, target)
    pw = prior[..., 2] - prior[..., 0] + norm
    ph = prior[..., 3] - prior[..., 1] + norm
    px = prior[..., 0] + pw / 2
    py = prior[..., 1] + ph / 2
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + norm
        th = target[:, 3] - target[:, 1] + norm
        tx = target[:, 0] + tw / 2
        ty = target[:, 1] + th / 2
        ox = (tx[:, None] - px[None, :]) / pw[None, :]
        oy = (ty[:, None] - py[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        oh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if var is not None:
            out = out / var.expand(out.shape)
        return out
    if code_type != "decode_center_size":
        raise ValueError(f"box_coder: unknown code_type {code_type!r}")
    # axis=0: a prior per column [1, M]; axis=1: a prior per row [N, 1]
    bc = (lambda a: a[None, :]) if axis == 0 else (lambda a: a[:, None])
    px, py, pw, ph = (bc(v) for v in (px, py, pw, ph))
    t = target
    if var is not None:
        t = t * (var[None, None, :] if var.dim() == 1 else bc(var))
    ox = pw * t[..., 0] + px
    oy = ph * t[..., 1] + py
    ow = torch.exp(t[..., 2]) * pw
    oh = torch.exp(t[..., 3]) * ph
    return torch.stack([ox - ow / 2, oy - oh / 2,
                        ox + ow / 2 - norm, oy + oh / 2 - norm], dim=-1)


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------
def _iou_matrix(a, b, normalized=True):
    """a [..., A, 4], b [..., B, 4] → [..., A, B]."""
    norm = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + norm).clamp(
        min=0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + norm).clamp(
        min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + norm).clamp(min=0.0) * (ay2 - ay1 + norm).clamp(
        min=0.0)
    area_b = (bx2 - bx1 + norm).clamp(min=0.0) * (by2 - by1 + norm).clamp(
        min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-10),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU: x [N, 4], y [M, 4] → [N, M]."""
    x = _t(x)
    return _iou_matrix(x, _t(y, x), normalized=box_normalized)


box_iou = iou_similarity


# ---------------------------------------------------------------------------
# multiclass_nms
# ---------------------------------------------------------------------------
def _greedy_keep(iou, valid, nms_threshold, nms_eta):
    """Greedy suppression over score-sorted candidates, every image and
    class at once: ``iou`` [..., K, K], ``valid`` [..., K] → keep [..., K].
    Step i keeps candidate i (if valid) unless a kept candidate j < i
    overlaps it by more than the threshold; ``keep`` holds False beyond i,
    so "kept" already means "kept and earlier"."""
    k = valid.shape[-1]
    keep = torch.zeros_like(valid)
    adaptive = nms_eta < 1.0
    if adaptive:
        thr = torch.full(valid.shape[:-1], float(nms_threshold),
                         dtype=torch.float32, device=valid.device)
    else:
        over = iou > float(nms_threshold)
    for i in range(k):
        over_i = (iou[..., i, :] > thr[..., None]) if adaptive \
            else over[..., i, :]
        ki = valid[..., i] & ~(keep & over_i).any(-1)
        keep[..., i] = ki
        if adaptive:
            thr = torch.where(ki & (thr > 0.5), thr * nms_eta, thr)
    return keep


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_index=False):
    """Static-shape multiclass NMS: ``bboxes`` [N, M, 4], ``scores``
    [N, C, M] → (out [N, keep_top_k, 6], nms_rois_num [N] int32[, index
    [N, keep_top_k]]). ``keep_top_k=-1`` keeps all C·K candidates."""
    bb = _t(bboxes).detach()
    sc = _t(scores, bb).detach()
    n, m, _ = bb.shape
    c = sc.shape[1]
    ktk = min(int(nms_top_k), m)
    kt = c * ktk if int(keep_top_k) < 0 else int(keep_top_k)

    # each class's candidates: the stable order of -score, as argsort's
    order = torch.sort(-sc, dim=-1, stable=True).indices[..., :ktk]
    s = torch.gather(sc, 2, order)                               # [N, C, K]
    b = torch.gather(bb[:, None].expand(n, c, m, 4), 2,
                     order[..., None].expand(n, c, ktk, 4))      # [N, C, K, 4]
    iou = _iou_matrix(b, b, normalized=normalized)               # [N, C, K, K]
    keep = _greedy_keep(iou, s > score_threshold, nms_threshold, nms_eta)
    del iou
    labels = torch.arange(c, device=bb.device)[:, None].expand(c, ktk)
    if background_label >= 0:
        keep = keep & (labels != background_label)
    flat_keep = keep.reshape(n, c * ktk)
    flat_s = s.reshape(n, c * ktk)
    ranked = torch.where(flat_keep, flat_s,
                         torch.full((), -math.inf, dtype=flat_s.dtype,
                                    device=bb.device))
    top = torch.sort(-ranked, dim=-1, stable=True).indices[:, :kt]
    sel_valid = torch.gather(flat_keep, 1, top)
    sel_s = torch.gather(flat_s, 1, top)
    sel_lab = labels.reshape(-1)[top].to(bb.dtype)
    sel_idx = torch.gather(order.reshape(n, c * ktk), 1, top)
    sel_box = torch.gather(bb, 1, sel_idx[..., None].expand(*sel_idx.shape,
                                                             4))
    zero = torch.zeros((), dtype=bb.dtype, device=bb.device)
    out = torch.cat([
        torch.where(sel_valid, sel_lab, zero - 1.0)[..., None],
        torch.where(sel_valid, sel_s, zero)[..., None],
        sel_box * sel_valid[..., None].to(bb.dtype)], dim=-1)
    counts = sel_valid.sum(-1).to(torch.int32)
    if return_index:
        return out, counts, sel_idx
    return out, counts


# ---------------------------------------------------------------------------
# roi_align / psroi_pool
# ---------------------------------------------------------------------------
def _roi_batch_index(rois_n, r, device):
    """The image of each of the ``r`` RoIs from per-image counts."""
    cum = torch.cumsum(rois_n.to(device=device, dtype=torch.int64), 0)
    return torch.searchsorted(cum, torch.arange(r, device=device),
                              right=True)


def roi_align(input, boxes, output_size, spatial_scale=1.0,
              sampling_ratio=-1, boxes_num=None, aligned=True, name=None):
    """RoIAlign: ``input`` [N, C, H, W], ``boxes`` [R, 4] (x1, y1, x2,
    y2), ``boxes_num`` [N] (RoIs an image, in order) → [R, C, ph, pw].
    ``sampling_ratio=-1`` takes a fixed 2x2 grid a bin; ``aligned`` moves
    the boxes by half a pixel."""
    feat = _t(input)
    rois = _t(boxes, feat)
    ph, pw = _pair(output_size)
    sr = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    n, ch, h, w = feat.shape
    r = rois.shape[0]
    dev = feat.device
    if boxes_num is None:
        if n != 1:
            raise ValueError(
                "roi_align: boxes_num is required when the input batch has "
                "more than one image (otherwise every RoI would silently "
                "pool from image 0)")
        batch_idx = torch.zeros(r, dtype=torch.int64, device=dev)
    else:
        batch_idx = _roi_batch_index(_t(boxes_num, feat).detach(), r, dev)
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - off
    y1 = rois[:, 1] * spatial_scale - off
    x2 = rois[:, 2] * spatial_scale - off
    y2 = rois[:, 3] * spatial_scale - off
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    bin_w, bin_h = rw / pw, rh / ph
    f32 = dict(dtype=torch.float32, device=dev)
    # sample points: y = y1 + (iy + (s + .5)/sr) * bin_h
    gy = (torch.arange(ph, **f32)[:, None]
          + (torch.arange(sr, **f32)[None, :] + 0.5) / sr).reshape(-1)
    gx = (torch.arange(pw, **f32)[:, None]
          + (torch.arange(sr, **f32)[None, :] + 0.5) / sr).reshape(-1)
    sy = y1[:, None] + gy[None, :] * bin_h[:, None]  # [R, P]
    sx = x1[:, None] + gx[None, :] * bin_w[:, None]  # [R, Q]

    def corners(v, size):
        v0 = torch.floor(v).clamp(0, size - 1)
        i0 = v0.long()
        i1 = (i0 + 1).clamp(max=size - 1)
        w1 = (v - v0).clamp(0.0, 1.0)
        inside = (v >= -1.0) & (v <= size)  # outside [-1, size]: zero
        return i0, i1, 1.0 - w1, w1, inside

    y0i, y1i, wy0, wy1, in_y = corners(sy, h)
    x0i, x1i, wx0, wx1, in_x = corners(sx, w)
    # gather rows of the channels-last map: one [R, P, Q, C] block a corner
    flat = feat.permute(0, 2, 3, 1).reshape(n * h * w, ch)
    base = batch_idx[:, None, None] * (h * w)
    out = 0.0
    for yi, wy in ((y0i, wy0), (y1i, wy1)):
        for xi, wx in ((x0i, wx0), (x1i, wx1)):
            idx = base + yi[:, :, None] * w + xi[:, None, :]    # [R, P, Q]
            g = flat.index_select(0, idx.reshape(-1)).reshape(
                r, ph * sr, pw * sr, ch)
            out = out + g * (wy[:, :, None] * wx[:, None, :])[..., None]
    mask = (in_y[:, :, None] & in_x[:, None, :]).to(out.dtype)
    out = out * mask[..., None]
    out = out.reshape(r, ph, sr, pw, sr, ch).mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling (R-FCN): ``x`` [N, C, H, W]
    with C = out_channels·ph·pw, ``boxes`` [R, 4], ``boxes_num`` [N] →
    [R, out_channels, ph, pw]. Box corners are rounded then scaled, bins
    take floor/ceil edges, an empty bin gives 0. Each bin is a masked
    sum: the row masks and column masks contract with the map, the
    columns first for every image, then the RoI's own image is picked."""
    feat = _t(x)
    rois = _t(boxes, feat)
    ph, pw = _pair(output_size)
    n, cin, h, w = feat.shape
    r = rois.shape[0]
    if cin % (ph * pw) != 0:
        raise ValueError(f"psroi_pool: C={cin} must be out_channels*{ph}*"
                         f"{pw}")
    cout = cin // (ph * pw)
    dev = feat.device
    batch_idx = _roi_batch_index(_t(boxes_num, feat).detach(), r, dev)
    x1 = torch.round(rois[:, 0]) * spatial_scale
    y1 = torch.round(rois[:, 1]) * spatial_scale
    x2 = (torch.round(rois[:, 2]) + 1.0) * spatial_scale
    y2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    # divided by tensors: CUDA multiplies by the reciprocal of a scalar
    # divisor, an ulp off the true quotient, which moves floor/ceil edges
    bh = (y2 - y1).clamp(min=0.1) / torch.full_like(y1, ph)
    bw = (x2 - x1).clamp(min=0.1) / torch.full_like(x1, pw)
    ivec = torch.arange(ph, dtype=feat.dtype, device=dev)
    jvec = torch.arange(pw, dtype=feat.dtype, device=dev)
    hstart = torch.floor(ivec[None] * bh[:, None] + y1[:, None]).clamp(
        0, h).long()                                          # [R, ph]
    hend = torch.ceil((ivec[None] + 1) * bh[:, None] + y1[:, None]).clamp(
        0, h).long()
    wstart = torch.floor(jvec[None] * bw[:, None] + x1[:, None]).clamp(
        0, w).long()                                          # [R, pw]
    wend = torch.ceil((jvec[None] + 1) * bw[:, None] + x1[:, None]).clamp(
        0, w).long()
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    mask_y = ((ys >= hstart[..., None]) & (ys < hend[..., None])).to(
        feat.dtype)                                           # [R, ph, H]
    mask_x = ((xs >= wstart[..., None]) & (xs < wend[..., None])).to(
        feat.dtype)                                           # [R, pw, W]
    # input channel = (c*ph + i)*pw + j
    featr = feat.reshape(n, cout, ph, pw, h, w)
    cols = torch.einsum("ncijhw,rjw->nrcijh", featr, mask_x)
    cols = cols[batch_idx, torch.arange(r, device=dev)]       # [R,c,i,j,H]
    s = torch.einsum("rcijh,rih->rcij", cols, mask_y)
    area = ((hend - hstart)[:, None, :, None]
            * (wend - wstart)[:, None, None, :]).to(feat.dtype)
    return torch.where(area > 0, s / area.clamp(min=1.0),
                       torch.zeros((), dtype=feat.dtype, device=dev))


# ---------------------------------------------------------------------------
# deform_conv2d
# ---------------------------------------------------------------------------
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (``mask=None``) and v2 (modulated):
    ``x`` [N, Cin, H, W], ``offset`` [N, dg·2·kh·kw, Ho, Wo] with a
    (Δh, Δw) pair a kernel position, ``mask`` [N, dg·kh·kw, Ho, Wo],
    ``weight`` [Cout, Cin/g, kh, kw] → [N, Cout, Ho, Wo]. The sampled
    columns [N, Cin, K, Ho, Wo] are a bilinear gather (each corner
    outside the image weighs 0), then one grouped contraction with the
    weight."""
    xv = _t(x)
    off = _t(offset, xv)
    wv = _t(weight, xv)
    sh, sw = _pair(stride)
    ph_, pw_ = _pair(padding)
    dh, dw = _pair(dilation)
    n, cin, h, w = xv.shape
    cout, cin_g, kh, kw = wv.shape
    dg = int(deformable_groups)
    kk = kh * kw
    ho = (h + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    dev = xv.device

    # the base sampling grid of each kernel position and output location
    oy = (torch.arange(ho, device=dev) * sh - ph_).to(off.dtype)
    ox = (torch.arange(wo, device=dev) * sw - pw_).to(off.dtype)
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw, device=dev) * dw, indexing="ij")
    base_y = oy[None, :, None] + ky.reshape(-1)[:, None, None].to(off.dtype)
    base_x = ox[None, None, :] + kx.reshape(-1)[:, None, None].to(off.dtype)
    off = off.reshape(n, dg, kk, 2, ho, wo)
    sy = base_y + off[:, :, :, 0]                      # [N, dg, K, Ho, Wo]
    sx = base_x + off[:, :, :, 1]

    cg = cin // dg
    img = xv.reshape(n, dg, cg, h * w)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy1 = (sy - y0).to(xv.dtype)
    wx1 = (sx - x0).to(xv.dtype)
    length = kk * ho * wo
    cols = 0.0
    for iy, wyy in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
        for ix, wxx in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
            inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
            yi = iy.clamp(0, h - 1).long()
            xi = ix.clamp(0, w - 1).long()
            idx = (yi * w + xi).reshape(n, dg, 1, length).expand(
                n, dg, cg, length)
            v = torch.gather(img, 3, idx)              # [N, dg, cg, K*Ho*Wo]
            wgt = (wyy * wxx * inside.to(xv.dtype)).reshape(n, dg, 1, length)
            cols = cols + v * wgt
    cols = cols.reshape(n, dg, cg, kk, ho, wo)
    if mask is not None:
        cols = cols * _t(mask, xv).reshape(n, dg, 1, kk, ho, wo)
    # grouped contraction: out[n, m, p] = sum_{c_g, k} w[m, c_g, k] · cols
    cols = cols.reshape(n, groups, cin // groups, kk, ho, wo)
    wg = wv.reshape(groups, cout // groups, cin_g, kk)
    out = torch.einsum("ngckhw,gmck->ngmhw", cols, wg).reshape(
        n, cout, ho, wo)
    if bias is not None:
        out = out + _t(bias, xv).reshape(1, -1, 1, 1).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# spp / space_to_depth_stem_conv
# ---------------------------------------------------------------------------
def spp(x, pyramid_height=3, pooling_type="max", name=None):
    """Spatial pyramid pooling: level p pools ``x`` [N, C, H, W]
    adaptively to a 2^p x 2^p grid; the levels are flattened and
    concatenated to [N, C·(4^height − 1)/3]."""
    from ..nn import functional as F

    if pooling_type not in ("max", "avg"):
        raise ValueError(f"spp: unknown pooling_type {pooling_type!r}")
    pool = (F.adaptive_max_pool2d if pooling_type == "max"
            else F.adaptive_avg_pool2d)
    x = _t(x)
    return torch.cat([torch.flatten(pool(x, 2 ** p), 1)
                      for p in range(int(pyramid_height))], dim=1)


def space_to_depth_stem_conv(x, weight):
    """The ResNet stem conv (7x7, stride 2, pad 3) as a stride-1 4x4 conv
    over the 2x2 space-to-depth of the input: the kernel is padded to
    8x8 and its taps regrouped, the same sum. ``x`` [N, 3, H, W] (H, W
    even), ``weight`` [C_out, 3, 7, 7] → [N, C_out, H/2, W/2]."""
    a = _t(x)
    w = _t(weight, a)
    n, ci, hh, ww = a.shape
    co = w.shape[0]
    ap = TF.pad(a, (3, 3, 3, 3))
    hp, wp = hh + 6, ww + 6
    z = ap.reshape(n, ci, hp // 2, 2, wp // 2, 2)
    z = z.permute(0, 1, 3, 5, 2, 4).reshape(n, ci * 4, hp // 2, wp // 2)
    w8 = TF.pad(w, (0, 1, 0, 1))
    w2 = w8.reshape(co, ci, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4).reshape(
        co, ci * 4, 4, 4)
    out = TF.conv2d(z, w2)
    return out[:, :, :hh // 2, :ww // 2]
