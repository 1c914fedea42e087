"""``DetectionMAP`` — counterpart of ``paddle_tpu.metric.detection``: the
mAP of detection outputs, accumulated on the host in numpy as the
reference does (the per-image blocks are small, fixed-size NMS outputs).

``update`` takes numpy arrays or tensors (on any device): a tensor is
copied to the host once per call.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DetectionMAP"]


def _host(*xs):
    """The arrays of ``xs`` as float64 numpy; the device tensors among
    them come over in one copy."""
    import torch

    dev = [x for x in xs if isinstance(x, torch.Tensor)]
    if dev:
        flat = torch.cat([x.detach().reshape(-1).double() for x in dev])
        flat = flat.cpu().numpy()
    out, at = [], 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n = x.numel()
            out.append(flat[at:at + n].reshape(tuple(x.shape)))
            at += n
        else:
            out.append(np.asarray(x, np.float64))
    return out


class DetectionMAP:
    """Accumulates (detections, ground truths) per image and computes
    the mAP over classes, 11-point interpolated or integral.

    ``update(dets, gts)``: dets [D, 6] rows (label, score, x1, y1, x2,
    y2), the padded NMS block (rows with label < 0 are ignored); gts
    [G, 5] rows (label, x1, y1, x2, y2), or [G, 6] with a trailing
    is_difficult flag.
    """

    def __init__(self, overlap_threshold=0.5, ap_type="integral",
                 evaluate_difficult=False, class_num=None, name=None):
        if ap_type not in ("integral", "11point"):
            raise ValueError("ap_type must be 'integral' or '11point'")
        self._thr = float(overlap_threshold)
        self._ap_type = ap_type
        self._eval_difficult = bool(evaluate_difficult)
        self.reset()

    def reset(self):
        self._images = []  # (dets, gts, difficult) per image

    def update(self, dets, gts):
        dets, gts = _host(dets, gts)
        dets = dets.reshape(-1, 6)
        if gts.size == 0:
            gts = gts.reshape(0, 5)
        if gts.shape[1] == 5:
            diff = np.zeros(len(gts), bool)
        else:
            diff = gts[:, 5] > 0
            gts = gts[:, :5]
        self._images.append((dets[dets[:, 0] >= 0], gts, diff))

    @staticmethod
    def _iou_matrix(d, g):
        """d [D, 4], g [G, 4] → [D, G]."""
        dx1, dy1, dx2, dy2 = (d[:, None, i] for i in range(4))
        gx1, gy1, gx2, gy2 = (g[None, :, i] for i in range(4))
        iw = np.clip(np.minimum(dx2, gx2) - np.maximum(dx1, gx1), 0, None)
        ih = np.clip(np.minimum(dy2, gy2) - np.maximum(dy1, gy1), 0, None)
        inter = iw * ih
        ua = ((dx2 - dx1) * (dy2 - dy1) + (gx2 - gx1) * (gy2 - gy1) - inter)
        return np.where(ua > 0, inter / np.maximum(ua, 1e-12), 0.0)

    def _class_matches(self, c):
        """(scores, 0/1 matches, positives) of class ``c``: detections in
        score order take the best-overlapping ground truth once; a match
        with a difficult one is ignored unless difficult ones count."""
        scores, matches, npos = [], [], 0
        for dets, gts, diff in self._images:
            g = gts[gts[:, 0] == c]
            gd = diff[gts[:, 0] == c]
            npos += len(g) if self._eval_difficult else int((~gd).sum())
            d = dets[dets[:, 0] == c]
            d = d[np.argsort(-d[:, 1])]
            used = np.zeros(len(g), bool)
            iou = self._iou_matrix(d[:, 2:6], g[:, 1:5]) if len(g) \
                else np.zeros((len(d), 0))
            for r, row in enumerate(d):
                bi = int(np.argmax(iou[r])) if iou.shape[1] else -1
                best = float(iou[r, bi]) if bi >= 0 else 0.0
                # a zero-overlap pair is never a match, even at thr=0
                hit = bi >= 0 and best > 0.0 and best >= self._thr
                if hit and not self._eval_difficult and gd[bi]:
                    continue
                scores.append(row[1])
                matches.append(1 if hit and not used[bi] else 0)
                if hit:
                    used[bi] = True
        return scores, matches, npos

    def accumulate(self):
        labels = set()
        for dets, gts, _ in self._images:
            labels.update(int(l) for l in dets[:, 0])
            labels.update(int(l) for l in gts[:, 0])
        aps = []
        for c in sorted(labels):
            scores, matches, npos = self._class_matches(c)
            if npos == 0:
                continue
            order = np.argsort(-np.asarray(scores)) if scores else []
            tp = np.asarray(matches, np.float64)[order] if scores \
                else np.zeros(0)
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(1.0 - tp)
            recall = tp_cum / npos
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            if self._ap_type == "11point":
                ap = sum((precision[recall >= t].max()
                          if (recall >= t).any() else 0.0) / 11
                         for t in np.linspace(0, 1, 11))
            else:
                # Σ precision·Δrecall, raw precision (no interpolation)
                ap, prev_r = 0.0, 0.0
                for p, r in zip(precision, recall):
                    ap += p * (r - prev_r)
                    prev_r = r
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0

    def name(self):
        return "detection_map"
