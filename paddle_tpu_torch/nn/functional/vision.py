"""Spatial warps — counterpart of ``paddle_tpu.nn.functional.vision``:
``grid_sample``, ``affine_grid`` and ``temporal_shift``.

The reference's are gathers and lerps at the XLA level, so these are
plain PyTorch with its arithmetic. ``torch.nn.functional.grid_sample`` is
not used: the reference's ``border`` mode clamps the four gathered
corners, not the coordinate, and its ``nearest`` mode rounds half to even
and masks by the rounded index, which differ from torch's rules near the
edges. ``temporal_shift`` also takes ``NHWC`` (the reference raises).
"""
from __future__ import annotations

import torch

__all__ = ["grid_sample", "affine_grid", "temporal_shift"]


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(v: torch.Tensor, size: int, align_corners: bool):
    lo, span = (0.0, float(size - 1)) if align_corners else (-0.5,
                                                             float(size))
    if span <= 0:
        return torch.zeros_like(v)
    u = (v - lo).abs()
    extra = torch.remainder(u, span)
    even = torch.remainder(torch.floor(u / span), 2.0) == 0
    out = torch.where(even, extra + lo, span - extra + lo)
    return out.clamp(0, size - 1)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True,
                name=None) -> torch.Tensor:
    """``x`` [N, C, H, W] sampled at ``grid`` [N, Hg, Wg, 2] (x, y in
    [-1, 1]): [N, C, Hg, Wg]. ``mode`` bilinear or nearest;
    ``padding_mode`` zeros (a corner outside counts 0), border (the
    corner's index clamped) or reflection (the coordinate reflected)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    n, _, h, w = x.shape
    gx = _unnormalize(grid[..., 0].float(), w, align_corners)
    gy = _unnormalize(grid[..., 1].float(), h, align_corners)
    if padding_mode == "reflection":
        gx = _reflect(gx, w, align_corners)
        gy = _reflect(gy, h, align_corners)
    img = x.permute(0, 2, 3, 1)  # [N, H, W, C]
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        cx = ix.clamp(0, w - 1).long()
        cy = iy.clamp(0, h - 1).long()
        vals = img[batch, cy, cx].permute(0, 3, 1, 2)  # [N, C, Hg, Wg]
        if padding_mode == "zeros":
            vals = vals * inb[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return sample(torch.round(gx), torch.round(gy)).to(x.dtype)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    out = (sample(x0, y0) * ((1 - wx) * (1 - wy))
           + sample(x0 + 1, y0) * (wx * (1 - wy))
           + sample(x0, y0 + 1) * ((1 - wx) * wy)
           + sample(x0 + 1, y0 + 1) * (wx * wy))
    return out.to(x.dtype)


def affine_grid(theta: torch.Tensor, out_shape, align_corners: bool = True,
                name=None) -> torch.Tensor:
    """The sampling grid [N, H, W, 2] of the affine maps ``theta``
    [N, 2, 3] over an output of ``out_shape`` [N, C, H, W]."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = (int(v) for v in out_shape)
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1.0
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    out = torch.einsum("nij,pj->npi", theta.float(), base)
    return out.reshape(theta.shape[0], h, w, 2).to(theta.dtype)


def temporal_shift(x: torch.Tensor, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW", name=None) -> torch.Tensor:
    """TSM's shift of ``x`` [N·T, C, H, W] (or NHWC): the first
    ``C·shift_ratio`` channels take the next segment's values, the next as
    many the previous segment's, zeros at the ends; the rest stay."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"temporal_shift: unknown data_format "
                         f"{data_format!r}")
    a = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    nt, c, h, w = a.shape
    v = a.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    back = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])],
                     1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                     v[:, :-1, fold:2 * fold]], 1)
    out = torch.cat([back, fwd, v[:, :, 2 * fold:]], 2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
