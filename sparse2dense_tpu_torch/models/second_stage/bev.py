"""BEV feature extraction for the second stage (counterpart of
``sparse2dense_tpu/models/second_stage/bev.py``): the first stage's
fixed-size boxes (B, R, >=7) give 1 or 5 points a box (``box_centers``),
and each point takes the bilinear sample of the BEV map there
(``bilinear_interpolate``). The map is the neck's NHWC output, a permuted
view of an NCHW tensor: the gather indexes it in place, so the map is never
copied (at the flagship recipe's (B, 512, 188, 188) that copy would be
72 MB a sample)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def bilinear_interpolate(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """im (B, H, W, C) (any strides), x / y (B, N) -> (B, N, C). The
    reference's clamp: at the last row and column the neighbour is clamped
    onto the point itself, and the weights of that side go to 0."""
    _, h, w, _ = im.shape
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    b = torch.arange(im.shape[0], device=im.device)[:, None]

    ia, ib, ic, id_ = im[b, y0, x0], im[b, y1, x0], im[b, y0, x1], im[b, y1, x1]
    x0f, x1f = x0.to(x.dtype), x1.to(x.dtype)
    y0f, y1f = y0.to(y.dtype), y1.to(y.dtype)
    wa = (x1f - x) * (y1f - y)
    wb = (x1f - x) * (y - y0f)
    wc = (x - x0f) * (y1f - y)
    wd = (x - x0f) * (y - y0f)
    return ia * wa[..., None] + ib * wb[..., None] + ic * wc[..., None] + id_ * wd[..., None]


def box_centers(boxes: torch.Tensor, num_point: int) -> torch.Tensor:
    """(B, R, >=7) boxes -> (B, R * num_point, 3) sample points: the centre,
    and with 5 points the 4 edge midpoints after it, point-major."""
    if num_point == 1:
        return boxes[..., :3]
    assert num_point == 5, num_point
    cx, cy, z = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    dx, dy = boxes[..., 3], boxes[..., 4]
    ang = boxes[..., -1]
    c, s = torch.cos(ang), torch.sin(ang)
    pts = [torch.stack([cx, cy, z], -1)]
    # local edge midpoints: (+dx/2, 0), (-dx/2, 0), (0, +dy/2), (0, -dy/2)
    for lx, ly in ((0.5, 0.0), (-0.5, 0.0), (0.0, 0.5), (0.0, -0.5)):
        px = cx + lx * dx * c - ly * dy * s
        py = cy + lx * dx * s + ly * dy * c
        pts.append(torch.stack([px, py, z], -1))
    return torch.cat(pts, 1)


class BEVFeatureExtractor(nn.Module):
    """Bilinear BEV features at the sample points; no parameters."""

    def __init__(self, pc_start: Sequence[float] = (-75.2, -75.2),
                 voxel_size: Sequence[float] = (0.1, 0.1), out_stride: int = 8):
        super().__init__()
        self.pc_start, self.voxel_size = tuple(pc_start), tuple(voxel_size)
        self.out_stride = out_stride

    def forward(self, bev_feature: torch.Tensor, centers: torch.Tensor,
                num_point: int) -> torch.Tensor:
        """bev_feature (B, H, W, C); centers (B, R * num_point, 3) -> (B, R,
        C * num_point), the points' features side by side."""
        xs = (centers[..., 0] - self.pc_start[0]) / self.voxel_size[0] / self.out_stride
        ys = (centers[..., 1] - self.pc_start[1]) / self.voxel_size[1] / self.out_stride
        feats = bilinear_interpolate(bev_feature, xs, ys)
        r = feats.shape[1] // num_point
        return torch.cat([feats[:, i * r:(i + 1) * r] for i in range(num_point)], -1)
