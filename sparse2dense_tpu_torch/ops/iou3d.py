"""Rotated 3D box IoU (counterpart of ``sparse2dense_tpu/ops/iou3d.py``):
the BEV rotated intersection (the Sutherland-Hodgman clip of
``ops/rotated_iou.py``) times the vertical overlap, over the union of the
volumes. Boxes are (x, y, z, w, l, h, yaw), z the gravity centre.

Every op is elementwise over the broadcast pair shape, on the tensors' own
device, so a batch of (R, G) matrices is one call over (B, R, G): the
proposal targets of a recipe batch (500 RoIs against 500 padded gt slots a
sample) are one clip, not one a sample.
"""
from __future__ import annotations

import torch

from .rotated_iou import rotated_intersection_area

_EPS = 1e-8
_BEV = [0, 1, 3, 4, 6]


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 7) x (..., M, 7) -> (..., N, M) 3D IoU matrices (leading
    dimensions broadcast)."""
    bev_a = boxes_a[..., _BEV].unsqueeze(-2)
    bev_b = boxes_b[..., _BEV].unsqueeze(-3)
    inter_bev = rotated_intersection_area(bev_a, bev_b)

    za1 = boxes_a[..., 2] - boxes_a[..., 5] / 2
    za2 = boxes_a[..., 2] + boxes_a[..., 5] / 2
    zb1 = boxes_b[..., 2] - boxes_b[..., 5] / 2
    zb2 = boxes_b[..., 2] + boxes_b[..., 5] / 2
    inter_z = torch.clamp(
        torch.minimum(za2[..., :, None], zb2[..., None, :])
        - torch.maximum(za1[..., :, None], zb1[..., None, :]),
        min=0.0,
    )
    inter = inter_bev * inter_z
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=_EPS)
