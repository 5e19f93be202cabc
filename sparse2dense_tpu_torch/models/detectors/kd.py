"""KD_VoxelNet, the Sparse2Dense student (counterpart of
``sparse2dense_tpu/models/detectors/kd.py:38-238``): reader -> sparse
backbone -> S2D_RPN -> CenterHead, decode + rotated NMS in :meth:`predict`,
and its losses. The PCR targets are the ``reconstruction_*_{2,4}`` voxel
streams rasterized as mean-point grids at 1/2 and 1/4 of the grid
(spconv's ``SparseConvTensor.dense()`` of det3d), held against the
generators' occupancy logits and point offsets. The reference computes the
same targets and losses z-folded (a TPU layout); here they are 5D."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sparse_conv import scatter_to_dense
from ..heads.center_head import center_head_loss, center_head_predict


def world_grid(shape: Tuple[int, int, int], pc_range_full: Sequence[float],
               device=None) -> torch.Tensor:
    """(D, H, W, 3) xyz cell-centre coordinates of a grid over the range."""
    d, h, w = shape
    x0, y0, z0, x1, y1, z1 = pc_range_full
    zs, ys, xs = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=device)
                                  for n in (d, h, w)), indexing="ij")
    xs = xs * ((x1 - x0) / w) + x0 + ((x1 - x0) / w) / 2
    ys = ys * ((y1 - y0) / h) + y0 + ((y1 - y0) / h) / 2
    zs = zs * ((z1 - z0) / d) + z0 + ((z1 - z0) / d) / 2
    return torch.stack([xs, ys, zs], -1)


def rasterize_mean_points(voxels, num_points, coords, shape) -> torch.Tensor:
    """Mean point of each voxel scattered to a dense (B, D, H, W, C) grid:
    voxels (B, V, P, C), num_points (B, V), coords (B, V, 3) zyx, -1 pad."""
    mean = voxels.sum(-2) / num_points.clamp(min=1).to(voxels.dtype)[..., None]
    valid = (coords >= 0).all(-1)
    mean = mean * valid[..., None].to(mean.dtype)
    return torch.stack([scatter_to_dense(f, c, v, shape) for f, c, v in zip(mean, coords, valid)])


def mask_offset_loss(gen_offset, gen_mask, gt, grid):
    """(class-balanced BCE on occupancy, L1 on the point-mean offsets):
    gen_offset (B, D, H, W, 3), gen_mask (B, D, H, W, 1), gt (B, D, H, W, C)
    mean-point grid (xyz first), grid (D, H, W, 3) cell centres."""
    z = (gt.sum(-1) != 0).to(gen_mask.dtype)
    beta = (1.0 - z).sum() / z.sum().clamp(min=1.0)
    x = gen_mask[..., 0]
    loss = (beta * z * F.softplus(-x) + (1.0 - z) * F.softplus(x)).mean()
    gt_off = gt[..., :3] - grid[None] * z[..., None]
    ind = (gt_off != 0).to(gen_offset.dtype)
    com_loss = ((gen_offset - gt_off).abs() * ind).sum() / ind.sum().clamp(min=1.0)
    return loss, com_loss


class KD_VoxelNet(nn.Module):
    def __init__(self, reader: nn.Module, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, test_cfg: Optional[Any] = None,
                 pc_range_full: Sequence[float] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)):
        super().__init__()
        self.reader, self.backbone, self.neck, self.bbox_head = reader, backbone, neck, bbox_head
        self.test_cfg = test_cfg
        self.pc_range_full = tuple(pc_range_full)

    def forward(self, example):
        """example: {"voxels" (B, V, P, C), "num_points" (B, V),
        "coordinates" (B, V, 3)} -> {"preds": per-task NHWC map dicts,
        "f_s_a", "f_s_b" (NHWC), "gen_*" (NCDHW in training, None in eval),
        "telemetry"}."""
        feats = self.reader(example["voxels"], example["num_points"])
        bev, _, telemetry = self.backbone(feats, example["coordinates"])
        x, go2, gm2, go4, gm4, f_s_a, f_s_b = self.neck(bev)
        return {"preds": self.bbox_head(x), "f_s_a": f_s_a, "f_s_b": f_s_b,
                "gen_offset_2": go2, "gen_mask_2": gm2, "gen_offset_4": go4,
                "gen_mask_4": gm4, "telemetry": telemetry}

    def pcr_loss(self, out, example):
        """(mask_loss, offset_loss), each summed over the /2 and /4 streams."""
        losses = []
        for tag in ("2", "4"):
            offset = out[f"gen_offset_{tag}"].permute(0, 2, 3, 4, 1)
            mask = out[f"gen_mask_{tag}"].permute(0, 2, 3, 4, 1)
            shape = tuple(mask.shape[1:4])
            gt = rasterize_mean_points(example[f"reconstruction_voxels_{tag}"],
                                       example[f"reconstruction_num_points_{tag}"],
                                       example[f"reconstruction_coordinates_{tag}"], shape)
            losses.append(mask_offset_loss(offset, mask, gt,
                                           world_grid(shape, self.pc_range_full, mask.device)))
        return losses[0][0] + losses[1][0], losses[0][1] + losses[1][1]

    def loss(self, preds, example):
        return center_head_loss(preds, example, weight=self.bbox_head.weight,
                                code_weights=self.bbox_head.code_weights)

    def predict(self, preds, test_cfg=None):
        if isinstance(preds, dict) and "preds" in preds:
            preds = preds["preds"]
        cfg = test_cfg if test_cfg is not None else self.test_cfg
        return center_head_predict(preds, cfg, self.bbox_head.num_classes)
