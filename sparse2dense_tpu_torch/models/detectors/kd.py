"""The Sparse2Dense students (counterpart of
``sparse2dense_tpu/models/detectors/kd.py:38-313``). KD_VoxelNet: reader ->
sparse backbone -> S2D_RPN -> CenterHead (or SECOND's MultiGroupHead),
decode + rotated NMS in :meth:`predict`, and its losses. Its PCR targets
are the ``reconstruction_*_{2,4}`` voxel streams rasterized as mean-point
grids at 1/2 and 1/4 of the grid (spconv's ``SparseConvTensor.dense()`` of
det3d), held against the generators' occupancy logits and point offsets.
KD_PointPillars: pillar reader -> ``PointPillarsScatter_S2D`` (scatter,
S2D, and the PCR generators at the full grid, depth 1) -> RPN -> head; its
PCR target is the ``reconstruction_*`` stream's mean points (the first 5
features) on that depth-1 grid. The reference computes the same targets
and losses z-folded (a TPU layout); here they are 5D."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sparse_conv import scatter_to_dense
from ...parallel.dist import global_sum, global_sums, world_size
from ..heads.center_head import center_head_loss, center_head_predict
from ..heads.mg_head import MultiGroupHead, mg_head_loss, mg_head_predict
from ...training.train_state import Mark
from .voxelnet import head_maps, two_stage_boxes


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
    mean-point grid (xyz first), grid (D, H, W, 3) cell centres. The
    balance, the mean and the offset count are the global batch's."""
    z = (gt.sum(-1) != 0).to(gen_mask.dtype)
    empty, occupied = global_sums((1.0 - z).sum(), z.sum())
    beta = empty / occupied.clamp(min=1.0)
    x = gen_mask[..., 0]
    # every process's grids have one shape: the global mean is the local
    # mean over the processes
    loss = (beta * z * F.softplus(-x) + (1.0 - z) * F.softplus(x)).mean() / world_size()
    gt_off = gt[..., :3] - grid[None] * z[..., None]
    ind = (gt_off != 0).to(gen_offset.dtype)
    com_loss = ((gen_offset - gt_off).abs() * ind).sum() / global_sum(ind.sum()).clamp(min=1.0)
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

    def forward_two_stage(self, example, mark: Mark = None):
        """The first stage of a ``TwoStageDetector`` -> (the fixed-size
        detections of the detached preds, the S2D neck's BEV map (NHWC), the
        preds, the backbone's counters); ``mark`` as ``two_stage_boxes``'. A
        frozen stage runs in eval mode, where the neck skips the PCR
        generators."""
        feats = self.reader(example["voxels"], example["num_points"])
        bev, _, telemetry = self.backbone(feats, example["coordinates"])
        x = self.neck(bev)[0]
        preds = self.bbox_head(x)
        return two_stage_boxes(self, preds, example, mark), x, preds, telemetry

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
        """The head's loss of ``preds`` (the forward's output or its
        "preds") and its logs."""
        preds = head_maps(preds)
        if isinstance(self.bbox_head, MultiGroupHead):
            return mg_head_loss(self.bbox_head, preds, example)
        return center_head_loss(preds, example, weight=self.bbox_head.weight,
                                code_weights=self.bbox_head.code_weights)

    def predict(self, preds, test_cfg=None, example=None):
        """Detections of ``preds`` (the forward's output or its "preds");
        the anchor head decodes against ``example``'s "anchors"."""
        preds = head_maps(preds)
        cfg = test_cfg if test_cfg is not None else self.test_cfg
        if isinstance(self.bbox_head, MultiGroupHead):
            return mg_head_predict(self.bbox_head, preds, example, cfg)
        return center_head_predict(preds, cfg, self.bbox_head.num_classes)


class KD_PointPillars(KD_VoxelNet):
    def forward(self, example):
        """example: {"voxels" (B, V, P, C), "num_points" (B, V),
        "coordinates" (B, V, 3)} -> {"preds", "f_s_a", "f_s_b" (NHWC),
        "gen_offset" (B, 3, 1, H, W), "gen_mask" (B, 1, 1, H, W) (None in
        eval), "telemetry" (none)}."""
        coords = example["coordinates"]
        feats = self.reader(example["voxels"], example["num_points"], coords)
        f_s_a, f_s_b, gen_offset, gen_mask = self.backbone(feats, coords)
        return {"preds": self.bbox_head(self.neck(f_s_a)), "f_s_a": f_s_a, "f_s_b": f_s_b,
                "gen_offset": gen_offset, "gen_mask": gen_mask, "telemetry": {}}

    def forward_two_stage(self, example, mark: Mark = None):
        """As KD_VoxelNet's, on the pillar path (the S2D scatter's F_S_a
        through the RPN); no counters."""
        coords = example["coordinates"]
        feats = self.reader(example["voxels"], example["num_points"], coords)
        x = self.neck(self.backbone(feats, coords)[0])
        preds = self.bbox_head(x)
        return two_stage_boxes(self, preds, example, mark), x, preds, {}

    def pcr_loss(self, out, example):
        """(mask_loss, offset_loss) on the full grid at depth 1."""
        offset = out["gen_offset"].permute(0, 2, 3, 4, 1)
        mask = out["gen_mask"].permute(0, 2, 3, 4, 1)
        shape = tuple(mask.shape[1:4])
        gt = rasterize_mean_points(example["reconstruction_voxels"][..., :5],
                                   example["reconstruction_num_points"],
                                   example["reconstruction_coordinates"], shape)
        return mask_offset_loss(offset, mask, gt,
                                world_grid(shape, self.pc_range_full, mask.device))
