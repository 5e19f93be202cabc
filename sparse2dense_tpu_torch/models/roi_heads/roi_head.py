"""The second-stage RoI head (counterpart of
``sparse2dense_tpu/models/roi_heads/roi_head.py``; the reference's RoIHead,
RoIHeadTemplate and ProposalTargetLayer, OpenPCDet-derived), static shapes:

- ``proposal_target_layer``: each sample's RoIs against its gt boxes of the
  same class (3D IoU, one batched call), then fg / hard-bg / easy-bg
  subsampling to ``ROI_PER_IMAGE`` by priority-keyed top-k without
  replacement, the hard background back-filling a short easy background, as
  the JAX package does (the reference draws its background with
  replacement). Its uniform draws are an argument (``rand``, (B, R)), drawn
  by the caller from its ``torch.Generator``: given JAX's draws, the
  indices equal JAX's;
- the regression targets in each RoI's canonical frame, the heading flipped
  into (-pi/2, pi/2);
- shared FC layers, then the score (IoU) and box branches: bias-free Linear,
  masked BatchNorm, ReLU, Dropout on the reference's layers, a Linear out
  layer; losses BCE-with-logits on the soft IoU labels and fg-masked L1;
- ``generate_predicted_boxes``: the local deltas rotated back to the world.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou3d import boxes_iou3d
from ...ops.topk import top_k
from ..norm import BatchNorm


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def rotate_xy(x, y, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return x * c - y * s, x * s + y * c


@torch.no_grad()
def max_iou_with_same_class(rois, roi_labels, gt_boxes, gt_labels):
    """(B, R, 7) RoIs against (B, G, 7) gt boxes, the IoU kept where the
    labels match and the gt slot is not padding (-1 elsewhere). -> (the
    largest overlap (B, R) clamped at 0, its gt slot (B, R), the first of
    equal overlaps)."""
    iou = boxes_iou3d(rois, gt_boxes)
    same = roi_labels[..., :, None] == gt_labels[..., None, :]
    gt_valid = (gt_boxes[..., 3:6] > 0).any(-1)
    iou = torch.where(same & gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    gt_assignment = torch.argmax(iou, -1)
    max_overlap = iou.max(-1).values.clamp(min=0.0)
    return max_overlap, gt_assignment


def _rank_within(mask, rand):
    """Each row's rank by descending draw among the rows of ``mask`` (the
    others after them)."""
    key = torch.where(mask, rand, torch.full_like(rand, -1.0))
    order = torch.argsort(-key, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device)
                   .expand_as(order).contiguous())
    return ranks


def subsample_rois(max_overlaps, roi_valid, cfg, rand):
    """(..., R) overlaps, validity and uniform draws -> (..., M) indices,
    ``M = min(ROI_PER_IMAGE, R)``: up to ``FG_RATIO`` of the slots for the
    foreground, ``HARD_BG_RATIO`` of the rest for the hard background, the
    easy background next, the hard background again where the easy runs
    short, each group by descending draw; the leftover slots take the other
    RoIs by draw."""
    r = max_overlaps.shape[-1]
    m = min(int(cfg["ROI_PER_IMAGE"]), r)
    fg_per = int(round(cfg["FG_RATIO"] * m))
    fg_thresh = min(cfg["REG_FG_THRESH"], cfg["CLS_FG_THRESH"])
    is_fg = (max_overlaps >= fg_thresh) & roi_valid
    is_easy = (max_overlaps < cfg["CLS_BG_THRESH_LO"]) & roi_valid
    is_hard = ((max_overlaps < cfg["REG_FG_THRESH"])
               & (max_overlaps >= cfg["CLS_BG_THRESH_LO"]) & roi_valid)

    n_fg = is_fg.sum(-1, keepdim=True)
    fg_take = n_fg.clamp(max=fg_per)
    bg_slots = m - fg_take
    n_hard = is_hard.sum(-1, keepdim=True)
    n_easy = is_easy.sum(-1, keepdim=True)
    hard_take = torch.minimum(torch.floor(bg_slots * cfg["HARD_BG_RATIO"]).to(n_hard.dtype),
                              n_hard)
    easy_take = torch.minimum(bg_slots - hard_take, n_easy)
    hard_take = torch.minimum(hard_take + (bg_slots - hard_take - easy_take), n_hard)

    key = torch.where(is_fg & (_rank_within(is_fg, rand) < fg_take), 3.0 + rand, rand - 1.0)
    key = torch.where(is_hard & (_rank_within(is_hard, rand) < hard_take), 2.0 + rand, key)
    key = torch.where(is_easy & (_rank_within(is_easy, rand) < easy_take), 1.0 + rand, key)
    return top_k(key, m)[1]


def canonical_targets(rois, gt_of_rois):
    """The matched gt boxes in each RoI's frame, heading flipped into
    (-pi/2, pi/2). rois / gt (..., 7[+])."""
    roi_ry = limit_period(rois[..., 6], 0.5, math.pi * 2)
    d = gt_of_rois[..., :6] - rois[..., :6]
    lx, ly = rotate_xy(d[..., 0], d[..., 1], -roi_ry)
    heading = gt_of_rois[..., 6] - roi_ry
    heading = torch.remainder(heading, 2 * math.pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + math.pi, 2 * math.pi), heading)
    heading = torch.where(heading > math.pi, heading - 2 * math.pi, heading)
    heading = heading.clamp(-math.pi / 2, math.pi / 2)
    return torch.cat([lx[..., None], ly[..., None], d[..., 2:3], gt_of_rois[..., 3:6],
                      heading[..., None]], -1)


def _take(x, idx):
    """x (B, R, ...) rows ``idx`` (B, M) of each sample."""
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def proposal_target_layer(batch, cfg, rand):
    """batch: "rois" (B, R, 7), "roi_labels" (B, R) 1-based, "roi_scores",
    "roi_valid", "roi_features" (B, R, C), "gt_boxes_and_cls" (B, G, 8);
    ``rand`` (B, R) uniform draws. -> the (B, M, ...) targets: the sampled
    "rois", "roi_labels", "roi_scores", "roi_features", "reg_valid_mask",
    "rcnn_cls_labels" (soft IoU labels), "gt_of_rois" (canonical)."""
    gt = batch["gt_boxes_and_cls"]
    gt_boxes, gt_labels = gt[..., :7], gt[..., -1].to(torch.int32)
    max_ov, gt_assign = max_iou_with_same_class(batch["rois"], batch["roi_labels"],
                                                gt_boxes, gt_labels)
    idx = subsample_rois(max_ov, batch["roi_valid"], cfg, rand)
    rois = _take(batch["rois"], idx)
    ious = _take(max_ov, idx)
    gts = _take(gt_boxes, _take(gt_assign, idx))
    reg_valid = (ious > cfg["REG_FG_THRESH"]).float()
    fg = ious > cfg["CLS_FG_THRESH"]
    bg = ious < cfg["CLS_BG_THRESH"]
    interval = ~fg & ~bg
    soft = (ious - cfg["CLS_BG_THRESH"]) / (cfg["CLS_FG_THRESH"] - cfg["CLS_BG_THRESH"])
    cls_labels = torch.where(interval, soft, fg.float())
    return {"rois": rois, "roi_labels": _take(batch["roi_labels"], idx),
            "roi_scores": _take(batch["roi_scores"], idx),
            "roi_features": _take(batch["roi_features"], idx),
            "reg_valid_mask": reg_valid, "rcnn_cls_labels": cls_labels,
            "gt_of_rois": canonical_targets(rois, gts), "index": idx}


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on the CPU,
    then moved: the same draws on any device): each unit kept with
    probability 1 - p and scaled by 1 / (1 - p), as ``flax.linen.Dropout``."""
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class FCStack(nn.Module):
    """``fc_k`` (Linear, no bias) -> ``bn_k`` (BatchNorm) -> ReLU [->
    Dropout] for each width, then ``out`` (Linear, bias) if
    ``out_channels``. Dropout on every layer but the last, or on the first
    only (``dp_first_only``)."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 out_channels: Optional[int] = None, dp_ratio: float = 0.0,
                 dp_first_only: bool = False):
        super().__init__()
        self.n = len(features)
        self.dp_ratio, self.dp_first_only = dp_ratio, dp_first_only
        c = in_channels
        for k, f in enumerate(features):
            setattr(self, f"fc_{k}", nn.Linear(c, f, bias=False))
            setattr(self, f"bn_{k}", BatchNorm(f))
            c = f
        self.out = nn.Linear(c, out_channels) if out_channels is not None else None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for k in range(self.n):
            x = F.relu(getattr(self, f"bn_{k}")(getattr(self, f"fc_{k}")(x)))
            use_dp = self.dp_ratio > 0 and (k == 0 if self.dp_first_only else k != self.n - 1)
            if use_dp and self.training:
                if generator is None:
                    raise ValueError("dropout in training needs a torch.Generator")
                x = dropout(x, self.dp_ratio, generator)
        return self.out(x) if self.out is not None else x


class RoIHead(nn.Module):
    """roi_features (B, M, C) -> (rcnn_cls (B, M, num_class), rcnn_reg (B, M,
    code_size)): ``shared_fc`` then ``cls_layers`` and ``reg_layers``."""

    def __init__(self, input_channels: int = 2560, model_cfg: Any = None, num_class: int = 1,
                 code_size: int = 7, test_cfg: Optional[Any] = None):
        super().__init__()
        cfg = dict(model_cfg)
        self.model_cfg, self.num_class, self.code_size = cfg, num_class, code_size
        dp = cfg.get("DP_RATIO", 0)
        shared = list(cfg["SHARED_FC"])
        self.shared_fc = FCStack(input_channels, shared, dp_ratio=dp)
        self.cls_layers = FCStack(shared[-1], cfg["CLS_FC"], out_channels=num_class,
                                  dp_ratio=dp, dp_first_only=True)
        self.reg_layers = FCStack(shared[-1], cfg["REG_FC"], out_channels=code_size,
                                  dp_ratio=dp, dp_first_only=True)

    def forward(self, roi_features, generator: Optional[torch.Generator] = None):
        b, m, c = roi_features.shape
        x = self.shared_fc(roi_features.reshape(b * m, c), generator)
        cls = self.cls_layers(x, generator)
        reg = self.reg_layers(x, generator)
        return cls.reshape(b, m, -1), reg.reshape(b, m, -1)


def roi_head_loss(rcnn_cls, rcnn_reg, targets, loss_cfg):
    """(BCE of the IoU score + fg-masked L1, {"rcnn_loss_cls",
    "rcnn_loss_reg"})."""
    w = dict(loss_cfg["LOSS_WEIGHTS"])
    labels = targets["rcnn_cls_labels"].reshape(-1)
    logits = rcnn_cls.reshape(-1)
    valid = (labels >= 0).float()
    bce = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    cls_loss = (bce * valid).sum() / valid.sum().clamp(min=1.0) * w["rcnn_cls_weight"]

    code = rcnn_reg.shape[-1]
    fg = targets["reg_valid_mask"].reshape(-1)
    reg = rcnn_reg.reshape(-1, code)
    gt = targets["gt_of_rois"][..., :code].reshape(-1, code)
    l1 = (reg - gt).abs() * torch.as_tensor(w["code_weights"], dtype=reg.dtype,
                                            device=reg.device)
    reg_loss = (l1 * fg[:, None]).sum() / fg.sum().clamp(min=1.0) * w["rcnn_reg_weight"]
    return cls_loss + reg_loss, {"rcnn_loss_cls": cls_loss, "rcnn_loss_reg": reg_loss}


def generate_predicted_boxes(rois, rcnn_reg):
    """The local deltas of ``rcnn_reg`` on the RoIs -> world boxes."""
    local = rcnn_reg + torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:]], -1)
    x, y = rotate_xy(local[..., 0], local[..., 1], rois[..., 6])
    xyz = torch.stack([x, y, local[..., 2]], -1) + rois[..., :3]
    return torch.cat([xyz, local[..., 3:]], -1)
