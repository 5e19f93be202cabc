"""The two-stage detector (counterpart of
``sparse2dense_tpu/models/detectors/two_stage.py``; the reference's
det3d/models/detectors/two_stage.py:9-199).

The first stage is any one-stage detector (VoxelNet, KD_VoxelNet,
PointPillars, KD_PointPillars) through its ``forward_two_stage``: its
fixed-size detections (B, R) with their validity mask are the RoIs, its
BEV map the second stage's input. With ``freeze`` (every recipe) the first
stage stays in eval mode (``train()`` leaves it there), runs under
``torch.no_grad()`` and its parameters need no gradient; its one-stage loss
still adds its value to the total. The second stage gathers BEV features at
1 or 5 points a box, samples the proposal targets in training and refines
the RoIs with the RoI head. Final score ``sqrt(sigmoid(iou) *
first_score)`` (reference :134).

Randomness (the proposal sampling's uniform draws, the RoI head's dropout)
comes from ``self.generator``, a CPU ``torch.Generator`` (seed 0 at build;
assign another to reseed): the same draws on any device. A forward
may pass its own draws, ``rand`` (B, R).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ...training.train_state import mark_at
from ..roi_heads.roi_head import generate_predicted_boxes, proposal_target_layer, roi_head_loss
from ..second_stage.bev import box_centers

_VELOCITY_AFTER_YAW = [0, 1, 2, 3, 4, 5, 8, 6, 7]   # code_size 9 (reference :104-107)
_YAW_LAST = [0, 1, 2, 3, 4, 5, 7, 8, 6]
_GT_7 = [0, 1, 2, 3, 4, 5, 6, -1]


class TwoStageDetector(nn.Module):
    def __init__(self, single_det: nn.Module, second_stage: Sequence[nn.Module],
                 roi_head: nn.Module, NMS_POST_MAXSIZE: int = 500, num_point: int = 1,
                 freeze: bool = False, test_cfg: Optional[Any] = None):
        super().__init__()
        self.single_det = single_det
        self.second_stage = nn.ModuleList(second_stage)
        self.roi_head = roi_head
        self.NMS_POST_MAXSIZE, self.num_point, self.freeze = NMS_POST_MAXSIZE, num_point, freeze
        self.test_cfg = test_cfg
        self.generator = torch.Generator().manual_seed(0)
        if freeze:
            self.single_det.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze:
            self.single_det.eval()
        return self

    def forward(self, example, rand: Optional[torch.Tensor] = None,
                mark: Optional[Callable[[str], None]] = None):
        """-> {"preds": the first stage's maps, "first_boxes", "telemetry",
        "rcnn_cls" (B, M, 1), "rcnn_reg" (B, M, code_size), and "batch" (the
        RoIs, M = R) in eval or "targets" (the sampled RoIs, M =
        ROI_PER_IMAGE) in training}. ``mark`` (a timer, as the training
        step's) is called after "first_stage_maps" (the first stage's reader,
        backbone, neck and head), "first_stage_predict" (its decode and
        NMS), "bev", "targets" (training) and "roi_head"."""
        if self.freeze:
            with torch.no_grad():
                boxes, bev, preds, telemetry = self.single_det.forward_two_stage(example, mark)
        else:
            boxes, bev, preds, telemetry = self.single_det.forward_two_stage(example, mark)
        mark_at(mark, "first_stage_predict")
        box3d = boxes["box3d_lidar"]
        if self.roi_head.code_size == 9:
            box3d = box3d[..., _VELOCITY_AFTER_YAW]
        centers = box_centers(boxes["box3d_lidar"], self.num_point)
        roi_features = torch.cat([m(bev, centers, self.num_point) for m in self.second_stage],
                                 -1)
        mark_at(mark, "bev")
        batch = {"rois": box3d, "roi_labels": boxes["label_preds"].to(torch.int32) + 1,
                 "roi_scores": boxes["scores"], "roi_valid": boxes["valid"],
                 "roi_features": roi_features}
        out = {"preds": preds, "first_boxes": boxes, "telemetry": telemetry}
        if self.training:
            gt = example["gt_boxes_and_cls"]
            if self.roi_head.code_size == 7:
                gt = gt[..., _GT_7]
            batch["gt_boxes_and_cls"] = gt
            if rand is None:
                rand = torch.rand(box3d.shape[:2], generator=self.generator,
                                  device=self.generator.device)
            targets = proposal_target_layer(batch, self.roi_head.model_cfg["TARGET_CONFIG"],
                                            rand.to(box3d.device))
            mark_at(mark, "targets")
            rcnn_cls, rcnn_reg = self.roi_head(targets["roi_features"], self.generator)
            out.update(targets=targets, rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        else:
            rcnn_cls, rcnn_reg = self.roi_head(roi_features)
            out.update(batch=batch, rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        mark_at(mark, "roi_head")
        return out

    def loss(self, out, example):
        """The first stage's loss plus the RoI head's, and their logs."""
        one_stage_total, logs = self.single_det.loss(out["preds"], example)
        roi_loss, roi_logs = roi_head_loss(out["rcnn_cls"], out["rcnn_reg"], out["targets"],
                                           self.roi_head.model_cfg["LOSS_CONFIG"])
        logs = dict(logs, **roi_logs)
        return one_stage_total + roi_loss, logs

    def predict(self, out, test_cfg=None, example=None):
        """The refined fixed-size detections (reference two_stage.py:121-152);
        ``test_cfg`` and ``example`` are taken as every detector's, unused."""
        batch = out["batch"]
        boxes = generate_predicted_boxes(batch["rois"], out["rcnn_reg"])
        if boxes.shape[-1] == 9:
            boxes = boxes[..., _YAW_LAST]
        scores = torch.sqrt(torch.sigmoid(out["rcnn_cls"][..., 0]) * batch["roi_scores"])
        valid = batch["roi_valid"] & (batch["roi_labels"] != 0)
        return {"box3d_lidar": boxes,
                "scores": torch.where(valid, scores, torch.zeros_like(scores)),
                "label_preds": batch["roi_labels"] - 1, "valid": valid}
