"""MultiGroupHead, the SECOND anchor head (counterpart of
``sparse2dense_tpu/models/heads/mg_head.py``; det3d's mg_head.py):

- per task, 1x1 convs for the box deltas, the class logits and (with
  ``loss_aux``) the direction logits; maps NHWC at the public functions;
- :func:`mg_head_loss`: sigmoid focal classification, codewise smooth-L1
  box regression with the sin-difference angle encoding and the softmax
  direction classifier, normalised by the number of positives, over the
  global batch (every process holds a batch of one size);
- :func:`mg_head_predict`: the box coder's decode against the example's
  anchors, the direction flip, the score and range mask, top-k and rotated
  NMS (the ``use_rotate_nms=True, use_multi_class_nms=False`` path of every
  shipped SECOND config), with static output shapes and a validity mask.

Targets come from ``data/pipelines/assign_target.AssignTarget``, per task:
labels (B, A) int32 (-1 ignore, 0 background, else the class), reg_targets
(B, A, code) and anchors (B, A, nd), anchors in (y, x, anchor) order as the
NHWC maps are.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coder import GroundBox3dCoder, build_box_coder
from ...ops.nms import rotated_nms
from ...ops.topk import top_k
from ...parallel.dist import world_size
from ..losses.second_losses import sigmoid_focal_loss, weighted_smooth_l1, weighted_softmax_ce
from .center_head import _gather


def add_sin_difference(boxes1, boxes2):
    """The angle channel of each set as sin(a - b)'s two products."""
    rad_pred = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad_tg = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    return (torch.cat([boxes1[..., :-1], rad_pred], -1),
            torch.cat([boxes2[..., :-1], rad_tg], -1))


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def get_direction_target(anchors, reg_targets, dir_offset=0.0):
    """One-hot (B, A, 2) direction targets of the gt angle."""
    rot_gt = reg_targets[..., -1] + anchors[..., -1]
    cls = (limit_period(rot_gt - dir_offset, 0.5, 2 * math.pi) > 0).long()
    return F.one_hot(cls, 2).to(reg_targets.dtype)


class MultiGroupHead(nn.Module):
    """forward(x NHWC) -> per task {"box_preds", "cls_preds"[,
    "dir_cls_preds"]} NHWC maps, (num_anchor_per_loc * width) channels.
    ``box_coder`` is a ``GroundBox3dCoder`` or its config dict."""

    def __init__(self, mode: str = "3d", in_channels: int = 128, tasks: Sequence[Any] = (),
                 weights: Sequence[float] = (1,), box_coder: Any = None,
                 encode_background_as_zeros: bool = True, loss_norm: Any = None,
                 loss_cls: Any = None, use_sigmoid_score: bool = True, loss_bbox: Any = None,
                 encode_rad_error_by_sin: bool = True, loss_aux: Any = None,
                 direction_offset: float = 0.0, norm_cfg: Any = None):
        super().__init__()
        self.tasks = tuple(dict(t) for t in tasks)
        self.box_coder = (box_coder if isinstance(box_coder, GroundBox3dCoder)
                          else build_box_coder(box_coder))
        self.encode_background_as_zeros = encode_background_as_zeros
        self.loss_norm, self.loss_cls = dict(loss_norm or {}), dict(loss_cls or {})
        self.loss_bbox = dict(loss_bbox or {})
        self.loss_aux = dict(loss_aux) if loss_aux is not None else None
        self.encode_rad_error_by_sin = encode_rad_error_by_sin
        self.direction_offset = direction_offset
        code_size = self.box_coder.code_size
        for t, (num_c, num_a) in enumerate(zip(self.num_classes, self.num_anchor_per_locs)):
            num_cls = num_a * (num_c if encode_background_as_zeros else num_c + 1)
            setattr(self, f"task_{t}_conv_box", nn.Conv2d(in_channels, num_a * code_size, 1))
            setattr(self, f"task_{t}_conv_cls", nn.Conv2d(in_channels, num_cls, 1))
            if self.use_direction_classifier:
                setattr(self, f"task_{t}_conv_dir", nn.Conv2d(in_channels, num_a * 2, 1))

    @property
    def num_classes(self):
        return [len(t["class_names"]) for t in self.tasks]

    @property
    def num_anchor_per_locs(self):
        return [2 * n for n in self.num_classes]   # 2 rotations a class

    @property
    def use_direction_classifier(self):
        return self.loss_aux is not None

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        outs = [("box_preds", "box"), ("cls_preds", "cls")]
        if self.use_direction_classifier:
            outs.append(("dir_cls_preds", "dir"))
        return [{key: getattr(self, f"task_{t}_conv_{conv}")(x).permute(0, 2, 3, 1)
                 for key, conv in outs} for t in range(len(self.tasks))]


def prepare_loss_weights(labels, pos_cls_weight=1.0, neg_cls_weight=1.0):
    """NormByNumPositives: (cls weights, reg weights, cared), each over (B, A)."""
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = negatives.float() * neg_cls_weight + positives.float() * pos_cls_weight
    reg_weights = positives.float()
    pos_normalizer = positives.sum(1, keepdim=True).float().clamp(min=1.0)
    return cls_weights / pos_normalizer, reg_weights / pos_normalizer, cared


def mg_head_loss(head: MultiGroupHead, preds, example):
    """Total loss over the tasks and its per-task logs."""
    code_size = head.box_coder.code_size
    total, logs = 0.0, {}
    for task_id, pd in enumerate(preds):
        num_class = head.num_classes[task_id]
        labels = example["labels"][task_id]
        reg_targets = example["reg_targets"][task_id]
        anchors = example["anchors"][task_id]
        b = labels.shape[0]
        b_global = b * world_size()
        box_preds = pd["box_preds"].reshape(b, -1, code_size)
        cls_preds = pd["cls_preds"].reshape(b, -1, num_class)
        cls_weights, reg_weights, cared = prepare_loss_weights(
            labels, pos_cls_weight=head.loss_norm.get("pos_cls_weight", 1.0),
            neg_cls_weight=head.loss_norm.get("neg_cls_weight", 1.0))
        cls_targets = labels * cared.to(labels.dtype)
        one_hot = F.one_hot(cls_targets.long(), num_class + 1)[..., 1:].to(cls_preds.dtype)
        bp, rt = box_preds, reg_targets
        if head.encode_rad_error_by_sin:
            bp, rt = add_sin_difference(bp, rt)
        loc_loss = weighted_smooth_l1(bp, rt, reg_weights,
                                      sigma=head.loss_bbox.get("sigma", 3.0),
                                      code_weights=head.loss_bbox.get("code_weights"))
        cls_loss = sigmoid_focal_loss(cls_preds, one_hot, cls_weights,
                                      alpha=head.loss_cls.get("alpha", 0.25),
                                      gamma=head.loss_cls.get("gamma", 2.0))
        loc_reduced = loc_loss.sum() / b_global * head.loss_bbox.get("loss_weight", 1.0)
        cls_reduced = cls_loss.sum() / b_global * head.loss_cls.get("loss_weight", 1.0)
        task_loss = loc_reduced + cls_reduced
        if head.use_direction_classifier:
            dir_targets = get_direction_target(anchors, reg_targets, head.direction_offset)
            dir_logits = pd["dir_cls_preds"].reshape(b, -1, 2)
            w = (labels > 0).float()
            w = w / w.sum(-1, keepdim=True).clamp(min=1.0)
            dir_loss = weighted_softmax_ce(dir_logits, dir_targets, w).sum() / b_global
            task_loss = task_loss + dir_loss * head.loss_aux.get("loss_weight", 0.2)
            logs[f"dir_loss_{task_id}"] = dir_loss
        total = total + task_loss
        logs[f"cls_loss_{task_id}"] = cls_reduced
        logs[f"loc_loss_{task_id}"] = loc_reduced
    return total, logs


def mg_head_predict(head: MultiGroupHead, preds, example, test_cfg):
    """Decode and rotated NMS of every task, concatenated with per-task
    label offsets: (B, post_max * tasks, ...) tensors and "valid"."""
    nms_cfg = test_cfg["nms"]
    pre_max, post_max = int(nms_cfg["nms_pre_max_size"]), int(nms_cfg["nms_post_max_size"])
    iou_thr = float(nms_cfg["nms_iou_threshold"])
    code_size = head.box_coder.code_size
    rets, flag = [], 0
    for task_id, pd in enumerate(preds):
        num_class = head.num_classes[task_id]
        anchors = example["anchors"][task_id]
        b = anchors.shape[0]
        box_preds = pd["box_preds"].reshape(b, -1, code_size)
        cls_preds = pd["cls_preds"].reshape(b, -1, num_class)
        boxes = head.box_coder.decode(box_preds, anchors, xp=torch)   # (B, A, nd)
        if head.use_direction_classifier:
            dir_labels = pd["dir_cls_preds"].reshape(b, -1, 2).argmax(-1)
            opp = (boxes[..., -1] - head.direction_offset > 0) ^ dir_labels.bool()
            rot = boxes[..., -1] + torch.where(opp, math.pi, 0.0)
            boxes = torch.cat([boxes[..., :-1], rot[..., None]], -1)
        scores, labels = torch.sigmoid(cls_preds).max(-1)
        pcr = torch.tensor(test_cfg["post_center_limit_range"], dtype=boxes.dtype,
                           device=boxes.device)
        in_range = (boxes[..., :3] >= pcr[:3]).all(-1) & (boxes[..., :3] <= pcr[3:]).all(-1)
        valid = (scores >= test_cfg["score_threshold"]) & in_range
        masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        top_scores, top_idx = top_k(masked, min(pre_max, masked.shape[-1]))
        top_boxes = _gather(boxes, top_idx)
        top_labels = _gather(labels, top_idx)
        bev = top_boxes[..., [0, 1, 3, 4, -1]]
        sel = torch.stack([rotated_nms(bx, s, iou_thr, post_max)
                           for bx, s in zip(bev, top_scores)]).long()
        sel_safe = sel.clamp(min=0)
        out_scores = _gather(top_scores, sel_safe)
        out_valid = (sel >= 0) & torch.isfinite(out_scores)
        rets.append({
            "box3d_lidar": _gather(top_boxes, sel_safe),
            "scores": torch.where(sel >= 0, out_scores, torch.zeros_like(out_scores)),
            "label_preds": _gather(top_labels, sel_safe) + flag,
            "valid": out_valid,
        })
        flag += num_class
    return {k: torch.cat([r[k] for r in rets], 1)
            for k in ("box3d_lidar", "scores", "label_preds", "valid")}
