"""Local detection mAP (host side): the port's copy of
``sparse2dense_tpu/core/eval.py`` (det3d's KITTI-protocol evaluation,
datasets/utils/eval.py:61-367). A class's detections are matched greedily,
by score, to the ground truth at a BEV rotated-IoU threshold
(``ops/rotated_iou.py`` on host tensors), and AP is the 40-point
interpolated average precision; APH weighs each true positive by its
heading accuracy (the Waymo protocol). The official Waymo metrics come from
its devkit, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.rotated_iou import rotated_iou_matrix


def _bev_iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) rotated BEV IoU (float32)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    a = torch.from_numpy(np.ascontiguousarray(boxes_a[:, [0, 1, 3, 4, 6]], np.float32))
    b = torch.from_numpy(np.ascontiguousarray(boxes_b[:, [0, 1, 3, 4, 6]], np.float32))
    return rotated_iou_matrix(a, b).numpy()


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray, n_points=40) -> float:
    """N-point interpolated AP (KITTI R40)."""
    ap = 0.0
    for t in np.linspace(0, 1, n_points):
        mask = recall >= t
        ap += (precision[mask].max() if mask.any() else 0.0) / n_points
    return float(ap)


def heading_weight(dt_yaw: float, gt_yaw: float) -> float:
    """Waymo APH's heading weight: 1 - |wrapped yaw error| / pi."""
    d = abs(float(dt_yaw) - float(gt_yaw)) % (2 * np.pi)
    d = min(d, 2 * np.pi - d)
    return max(0.0, 1.0 - d / np.pi)


def evaluate_class(gt_list: List[np.ndarray], dt_list: List[np.ndarray],
                   dt_scores: List[np.ndarray], iou_thresh: float) -> dict:
    """Per-frame gt (Ni, 7) and dt (Mi, 7) with scores -> AP and APH at one
    IoU threshold. APH's true positives count by their heading weight in
    both precision and recall; false positives count whole."""
    total_gt = sum(len(g) for g in gt_list)
    records = []  # (score, is_tp, heading_weight)
    for gt, dt, scores in zip(gt_list, dt_list, dt_scores):
        order = np.argsort(-scores)
        dt, scores = dt[order], scores[order]
        iou = _bev_iou_matrix(dt, gt)
        taken = np.zeros(len(gt), bool)
        for i in range(len(dt)):
            if len(gt):
                j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                if iou[i, j] >= iou_thresh and not taken[j]:
                    taken[j] = True
                    records.append((scores[i], True, heading_weight(dt[i, -1], gt[j, -1])))
                    continue
            records.append((scores[i], False, 0.0))
    if not records or total_gt == 0:
        return {"ap": 0.0, "aph": 0.0, "recall": 0.0, "precision": 0.0, "num_gt": total_gt}
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([not r[1] for r in records])
    tpw = np.cumsum([r[2] for r in records])
    recall = tp / total_gt
    precision = tp / np.maximum(tp + fp, 1)
    recall_h = tpw / total_gt
    precision_h = tpw / np.maximum(tp + fp, 1)
    return {"ap": _ap_from_pr(recall, precision), "aph": _ap_from_pr(recall_h, precision_h),
            "recall": float(recall[-1]), "precision": float(precision[-1]), "num_gt": total_gt}


DEFAULT_IOU = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}


def evaluate_detections(gts: Dict[str, dict], detections: Dict[str, dict],
                        class_names: Sequence[str],
                        iou_thresholds: Dict[str, float] = None) -> dict:
    """gts: token -> {gt_boxes, gt_classes (1-based)}; detections: token ->
    {box3d_lidar, label_preds (0-based), scores}. Returns {class: {ap, aph,
    recall, precision, num_gt}, "mAP": mean AP}."""
    iou_thresholds = iou_thresholds or DEFAULT_IOU
    out = {}
    aps = []
    for ci, name in enumerate(class_names):
        gt_list, dt_list, sc_list = [], [], []
        for token, gt in gts.items():
            g_boxes = np.asarray(gt["gt_boxes"])
            g = g_boxes[np.asarray(gt["gt_classes"]) == ci + 1]
            gt_list.append(g[:, [0, 1, 2, 3, 4, 5, -1]] if g.size else
                           np.zeros((0, 7), np.float32))
            det = detections.get(token, {})
            d_boxes = np.asarray(det.get("box3d_lidar", np.zeros((0, 7))))
            d_lab = np.asarray(det.get("label_preds", np.zeros((0,), int)))
            d_sc = np.asarray(det.get("scores", np.zeros((0,))))
            sel = d_lab == ci
            d = d_boxes[sel]
            dt_list.append(d[:, [0, 1, 2, 3, 4, 5, -1]] if d.size else
                           np.zeros((0, 7), np.float32))
            sc_list.append(d_sc[sel])
        res = evaluate_class(gt_list, dt_list, sc_list, iou_thresholds.get(name, 0.5))
        out[name] = res
        aps.append(res["ap"])
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    return out
