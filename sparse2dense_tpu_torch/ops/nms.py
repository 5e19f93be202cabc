"""Greedy rotated NMS and circle NMS with static output shapes (counterpart
of ``sparse2dense_tpu/ops/nms.py``).

Blocked greedy, exact: each round takes the top ``_BLOCK`` alive candidates,
resolves them against each other with a short sequential pass, then lets the
kept ones suppress the whole field with one (BLOCK, K) overlap matrix. It
reproduces classic greedy NMS in ~K/BLOCK rounds. The round loop and the
in-block pass run on the host (the in-block pass on a 64x64 matrix copied
there); the matrices are computed on the tensors' device.
"""
from __future__ import annotations

import torch

from .nms_suppression import suppression_matrix
from .topk import top_k

_BLOCK = 64


def _greedy_within_block(valid: torch.Tensor, sup_cc: torch.Tensor) -> torch.Tensor:
    """keep[i] = valid[i] and no earlier kept candidate suppresses i."""
    v = valid.tolist()
    sup = sup_cc.tolist()
    keep = []
    for i in range(len(v)):
        keep.append(v[i] and not any(keep[j] and sup[j][i] for j in range(i)))
    return torch.tensor(keep, dtype=torch.bool, device=valid.device)


def _blocked_nms(boxes, scores, suppress, post_max_size: int) -> torch.Tensor:
    """boxes (K, D); padded entries carry score -inf. suppress(cand (B, D),
    all (K, D)) -> (B, K) bool. Returns (post_max_size,) int32, -1 padded."""
    k = boxes.shape[0]
    block = min(_BLOCK, k)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    max_rounds = -(-k // block)  # each round resolves a full block
    alive = scores > neg_inf
    kept = torch.zeros(k, dtype=torch.bool, device=scores.device)
    count = rounds = 0
    while count < post_max_size and rounds < max_rounds and bool(alive.any()):
        top_s, top_i = top_k(torch.where(alive, scores, neg_inf), block)
        cand_valid = top_s > neg_inf
        cand_boxes = boxes[top_i]
        keep_c = _greedy_within_block(cand_valid, suppress(cand_boxes, cand_boxes))
        kept[top_i[keep_c]] = True
        alive[top_i[cand_valid]] = False
        killed = (suppress(cand_boxes, boxes) & keep_c[:, None]).any(0)
        alive &= ~killed
        count += int(keep_c.sum())
        rounds += 1
    sel_scores, sel = top_k(torch.where(kept, scores, neg_inf), min(post_max_size, k))
    sel = torch.where(sel_scores > neg_inf, sel, -1).to(torch.int32)
    if sel.shape[0] < post_max_size:
        sel = torch.cat([sel, sel.new_full((post_max_size - sel.shape[0],), -1)])
    return sel


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                post_max_size: int) -> torch.Tensor:
    """Greedy rotated-BEV NMS. boxes (K, 5) (cx, cy, dx, dy, heading); padded
    entries carry score -inf. Returns (post_max_size,) int32, -1 padded."""
    return _blocked_nms(boxes, scores,
                        lambda c, o: suppression_matrix(c, o, iou_threshold),
                        post_max_size)


def circle_nms(centers: torch.Tensor, scores: torch.Tensor, min_radius: float,
               post_max_size: int) -> torch.Tensor:
    """Greedy centre-distance NMS: a kept candidate suppresses every other
    whose BEV centre lies strictly within ``min_radius`` of its own.
    centers (K, 2); padded entries carry score -inf. Returns
    (post_max_size,) int32, -1 padded."""
    thresh2 = torch.tensor(min_radius, dtype=centers.dtype, device=centers.device) ** 2

    def suppress(cand, others):
        return ((cand[:, None, :] - others[None, :, :]) ** 2).sum(-1) < thresh2

    return _blocked_nms(centers, scores, suppress, post_max_size)
