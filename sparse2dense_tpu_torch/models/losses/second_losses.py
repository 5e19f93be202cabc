"""The SECOND anchor head's losses (counterpart of
``sparse2dense_tpu/models/losses/second_losses.py``; det3d's losses.py):
per-anchor losses weighted by the given weights, reduced by the head."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(preds, targets, weights, alpha=0.25, gamma=2.0):
    """preds / targets: (B, A, C) logits / one-hot; weights (B, A).
    Returns the (B, A, C) weighted focal loss."""
    per_entry_ce = preds.clamp(min=0) - preds * targets + torch.log1p(torch.exp(-preds.abs()))
    p = torch.sigmoid(preds)
    p_t = targets * p + (1 - targets) * (1 - p)
    modulating = torch.pow(1.0 - p_t, gamma)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    return per_entry_ce * modulating * alpha_w * weights[..., None]


def weighted_smooth_l1(preds, targets, weights, sigma=3.0, code_weights=None):
    """preds / targets: (B, A, D); weights (B, A). Returns (B, A, D)."""
    sigma2 = sigma ** 2
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    abs_diff = diff.abs()
    loss = torch.where(abs_diff < 1.0 / sigma2, 0.5 * sigma2 * diff.square(),
                       abs_diff - 0.5 / sigma2)
    return loss * weights[..., None]


def weighted_softmax_ce(logits, targets, weights):
    """logits (B, A, C), one-hot targets (B, A, C), weights (B, A) ->
    (B, A) weighted cross-entropy."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1) * weights
