"""CenterNet losses (counterpart of ``sparse2dense_tpu/models/losses/centernet.py``).

Maps are NHWC; targets are the static (B, max_objs) index / mask / class
arrays of ``AssignLabel``. Each normaliser is the global batch's
(``parallel.dist.global_sum``): under data parallelism the processes'
losses add up to the loss of their joined batch.
"""
from __future__ import annotations

import torch

from ...parallel.dist import global_sum


def gather_feat_nhwc(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Per-object vectors of an NHWC map at flat H*W indices:
    feat (B, H, W, C), ind (B, M) -> (B, M, C)."""
    b, h, w, c = feat.shape
    return torch.gather(feat.reshape(b, h * w, c), 1, ind.long()[..., None].expand(-1, -1, c))


def fast_focal_loss(out: torch.Tensor, target: torch.Tensor, ind: torch.Tensor,
                    mask: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """CornerNet-style focal loss on an already-sigmoided heatmap: out and
    target (B, H, W, C) in [0, 1], ind / mask / cat (B, M). Negatives are
    weighted by (1 - target)^4 over the whole map, positives are gathered at
    the object centres."""
    mask = mask.to(out.dtype)
    neg_loss = (torch.log(1.0 - out) * out.square() * (1.0 - target).pow(4)).sum()
    pos_pred = gather_feat_nhwc(out, ind).gather(2, cat.long()[..., None])[..., 0]
    num_pos = global_sum(mask.sum())
    pos_loss = (torch.log(pos_pred) * (1.0 - pos_pred).square() * mask).sum()
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def reg_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """Masked L1 of the map (B, H, W, D) gathered at the centres against
    target (B, M, D), per dimension, over the number of positives: (D,)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask.to(output.dtype)[..., None]
    return ((pred * m - target * m).abs() / (global_sum(m.sum()) + 1e-4)).sum((0, 1))
