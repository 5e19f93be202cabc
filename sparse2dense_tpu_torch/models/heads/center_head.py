"""CenterPoint head, decode and post-processing (counterpart of
``sparse2dense_tpu/models/heads/center_head.py``). Maps are NHWC at the
public functions; the convs run NCHW. Outputs have static shapes with a
validity mask instead of ragged tensors. With ``dcn_head`` each task's
head is a ``DCNSepHead`` (``models/dcn.py``); with the test config's
``double_flip`` the batch holds 4 views a frame, and predict merges each
group's maps before the decode (:func:`merge_double_flip`)."""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import circle_nms, rotated_nms
from ...ops.topk import top_k
from ..dcn import DCNSepHead
from ..losses.centernet import fast_focal_loss, reg_loss
from ..norm import BatchNorm


class SepHead(nn.Module):
    """Per-task separated heads: name -> (out_channels, num_conv), each a
    stack of 3x3 conv (64 channels) + BN + ReLU and an output 3x3 conv, all
    convs with bias."""

    def __init__(self, cin: int, heads, init_bias: float = -2.19, head_conv: int = 64):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        self.init_bias = init_bias
        for head, (classes, num_conv) in self.heads:
            c = cin
            for i in range(num_conv - 1):
                setattr(self, f"{head}_conv_{i}", nn.Conv2d(c, head_conv, 3, padding=1))
                setattr(self, f"{head}_bn_{i}", BatchNorm(head_conv))
                c = head_conv
            setattr(self, f"{head}_out", nn.Conv2d(c, classes, 3, padding=1))

    def forward(self, x):
        out = {}
        for head, (_, num_conv) in self.heads:
            y = x
            for i in range(num_conv - 1):
                y = F.relu(getattr(self, f"{head}_bn_{i}")(getattr(self, f"{head}_conv_{i}")(y)))
            out[head] = getattr(self, f"{head}_out")(y)
        return out


class CenterHead(nn.Module):
    """Shared 3x3 conv + BN + ReLU, then one SepHead per task.
    forward(x NHWC) -> [per-task dict of NHWC maps]."""

    def __init__(self, in_channels: int = 128, tasks: Sequence[Any] = (),
                 dataset: str = "waymo", weight: float = 0.25,
                 code_weights: Sequence[float] = (), common_heads: Any = None,
                 init_bias: float = -2.19, share_conv_channel: int = 64,
                 num_hm_conv: int = 2, dcn_head: bool = False):
        super().__init__()
        self.tasks = tuple(dict(t) for t in tasks)
        self.dataset, self.weight, self.code_weights = dataset, weight, tuple(code_weights)
        self.shared_conv = nn.Conv2d(in_channels, share_conv_channel, 3, padding=1)
        self.shared_bn = BatchNorm(share_conv_channel)
        for t, num_cls in enumerate(self.num_classes):
            heads = dict(common_heads)
            heads["hm"] = (num_cls, num_hm_conv)
            if dcn_head:
                head = DCNSepHead(share_conv_channel, heads, num_cls, init_bias=init_bias)
            else:
                head = SepHead(share_conv_channel, heads, init_bias=init_bias)
            setattr(self, f"task_{t}", head)

    @property
    def num_classes(self):
        return [len(t["class_names"]) for t in self.tasks]

    def forward(self, x):
        x = F.relu(self.shared_bn(self.shared_conv(x.permute(0, 3, 1, 2))))
        return [{k: v.permute(0, 2, 3, 1) for k, v in getattr(self, f"task_{t}")(x).items()}
                for t in range(len(self.tasks))]


def _clip_sigmoid(x):
    return torch.sigmoid(x).clamp(1e-4, 1 - 1e-4)


def center_head_loss(preds, example, *, weight, code_weights):
    """Total CenterHead loss over the tasks and its per-task logs:
    FastFocal on the heatmap plus ``weight`` times the code-weighted L1 of
    the box maps at the centres. ``example`` holds per-task lists of hm
    (B, H, W, C), anno_box (B, M, 10), ind / mask / cat (B, M)."""
    total, logs = 0.0, {}
    for task_id, pd in enumerate(preds):
        ind, mask = example["ind"][task_id], example["mask"][task_id]
        hm_loss = fast_focal_loss(_clip_sigmoid(pd["hm"]), example["hm"][task_id], ind, mask,
                                  example["cat"][task_id])
        target_box = example["anno_box"][task_id]
        names = ("reg", "height", "dim", "vel", "rot") if "vel" in pd else \
            ("reg", "height", "dim", "rot")
        if "vel" not in pd:   # drop the velocity targets
            target_box = target_box[..., [0, 1, 2, 3, 4, 5, 8, 9]]
        box_loss = reg_loss(torch.cat([pd[k] for k in names], -1), mask, ind, target_box)
        cw = torch.tensor(code_weights[:box_loss.shape[0]], dtype=box_loss.dtype,
                          device=box_loss.device)
        loc_loss = (box_loss * cw).sum()
        total = total + (hm_loss + weight * loc_loss)
        logs[f"hm_loss_{task_id}"] = hm_loss
        logs[f"loc_loss_{task_id}"] = loc_loss
    return total, logs


def decode_preds(pd, test_cfg):
    """One task's NHWC maps -> ((B, H*W, 7) world boxes, (B, H*W, C) scores)."""
    hm = torch.sigmoid(pd["hm"])
    b, h, w, num_cls = hm.shape
    dims = torch.exp(pd["dim"]).reshape(b, h * w, 3)
    rot = torch.atan2(pd["rot"][..., 0:1], pd["rot"][..., 1:2]).reshape(b, h * w, 1)
    reg = pd["reg"].reshape(b, h * w, 2)
    hei = pd["height"].reshape(b, h * w, 1)
    ys, xs = torch.meshgrid(torch.arange(h, device=hm.device),
                            torch.arange(w, device=hm.device), indexing="ij")
    xs = xs.reshape(1, h * w, 1).to(hm.dtype) + reg[..., 0:1]
    ys = ys.reshape(1, h * w, 1).to(hm.dtype) + reg[..., 1:2]
    osf, vs, pc = test_cfg["out_size_factor"], test_cfg["voxel_size"], test_cfg["pc_range"]
    xs = xs * osf * vs[0] + pc[0]
    ys = ys * osf * vs[1] + pc[1]
    if "vel" in pd:
        vel = pd["vel"].reshape(b, h * w, 2)
        boxes = torch.cat([xs, ys, hei, dims, vel, rot], -1)
    else:
        boxes = torch.cat([xs, ys, hei, dims, rot], -1)
    return boxes, hm.reshape(b, h * w, num_cls)


def _gather(x, idx):
    """take_along_axis on dim 1 for (B, N, ...) x and (B, M) idx."""
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def post_process_task(boxes, hm, test_cfg, task_id):
    """Score/range mask, top-k to ``nms_pre_max_size`` and rotated NMS (or,
    with ``circular_nms``, circle NMS at the task's ``min_radius``) for one
    task; dict of (B, post_max, ...) tensors plus a validity mask."""
    nms_cfg = test_cfg["nms"]
    pre_max, post_max = int(nms_cfg["nms_pre_max_size"]), int(nms_cfg["nms_post_max_size"])
    iou_thr = float(nms_cfg["nms_iou_threshold"])
    pcr = torch.tensor(test_cfg["post_center_limit_range"], dtype=boxes.dtype,
                       device=boxes.device)
    scores, labels = hm.max(-1)
    in_range = ((boxes[..., :3] >= pcr[:3]).all(-1) & (boxes[..., :3] <= pcr[3:]).all(-1))
    valid = (scores > test_cfg["score_threshold"]) & in_range
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = top_k(masked, min(pre_max, masked.shape[-1]))
    top_boxes = _gather(boxes, top_idx)
    top_labels = _gather(labels, top_idx)
    bev = top_boxes[..., [0, 1, 3, 4, -1]]  # cx cy dx dy yaw
    if test_cfg.get("circular_nms", False):
        min_radius = test_cfg["min_radius"][task_id]
        sel = torch.stack([circle_nms(bx[:, :2], s, min_radius, post_max)
                           for bx, s in zip(bev, top_scores)]).long()
    else:
        sel = torch.stack([rotated_nms(bx, s, iou_thr, post_max)
                           for bx, s in zip(bev, top_scores)]).long()
    sel_safe = sel.clamp(min=0)
    out_scores = _gather(top_scores, sel_safe)
    out_valid = (sel >= 0) & torch.isfinite(out_scores)
    return {
        "box3d_lidar": _gather(top_boxes, sel_safe),
        "scores": torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
        "label_preds": _gather(top_labels, sel_safe),
        "valid": out_valid,
    }


def merge_double_flip(pd):
    """One task's NHWC maps over a batch in groups of 4 views [orig, yflip,
    xflip, double] -> the maps of the B/4 frames: each view un-flipped (H
    for the y flip, W for the x flip), the signs of its reg, rot (sin, cos)
    and vel fixed, the four averaged."""
    g = {}
    for k, v in pd.items():
        b4, h, w, c = v.shape
        v = v.reshape(b4 // 4, 4, h, w, c)
        g[k] = torch.stack([v[:, 0], v[:, 1].flip(1), v[:, 2].flip(2), v[:, 3].flip(1, 2)], 1)
    out = {k: g[k].mean(1) for k in ("hm", "height", "dim")}
    reg = g["reg"].clone()
    reg[:, 1, ..., 1] = 1 - reg[:, 1, ..., 1]
    reg[:, 2, ..., 0] = 1 - reg[:, 2, ..., 0]
    reg[:, 3, ..., 0] = 1 - reg[:, 3, ..., 0]
    reg[:, 3, ..., 1] = 1 - reg[:, 3, ..., 1]
    out["reg"] = reg.mean(1)
    # the signs of each view's (sin, cos) of the yaw, and of its (vx, vy)
    sign = torch.tensor([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype=g["rot"].dtype,
                        device=g["rot"].device).view(1, 4, 1, 1, 2)
    for k in ("rot", "vel"):
        if k in g:
            out[k] = (g[k] * sign).mean(1)
    return out


def center_head_predict(preds, test_cfg, num_classes):
    """All tasks: decode + NMS (after :func:`merge_double_flip` with the
    config's ``double_flip``), concatenated with per-task label offsets."""
    rets, flag = [], 0
    for task_id, pd in enumerate(preds):
        if test_cfg.get("double_flip", False):
            pd = merge_double_flip(pd)
        boxes, hm = decode_preds(pd, test_cfg)
        r = post_process_task(boxes, hm, test_cfg, task_id)
        r["label_preds"] = r["label_preds"] + flag
        flag += num_classes[task_id]
        rets.append(r)
    return {k: torch.cat([r[k] for r in rets], 1)
            for k in ("box3d_lidar", "scores", "label_preds", "valid")}
