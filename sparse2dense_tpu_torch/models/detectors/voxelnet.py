"""VoxelNet, the dense teacher (counterpart of
``sparse2dense_tpu/models/detectors/voxelnet.py:28-108``): reader -> sparse
backbone -> RPN -> CenterHead.

When the example carries the ``dense_*`` stream (a teacher trained on, or
distilling from, the densified cloud), the detector reads it instead of the
sparse one. ``f_a`` is the backbone's BEV map (NHWC, before the neck); with
``return_recon_feature`` the reader and backbone run again, with the same
weights, on the ``reconstruction_*`` stream, and ``f_b`` is that BEV map.
The distillation step reads both.
"""
from __future__ import annotations

from typing import Any, Optional

from torch import nn

from ..heads.center_head import center_head_loss, center_head_predict


class VoxelNet(nn.Module):
    def __init__(self, reader: nn.Module, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, test_cfg: Optional[Any] = None):
        super().__init__()
        self.reader, self.backbone, self.neck, self.bbox_head = reader, backbone, neck, bbox_head
        self.test_cfg = test_cfg

    def _bev(self, example, prefix: str):
        feats = self.reader(example[prefix + "voxels"], example[prefix + "num_points"])
        return self.backbone(feats, example[prefix + "coordinates"])

    def forward(self, example, return_recon_feature: bool = False):
        """-> {"preds": per-task NHWC map dicts, "f_a": the BEV map, "f_b":
        the reconstruction stream's BEV map or None, "telemetry": the
        backbone's counters of the main stream}."""
        f_a, _, telemetry = self._bev(example, "dense_" if "dense_voxels" in example else "")
        f_b = self._bev(example, "reconstruction_")[0] if return_recon_feature else None
        return {"preds": self.bbox_head(self.neck(f_a)), "f_a": f_a, "f_b": f_b,
                "telemetry": telemetry}

    def loss(self, preds, example):
        return center_head_loss(preds, example, weight=self.bbox_head.weight,
                                code_weights=self.bbox_head.code_weights)

    def predict(self, preds, test_cfg=None):
        if isinstance(preds, dict) and "preds" in preds:
            preds = preds["preds"]
        cfg = test_cfg if test_cfg is not None else self.test_cfg
        return center_head_predict(preds, cfg, self.bbox_head.num_classes)
