"""VoxelNet, the dense teacher (counterpart of
``sparse2dense_tpu/models/detectors/voxelnet.py:28-108``): reader -> sparse
backbone -> RPN -> CenterHead, or SECOND's MultiGroupHead (anchors).

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

from ...training.train_state import Mark, mark_at
from ..heads.center_head import center_head_loss, center_head_predict
from ..heads.mg_head import MultiGroupHead, mg_head_loss, mg_head_predict


def detach_preds(preds):
    """The head's per-task map dicts, detached."""
    return [{k: v.detach() for k, v in pd.items()} for pd in preds]


def head_maps(out):
    """The head's per-task map dicts of ``out``: the forward's output (its
    "preds") or those maps themselves."""
    return out["preds"] if isinstance(out, dict) and "preds" in out else out


def two_stage_boxes(detector, preds, example, mark: Mark):
    """A first stage's fixed-size detections of its detached ``preds``;
    ``mark`` is called with "first_stage_maps" before the decode and NMS."""
    mark_at(mark, "first_stage_maps")
    return detector.predict(detach_preds(preds), example=example)


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

    def forward_two_stage(self, example, mark: Mark = None):
        """The first stage of a ``TwoStageDetector`` (the sparse stream) ->
        (the fixed-size detections of the detached preds, the neck's BEV map
        (NHWC), the preds, the backbone's counters); ``mark`` as
        ``two_stage_boxes``'."""
        f_a, _, telemetry = self._bev(example, "")
        x = self.neck(f_a)
        preds = self.bbox_head(x)
        return two_stage_boxes(self, preds, example, mark), x, preds, telemetry

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
