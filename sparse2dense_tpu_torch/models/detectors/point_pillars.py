"""PointPillars, the pillar family's dense teacher (counterpart of
``sparse2dense_tpu/models/detectors/point_pillars.py:20-100``): pillar
reader -> scatter to the BEV canvas -> RPN -> CenterHead.

It reads the ``dense_*`` stream when the example has one; ``f_a`` is the
BEV canvas (NHWC, before the neck), and with ``return_recon_feature`` the
reader and scatter run again on the ``reconstruction_*`` stream for
``f_b``: the same dict as ``VoxelNet.forward``, so the distillation step
serves both teachers alike. Loss and predict are VoxelNet's.
"""
from __future__ import annotations

from .voxelnet import VoxelNet


class PointPillars(VoxelNet):
    def _bev(self, example, prefix: str):
        coords = example[prefix + "coordinates"]
        feats = self.reader(example[prefix + "voxels"], example[prefix + "num_points"], coords)
        return self.backbone(feats, coords), None, {}
