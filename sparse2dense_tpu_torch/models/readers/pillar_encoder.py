"""Voxel and pillar readers (counterpart of
``sparse2dense_tpu/models/readers/pillar_encoder.py``).

The pillar reader takes static-shape batched arrays: voxels (B, V, P, C)
zero-padded point features a pillar, num_points (B, V) (0: a padded
pillar), coords (B, V, 3) zyx (-1 for a padded pillar). As the reference:
the decorations of padded points are zeroed, but BatchNorm still sees those
points (its sums run over every (pillar, point) slot of the real pillars,
padded pillars left out by the mask, and are divided by the number of real
pillars, the reference's count), and the max over a pillar's points is
unmasked, so a padded point, through the linear layer, BatchNorm and ReLU,
can win it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..norm import BatchNorm


class VoxelFeatureExtractorV3(nn.Module):
    """Mean of the points of each voxel: (B, V, P, C), (B, V) -> (B, V, C)."""

    def __init__(self, num_input_features: int = 4):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
        denom = num_points.clamp(min=1).to(voxels.dtype)[..., None]
        return voxels.sum(-2) / denom


class PFNLayer(nn.Module):
    """Linear (no bias) -> BatchNorm -> ReLU -> max over the points: the last
    layer returns the max, the others concatenate it back to every point."""

    def __init__(self, cin: int, out_channels: int, last_layer: bool = False):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(cin, units, bias=False)
        self.norm = BatchNorm(units, channel_dim=-1)

    def forward(self, x: torch.Tensor, pillar_mask: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm(self.linear(x), mask=pillar_mask[..., None, None]))
        x_max = x.amax(-2, keepdim=True)     # (B, V, 1, units)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], -1)


class PillarFeatureNet(nn.Module):
    """(voxels (B, V, P, C), num_points (B, V), coords (B, V, 3) zyx) ->
    (B, V, num_filters[-1]): each point decorated with its offset from the
    pillar's point mean and from the pillar's cell centre, then the PFN
    layers."""

    def __init__(self, num_input_features: int = 4, num_filters: Sequence[int] = (64,),
                 with_distance: bool = False, voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 pc_range: Sequence[float] = (0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        cin = num_input_features + 5 + int(with_distance)
        for i, nf in enumerate(num_filters):
            last = i == len(num_filters) - 1
            setattr(self, f"pfn_{i}", PFNLayer(cin, nf, last_layer=last))
            cin = nf
        self.n_layers = len(num_filters)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        dtype = voxels.dtype
        np_clamped = num_points.clamp(min=1).to(dtype)[..., None, None]
        pillar_mask = num_points > 0
        xyz = voxels[..., :3]
        f_cluster = xyz - xyz.sum(-2, keepdim=True) / np_clamped
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        cx = coords[..., 2].to(dtype)[..., None] * vx + (vx / 2 + self.pc_range[0])
        cy = coords[..., 1].to(dtype)[..., None] * vy + (vy / 2 + self.pc_range[1])
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], -1)
        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        features = torch.cat(feats, -1)
        point_ids = torch.arange(features.shape[-2], device=features.device)
        point_mask = point_ids[None, None, :] < num_points[..., None]
        features = features * point_mask[..., None].to(dtype)
        for i in range(self.n_layers):
            features = getattr(self, f"pfn_{i}")(features, pillar_mask)
        return features[..., 0, :]
