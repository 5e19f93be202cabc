"""Pillar scatters: pillar features -> a dense BEV canvas, NHWC (counterpart
of ``sparse2dense_tpu/models/backbones/scatter.py``).

``PointPillarsScatter`` is the canvas alone. ``PointPillarsScatter_S2D`` is
the Sparse2Dense student's: the canvas, densified (max-pool 2x2, encoders,
three ConvNeXt blocks, decoders, nearest resizes back to the grid) and fused
with the sparse canvas; in training its PCR generators (1x1x1 3D convs over
a depth-1 volume, GELU) give point offsets and occupancy logits at the full
grid, NCDHW with D = 1. Its modules keep the reference's flat names.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..necks.s2d_rpn import Conv3dBNAct, ConvBNGelu, ConvNeXtBlock, gelu
from ..norm import BatchNorm


def scatter_to_bev(features: torch.Tensor, coords: torch.Tensor, ny: int,
                   nx: int) -> torch.Tensor:
    """features (B, V, C), coords (B, V, 3) zyx -> (B, ny, nx, C). A padded
    pillar (any coordinate < 0) goes to a spare row ny*nx, cut off after:
    -1 would name the last cell. The voxelizer never puts two pillars in
    one cell, so the assignment is a plain index copy, which autograd sees."""
    b, v, c = features.shape
    flat = coords[..., 1].long() * nx + coords[..., 2].long()
    flat = torch.where((coords < 0).any(-1), ny * nx, flat)
    flat = flat + torch.arange(b, device=flat.device)[:, None] * (ny * nx + 1)
    canvas = features.new_zeros(b * (ny * nx + 1), c)
    canvas = canvas.index_put((flat.reshape(-1),), features.reshape(-1, c))
    return canvas.view(b, ny * nx + 1, c)[:, :ny * nx].reshape(b, ny, nx, c)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """NCHW nearest resize as ``jax.image.resize(..., "nearest")``: the
    source pixel of output i is floor((i + 0.5) * in / out), torch's
    "nearest-exact" (its "nearest", floor(i * in / out), differs at
    59 -> 117 in 29 of 117 rows)."""
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class PointPillarsScatter(nn.Module):
    """(pillar features (B, V, C), coords (B, V, 3)) -> canvas (B, ny, nx, C)."""

    def __init__(self, num_input_features: int = 64, grid_shape: Sequence[int] = (468, 468)):
        super().__init__()
        self.num_input_features = num_input_features
        self.grid_shape = tuple(grid_shape)

    @property
    def bev_channels(self) -> int:
        return self.num_input_features

    def forward(self, voxel_features, coords):
        return scatter_to_bev(voxel_features, coords, *self.grid_shape)


class PointPillarsScatter_S2D(nn.Module):
    """(pillar features, coords) -> (F_S_a, F_S_b, gen_offset, gen_mask):
    F_S_a and F_S_b (B, ny, nx, 64) NHWC, gen_offset (B, 3, 1, ny, nx) and
    gen_mask (B, 1, 1, ny, nx) NCDHW in training, None in eval."""

    def __init__(self, num_input_features: int = 64, grid_shape: Sequence[int] = (468, 468)):
        super().__init__()
        c_in = num_input_features
        self.grid_shape = tuple(grid_shape)
        self.encoder_1a = ConvBNGelu(c_in, 32, kernel=1, padding=0)
        self.encoder_1b = ConvBNGelu(32, 32, kernel=2, stride=2, padding=0)
        self.encoder_1c = ConvBNGelu(32, 128, kernel=1, padding=0)
        self.encoder_2a = ConvBNGelu(128, 128, stride=2)
        self.encoder_2b = ConvBNGelu(128, 256)
        self.convnext_1 = ConvNeXtBlock(256)
        self.convnext_2 = ConvNeXtBlock(256)
        self.convnext_3 = ConvNeXtBlock(256)
        self.decoder_1 = ConvBNGelu(256, 128)
        self.decoder_2a = ConvBNGelu(256, 64)
        self.decoder_2b_conv = nn.ConvTranspose2d(64, 64, 4, 2, 1)
        self.decoder_2b_norm = BatchNorm(64)
        self.decoder_2c = ConvBNGelu(64, 64, kernel=1, padding=0)
        self.fusion_dense = ConvBNGelu(64, 64, kernel=1, padding=0)
        self.fusion_sparse = ConvBNGelu(c_in, 64, kernel=1, padding=0)
        self.generator_a = Conv3dBNAct(64, 32, act="gelu")
        self.generator_b = Conv3dBNAct(32, 16, act="gelu")
        self.gen_out = nn.Conv3d(16, 3, 1)
        self.gen_mask_a = Conv3dBNAct(16, 8, act="gelu")
        self.gen_mask_b = nn.Conv3d(8, 1, 1)

    @property
    def bev_channels(self) -> int:
        return 64

    def forward(self, voxel_features, coords):
        ny, nx = self.grid_shape
        canvas = scatter_to_bev(voxel_features, coords, ny, nx).permute(0, 3, 1, 2)
        y = F.max_pool2d(canvas, 2, 2)
        y1 = self.encoder_1c(self.encoder_1b(self.encoder_1a(y)))
        y2 = self.encoder_2b(self.encoder_2a(y1))
        att = self.convnext_1(y2) + y2
        att = self.convnext_2(att) + att
        att = self.convnext_3(att) + att
        d1 = resize_nearest(self.decoder_1(att), y1.shape[2:])
        d2 = self.decoder_2a(torch.cat([d1, y1], 1))
        d2 = gelu(self.decoder_2b_norm(self.decoder_2b_conv(d2)))
        f_s_b = resize_nearest(self.decoder_2c(d2), (ny, nx))
        f_s_a = self.fusion_dense(f_s_b) + self.fusion_sparse(canvas)
        gen_offset = gen_mask = None
        if self.training:
            gen = self.generator_b(self.generator_a(f_s_b[:, :, None]))
            gen_offset = self.gen_out(gen)
            gen_mask = self.gen_mask_b(self.gen_mask_a(gen))
        return f_s_a.permute(0, 2, 3, 1), f_s_b.permute(0, 2, 3, 1), gen_offset, gen_mask
