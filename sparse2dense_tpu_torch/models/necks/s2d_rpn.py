"""S2D_RPN (counterpart of ``sparse2dense_tpu/models/necks/s2d_rpn.py``).

The S2D module densifies the BEV map (encoders, three ConvNeXt blocks,
decoders) and fuses it with the sparse input; the RPN trunk then runs on the
fused map. In training the PCR generators also run: a 1x1 conv to 640
channels read as a 5-deep (128, 5, H, W) volume, then 1x1x1 convs and 2x
transposed 3D convs to occupancy logits and point offsets at 1/4 and 1/2 of
the grid, in NCDHW. The reference keeps them z-folded, (B, H, W, D*C) with
channel d*C + c, a TPU layout; this is the operator it computes.

Flax's ``nn.gelu`` defaults to the tanh approximation, hence
``approximate="tanh"`` everywhere here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..norm import BatchNorm, LayerNorm2d
from .rpn import RPN


def gelu(x):
    return F.gelu(x, approximate="tanh")


class ConvBNGelu(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, padding)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return gelu(self.norm(self.conv(x)))


class ConvTBNGelu(nn.Module):
    """2x upsampling ConvTranspose k4/s2/p1 (flax k4/s2 SAME) + BN + GELU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, features, 4, 2, 1)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return gelu(self.norm(self.conv(x)))


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 -> LayerNorm -> 1x1 4x expand -> GELU -> 1x1 project."""

    def __init__(self, features: int):
        super().__init__()
        self.dwconv = nn.Conv2d(features, features, 7, padding=3, groups=features)
        self.norm = LayerNorm2d(features)
        self.pw1 = nn.Conv2d(features, 4 * features, 1)
        self.pw2 = nn.Conv2d(4 * features, features, 1)

    def forward(self, x):
        return self.pw2(gelu(self.pw1(self.norm(self.dwconv(x)))))


class Conv3dBNRelu(nn.Module):
    """1x1x1 Conv3d + BN + ReLU (the reference's ``Conv3dBNAct``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, 1)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class ConvT3dBNRelu(nn.Module):
    """2x upsampling ConvTranspose3d k4/s2/p1 (flax k4/s2 SAME) + BN + ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, features, 4, 2, 1)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class S2D_RPN(RPN):
    """forward(x NHWC) -> (rpn_out, gen_offset_2, gen_mask_2, gen_offset_4,
    gen_mask_4, F_S_a, F_S_b): rpn_out and F_S_* NHWC; the PCR outputs NCDHW
    in training (offsets 3 channels, mask logits 1; depth 20 and 10 at 1/2
    and 1/4 of the grid), None in eval."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        c_in = self.num_input_features
        self.encoder_1a = ConvBNGelu(c_in, 256, kernel=2, stride=2, padding=0)
        self.encoder_1b = ConvBNGelu(256, 256)
        self.encoder_2a = ConvBNGelu(256, 256, stride=2)
        self.encoder_2b = ConvBNGelu(256, 256)
        self.convnext_1 = ConvNeXtBlock(256)
        self.convnext_2 = ConvNeXtBlock(256)
        self.convnext_3 = ConvNeXtBlock(256)
        self.decoder_1 = ConvTBNGelu(256, 256)
        self.decoder_2a = ConvBNGelu(512, 256)
        self.decoder_2b = ConvTBNGelu(256, c_in)
        self.fusion_dense = ConvBNGelu(c_in, c_in, kernel=1, padding=0)
        self.fusion_sparse = ConvBNGelu(c_in, c_in, kernel=1, padding=0)
        self.out_conv = ConvBNGelu(c_in, 640, kernel=1, padding=0)
        self.generator_1a = Conv3dBNRelu(128, 32)
        self.generator_1b = ConvT3dBNRelu(32, 32)
        self.gen_out_4 = nn.Conv3d(32, 3, 1)
        self.gen_mask_4 = nn.Conv3d(32, 1, 1)
        self.generator_2a = Conv3dBNRelu(32, 16)
        self.generator_2b = ConvT3dBNRelu(16, 3)
        self.gen_out_2 = nn.Conv3d(3, 3, 1)
        self.gen_mask_2 = nn.Conv3d(3, 1, 1)

    def _pcr(self, f_s_b):
        """PCR generators on F_S_b (NCHW) -> (gen_offset_2, gen_mask_2,
        gen_offset_4, gen_mask_4), NCDHW."""
        gen = self.out_conv(f_s_b)
        n, _, h, w = gen.shape
        gen = self.generator_1b(self.generator_1a(gen.view(n, 128, 5, h, w)))
        offset_4, mask_4 = self.gen_out_4(gen), self.gen_mask_4(gen)
        gen = self.generator_2b(self.generator_2a(gen))
        return self.gen_out_2(gen), self.gen_mask_2(gen), offset_4, mask_4

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        y1 = self.encoder_1b(self.encoder_1a(x))
        y2 = self.encoder_2b(self.encoder_2a(y1))
        att = self.convnext_1(y2) + y2
        att = self.convnext_2(att) + att
        att = gelu(self.convnext_3(att) + att)
        y3 = torch.cat([self.decoder_1(att), y1], 1)
        f_s_b = self.decoder_2b(self.decoder_2a(y3))
        f_s_a = self.fusion_dense(f_s_b) + self.fusion_sparse(x)
        gens = self._pcr(f_s_b) if self.training else (None,) * 4
        out, _ = self.trunk_and_ups(f_s_a)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return (nhwc(out),) + gens + (nhwc(f_s_a), nhwc(f_s_b))
