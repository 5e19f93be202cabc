"""RPN neck (counterpart of ``sparse2dense_tpu/models/necks/rpn.py``): a
multi-scale conv trunk, transpose-conv upsampling and a channel concat.
Public forward takes and returns NHWC; the layers run NCHW."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..norm import BatchNorm


class ConvBNReLU(nn.Module):
    """conv (no bias) + BN + ReLU; ``transpose`` is a k=s VALID ConvTranspose."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, use_bias: bool = False, transpose: bool = False):
        super().__init__()
        if transpose:
            self.conv = nn.ConvTranspose2d(cin, features, kernel, stride, bias=use_bias)
        else:
            self.conv = nn.Conv2d(cin, features, kernel, stride, padding, bias=use_bias)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class RPNBlock(nn.Module):
    def __init__(self, cin: int, features: int, num_layers: int, stride: int):
        super().__init__()
        self.num_layers = num_layers
        self.down = ConvBNReLU(cin, features, stride=stride)
        for j in range(num_layers):
            setattr(self, f"conv_{j}", ConvBNReLU(features, features))

    def forward(self, x):
        x = self.down(x)
        for j in range(self.num_layers):
            x = getattr(self, f"conv_{j}")(x)
        return x


class RPNDeblock(nn.Module):
    def __init__(self, cin: int, features: int, stride: float):
        super().__init__()
        if stride >= 1:
            s = int(stride)
            self.up = (ConvBNReLU(cin, features, kernel=s, stride=s, transpose=True) if s > 1
                       else ConvBNReLU(cin, features, kernel=1, stride=1, padding=0))
        else:
            s = int(round(1 / stride))
            self.up = ConvBNReLU(cin, features, kernel=s, stride=s, padding=0)

    def forward(self, x):
        return self.up(x)


class RPN(nn.Module):
    def __init__(self, layer_nums: Sequence[int] = (3, 5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2, 2),
                 ds_num_filters: Sequence[int] = (64, 128, 256),
                 us_layer_strides: Sequence[float] = (1, 2, 4),
                 us_num_filters: Sequence[int] = (128, 128, 128),
                 num_input_features: int = 64):
        super().__init__()
        self.n_blocks = len(layer_nums)
        self.upsample_start = len(layer_nums) - len(us_layer_strides)
        self.num_input_features = num_input_features
        cin = num_input_features
        for i, n in enumerate(layer_nums):
            setattr(self, f"block_{i}", RPNBlock(cin, ds_num_filters[i], n, ds_layer_strides[i]))
            cin = ds_num_filters[i]
            j = i - self.upsample_start
            if j >= 0:
                setattr(self, f"deblock_{j}",
                        RPNDeblock(cin, us_num_filters[j], us_layer_strides[j]))

    def trunk_and_ups(self, x):
        """NCHW trunk; returns (concat of the upsampled branches, stages)."""
        ups, stages = [], []
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
            stages.append(x)
            j = i - self.upsample_start
            if j >= 0:
                ups.append(getattr(self, f"deblock_{j}")(x))
        return (torch.cat(ups, 1) if ups else x), stages

    def forward(self, x):
        # a bf16 BEV map (SECOND's dense stages keep bf16 to the end) meets
        # float32 weights: float32, as Flax's type promotion in the conv
        x = x.permute(0, 3, 1, 2)
        out, _ = self.trunk_and_ups(x.to(torch.promote_types(x.dtype, torch.float32)))
        return out.permute(0, 2, 3, 1)
