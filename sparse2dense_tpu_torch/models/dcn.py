"""Deformable convolution v1 and the DCN heads (counterpart of
``sparse2dense_tpu/models/dcn.py``; det3d's center_head.py:25-64,112-164).

The deformable conv is written with torch ops on tensors: for every output
pixel, tap and deformable group the input is sampled bilinearly at the
offset position (four row gathers, each corner that falls outside the map
contributing zero, as the CUDA op det3d calls), and the samples of all
taps are contracted with the weights in one product. The reference does
the same with ``jnp`` gathers and one einsum a tap, outside any Pallas
kernel. Maps are NHWC at :class:`DeformConv` and :class:`FeatureAdaption`;
:class:`DCNSepHead` takes and returns NCHW, as ``SepHead`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm


def deform_sample(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, G, Cg); ys, xs (B, H, W, G, K) sample positions of every
    output pixel, group and tap -> (B, H, W, K, G, Cg) bilinear samples of
    each group's channels, a corner outside the map contributing zero."""
    b, h, w, g, cg = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    flat = x.reshape(b * h * w * g, cg)
    base = (torch.arange(b, device=x.device).view(b, 1, 1, 1, 1) * (h * w * g)
            + torch.arange(g, device=x.device).view(1, 1, 1, g, 1))

    def corner(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        rows = base + (yc * w + xc) * g
        return flat[rows] * valid[..., None].to(x.dtype)

    out = (corner(y0, x0) * (1 - wy) * (1 - wx) + corner(y0, x0 + 1) * (1 - wy) * wx
           + corner(y0 + 1, x0) * wy * (1 - wx) + corner(y0 + 1, x0 + 1) * wy * wx)
    return out.permute(0, 1, 2, 4, 3, 5)


class DeformConv(nn.Module):
    """DCN v1 with a ``kernel_size`` x ``kernel_size`` kernel and no bias:
    forward(x (B, H, W, Cin), offset (B, H, W, 2 * K * groups)) -> (B, H,
    W, Cout). The offsets are laid out as the CUDA op's: per group, per tap
    (row-major over the kernel), (dy, dx). ``weight`` is (Cout, Cin, K), so
    the reference's (K, Cin, Cout) kernel maps onto it by ``convert``'s
    rule for an ``nn.Conv`` kernel of one spatial axis."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 deformable_groups: int = 4):
        super().__init__()
        self.kernel_size, self.groups = kernel_size, deformable_groups
        self.weight = nn.Parameter(torch.empty(features, cin, kernel_size ** 2))

    def forward(self, x, offset):
        b, h, w, cin = x.shape
        k, g = self.kernel_size, self.groups
        kk = k * k
        off = offset.reshape(b, h, w, g, kk, 2)
        r = torch.arange(k, device=x.device, dtype=x.dtype) - (k - 1) // 2
        dy = r.repeat_interleave(k)   # taps row-major: (dy, dx) = (r_i, r_j)
        dx = r.repeat(k)
        rows = torch.arange(h, device=x.device, dtype=x.dtype).view(1, h, 1, 1, 1)
        cols = torch.arange(w, device=x.device, dtype=x.dtype).view(1, 1, w, 1, 1)
        ys, xs = rows + dy + off[..., 0], cols + dx + off[..., 1]
        s = deform_sample(x.reshape(b, h, w, g, cin // g), ys, xs)   # (B, H, W, K, G, Cg)
        wk = self.weight.permute(2, 1, 0).reshape(kk * cin, -1)       # (K * Cin, Cout)
        return (s.reshape(b * h * w, kk * cin) @ wk).reshape(b, h, w, -1)


class FeatureAdaption(nn.Module):
    """A 1x1 offset conv (initialised to zero), the deformable conv, ReLU;
    NHWC in and out."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 deformable_groups: int = 4):
        super().__init__()
        self.conv_offset = nn.Conv2d(cin, deformable_groups * kernel_size ** 2 * 2, 1)
        self.conv_adaption = DeformConv(cin, features, kernel_size, deformable_groups)

    def forward(self, x):
        offset = self.conv_offset(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(self.conv_adaption(x, offset))


class DCNSepHead(nn.Module):
    """Separate deformable feature adaption for the heatmap and for the
    regression maps: the heatmap through a 3x3 conv + BN + ReLU and a 3x3
    output conv (bias ``init_bias``), the others through a ``SepHead`` named
    ``task_head``. forward(x NCHW) -> {name: NCHW map}."""

    def __init__(self, cin: int, heads, num_cls: int, init_bias: float = -2.19,
                 head_conv: int = 64):
        super().__init__()
        from .heads.center_head import SepHead

        self.init_bias = init_bias
        self.feature_adapt_cls = FeatureAdaption(cin, cin)
        self.feature_adapt_reg = FeatureAdaption(cin, cin)
        self.cls_head_conv = nn.Conv2d(cin, head_conv, 3, padding=1)
        self.cls_head_bn = BatchNorm(head_conv)
        self.cls_head_out = nn.Conv2d(head_conv, num_cls, 3, padding=1)
        self.task_head = SepHead(cin, {k: v for k, v in dict(heads).items() if k != "hm"},
                                 head_conv=head_conv)

    def forward(self, x):
        nhwc = x.permute(0, 2, 3, 1)
        center = self.feature_adapt_cls(nhwc).permute(0, 3, 1, 2)
        reg = self.feature_adapt_reg(nhwc).permute(0, 3, 1, 2)
        y = F.relu(self.cls_head_bn(self.cls_head_conv(center)))
        out = self.task_head(reg)
        out["hm"] = self.cls_head_out(y)
        return out
