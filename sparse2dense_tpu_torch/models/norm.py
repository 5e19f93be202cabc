"""Normalization layers (counterpart of ``sparse2dense_tpu/models/norm.py``).

``BatchNorm`` follows the torch momentum convention the reference configs
use (momentum 0.01 is the weight of the new batch statistic) but with
eps 1e-3, not torch's 1e-5. In training mode its statistics skip rows
outside an optional validity mask, so padded voxels do not pollute them; in
eval mode it uses the running statistics. Its running statistics move once a
step: not again when a rematerialised module runs it again in the backward
(``remat.recomputing``). Under data parallelism (``parallel/dist.py``) its
training statistics are those of every process's rows (a masked SyncBN):
the sums and the count are all-reduced, with their gradient, before the
mean and variance, as the reference's cross-replica sums; a recompute runs
the collective again, and a rank with no row in its mask takes part.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.dist import all_reduce_sum, world_size
from .remat import recomputing


class BatchNorm(nn.Module):
    """Masked batch normalization over channel dim ``channel_dim``."""

    momentum = 0.01
    eps = 1e-3

    def __init__(self, num_features: int, channel_dim: int = 1):
        super().__init__()
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _shape(self, x: torch.Tensor):
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        return shape

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: x's shape with size 1 on the channel dim."""
        shape = self._shape(x)
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
            m = torch.ones_like(xf.narrow(self.channel_dim, 0, 1)) if mask is None \
                else mask.float()
            cnt = m.sum()
            s = (xf * m).sum(axes)
            s2 = (xf.square() * m).sum(axes)
            if world_size() > 1:   # SyncBN: the statistics of every rank's rows
                c = s.shape[0]
                stats = all_reduce_sum(torch.cat([s, s2, cnt.reshape(1)]))
                s, s2, cnt = stats[:c], stats[c:2 * c], stats[2 * c]
            cnt = cnt.clamp(min=1.0)
            mean = s / cnt
            var = (s2 / cnt - mean.square()).clamp(min=0.0)
            if not recomputing():  # one update a step, from the forward
                with torch.no_grad():  # torch updates running_var unbiased
                    unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = ((x.to(mean.dtype) - mean.view(shape)) * inv.view(shape) * self.weight.view(shape)
             + self.bias.view(shape))
        return y.to(x.dtype)


class LayerNorm2d(nn.Module):
    """Per-position LayerNorm over the channels of an NCHW map, eps 1e-6 (the
    ConvNeXt-standard form the reference uses)."""

    eps = 1e-6

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(1, keepdim=True)
        var = (x - mean).square().mean(1, keepdim=True)
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight[:, None, None]
                + self.bias[:, None, None])
