"""Config dict -> torch modules (counterpart of
``sparse2dense_tpu/models/builder.py:41-157``) and the weight initialisation
matching the reference's Flax initialisers."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .backbones.scn import SpMiddleResNetFHD
from .detectors.kd import KD_VoxelNet
from .detectors.voxelnet import VoxelNet
from .heads.center_head import CenterHead, SepHead
from .necks.rpn import RPN
from .necks.s2d_rpn import S2D_RPN
from .readers.pillar_encoder import VoxelFeatureExtractorV3

READERS = {"VoxelFeatureExtractorV3": VoxelFeatureExtractorV3}
BACKBONES = {"SpMiddleResNetFHD": SpMiddleResNetFHD}
NECKS = {"RPN": RPN, "S2D_RPN": S2D_RPN}
HEADS = {"CenterHead": CenterHead}
DETECTORS = {"KD_VoxelNet": KD_VoxelNet, "VoxelNet": VoxelNet}


def _plain(cfg):
    """Deep copy of a config as plain dicts, lists and tuples."""
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(_plain(v) for v in cfg)
    return cfg


def _build(cfg: dict, registry: dict, kind: str, **extra):
    # ``pretrained`` names a checkpoint; the port's weights come from
    # ``convert.from_flax`` instead
    args = {k: v for k, v in cfg.items() if k not in ("type", "logger", "pretrained")}
    if cfg["type"] not in registry:
        raise NotImplementedError(f"{kind} {cfg['type']!r} is not ported yet")
    return registry[cfg["type"]](**args, **extra)


def sparse_shape_from_voxel_cfg(voxel_generator) -> tuple:
    """(D+1, H, W) zyx grid of the sparse backbone from the voxel_generator
    config (the reference computes ``input_shape[::-1] + [1, 0, 0]``)."""
    rng = np.asarray(voxel_generator["range"], np.float64)
    vs = np.asarray(voxel_generator["voxel_size"], np.float64)
    grid = np.round((rng[3:] - rng[:3]) / vs).astype(int)  # xyz
    return (int(grid[2]) + 1, int(grid[1]), int(grid[0]))


def _trunc_normal_(t: torch.Tensor, fan_in: int, scale: float, gen: torch.Generator):
    """Flax variance_scaling(scale, "fan_in", "truncated_normal")."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisers, drawn from ``generator``: lecun-normal
    2D convs (he-normal in the head), fan-in-uniform 3D conv kernels (the
    PCR generators' too), zero biases, the heatmap output bias at
    ``init_bias``, unit BN scales."""
    head_mods = {id(m) for h in model.modules() if isinstance(h, CenterHead)
                 for m in h.modules()}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            cin = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
            _trunc_normal_(w, cin * w.shape[2] * w.shape[3],
                           2.0 if id(mod) in head_mods else 1.0, generator)
            if mod.bias is not None:
                mod.bias.zero_()
    for name, p in model.named_parameters():
        if p.dim() == 5:  # 3D conv kernels (Cout, Cin, kz, ky, kx)
            limit = math.sqrt(3.0 / p[0].numel())
            p.uniform_(-limit, limit, generator=generator)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
            mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, SepHead):
            mod.hm_out.bias.fill_(mod.init_bias)


def build_detector(cfg, test_cfg=None, voxel_generator=None, device=None,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a detector from a reference-schema model config, initialise it
    from ``generator`` (seed 0 if None) and move it to ``device`` (CUDA
    unless given) in eval mode. ``voxel_generator`` (the config's top-level
    dict) supplies the sparse grid."""
    device = resolve_device(device)
    cfg = _plain(dict(cfg))
    bb = cfg.pop("backbone")
    bb.pop("ds_factor", None)
    if voxel_generator is not None:
        bb.setdefault("sparse_shape", sparse_shape_from_voxel_cfg(voxel_generator))
    parts = dict(reader=_build(cfg.pop("reader"), READERS, "reader"),
                 backbone=_build(bb, BACKBONES, "backbone"),
                 neck=_build(cfg.pop("neck"), NECKS, "neck"),
                 bbox_head=_build(cfg.pop("bbox_head"), HEADS, "head"))
    if cfg["type"] == "KD_VoxelNet" and voxel_generator is not None:
        cfg.setdefault("pc_range_full", tuple(float(v) for v in voxel_generator["range"]))
    model = _build(cfg, DETECTORS, "detector", test_cfg=_plain(test_cfg), **parts)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(device).eval()
