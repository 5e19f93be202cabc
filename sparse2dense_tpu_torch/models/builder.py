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
from .backbones.scatter import PointPillarsScatter, PointPillarsScatter_S2D
from .backbones.scn import SpMiddleFHD, SpMiddleResNetFHD
from .detectors.kd import KD_PointPillars, KD_VoxelNet
from .detectors.point_pillars import PointPillars
from .detectors.two_stage import TwoStageDetector
from .detectors.voxelnet import VoxelNet
from .dcn import DCNSepHead, DeformConv, FeatureAdaption
from .heads.center_head import CenterHead, SepHead
from .heads.mg_head import MultiGroupHead
from .necks.rpn import RPN
from .necks.s2d_rpn import S2D_RPN
from .readers.pillar_encoder import PillarFeatureNet, VoxelFeatureExtractorV3
from .roi_heads.roi_head import FCStack, RoIHead
from .second_stage.bev import BEVFeatureExtractor

READERS = {"VoxelFeatureExtractorV3": VoxelFeatureExtractorV3,
           "PillarFeatureNet": PillarFeatureNet}
BACKBONES = {"SpMiddleResNetFHD": SpMiddleResNetFHD, "SpMiddleFHD": SpMiddleFHD,
             "PointPillarsScatter": PointPillarsScatter,
             "PointPillarsScatter_S2D": PointPillarsScatter_S2D}
NECKS = {"RPN": RPN, "S2D_RPN": S2D_RPN}
HEADS = {"CenterHead": CenterHead, "MultiGroupHead": MultiGroupHead}
DETECTORS = {"KD_VoxelNet": KD_VoxelNet, "VoxelNet": VoxelNet,
             "PointPillars": PointPillars, "KD_PointPillars": KD_PointPillars}
SECOND_STAGE = {"BEVFeatureExtractor": BEVFeatureExtractor}
ROI_HEADS = {"RoIHead": RoIHead}


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


def pillar_grid_from_reader_cfg(reader) -> tuple:
    """(ny, nx) BEV grid of a pillar scatter from its reader's voxel size
    and range."""
    vs, pr = reader["voxel_size"], reader["pc_range"]
    return (int(round((pr[4] - pr[1]) / vs[1])), int(round((pr[3] - pr[0]) / vs[0])))


def _trunc_normal_(t: torch.Tensor, fan_in: int, scale: float, gen: torch.Generator):
    """Flax variance_scaling(scale, "fan_in", "truncated_normal")."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisers, drawn from ``generator``: lecun-normal
    2D convs (he-normal in the CenterHead's SepHeads and deformable convs)
    and linear layers, fan-in-uniform 3D conv kernels (the PCR generators'
    too), zero biases, zero offset convs, the heatmap output bias at
    ``init_bias``, unit BN scales; the RoI head's out layers
    normal(0.001)."""
    head_mods = {id(m) for h in model.modules() if isinstance(h, CenterHead)
                 for m in h.modules()}
    head_mods -= {id(m) for d in model.modules() if isinstance(d, DCNSepHead)
                  for m in (d.cls_head_conv, d.cls_head_out)}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            cin = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
            _trunc_normal_(w, cin * w.shape[2] * w.shape[3],
                           2.0 if id(mod) in head_mods else 1.0, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            _trunc_normal_(mod.weight, mod.weight.shape[1], 1.0, generator)
        elif isinstance(mod, DeformConv):   # (Cout, Cin, K)
            _trunc_normal_(mod.weight, mod.weight[0].numel(), 2.0, generator)
    for name, p in model.named_parameters():
        if p.dim() == 5:  # 3D conv kernels (Cout, Cin, kz, ky, kx)
            limit = math.sqrt(3.0 / p[0].numel())
            p.uniform_(-limit, limit, generator=generator)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
            mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, SepHead) and hasattr(mod, "hm_out"):
            mod.hm_out.bias.fill_(mod.init_bias)
        if isinstance(mod, DCNSepHead):
            mod.cls_head_out.bias.fill_(mod.init_bias)
        if isinstance(mod, FeatureAdaption):
            mod.conv_offset.weight.zero_()
        if isinstance(mod, FCStack) and mod.out is not None:
            mod.out.weight.normal_(0.0, 0.001, generator=generator)
            mod.out.bias.zero_()


def build_detector(cfg, test_cfg=None, voxel_generator=None, device=None,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a detector from a reference-schema model config, initialise it
    from ``generator`` (seed 0 if None) and move it to ``device`` (CUDA
    unless given) in eval mode. ``voxel_generator`` (the config's top-level
    dict) supplies the sparse grid; a pillar scatter takes its grid and width
    from the reader's config. A ``TwoStageDetector`` wraps the detector of
    its ``first_stage_cfg``; every ``pretrained`` is ignored, as in the JAX
    package (weights come from ``tools/convert_checkpoint.py`` and
    ``--load_from`` / ``--checkpoint``)."""
    device = resolve_device(device)
    model = _detector(_plain(dict(cfg)), _plain(test_cfg), voxel_generator)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def _detector(cfg: dict, test_cfg, voxel_generator) -> nn.Module:
    if cfg["type"] == "TwoStageDetector":
        single = _detector(cfg.pop("first_stage_cfg"), test_cfg, voxel_generator)
        second = [_build(m, SECOND_STAGE, "second stage")
                  for m in cfg.pop("second_stage_modules")]
        roi_head = _build(cfg.pop("roi_head"), ROI_HEADS, "RoI head")
        return _build(cfg, {"TwoStageDetector": TwoStageDetector}, "detector",
                      single_det=single, second_stage=second, roi_head=roi_head,
                      test_cfg=test_cfg)
    bb = cfg.pop("backbone")
    bb.pop("ds_factor", None)
    if bb["type"].startswith("PointPillarsScatter"):
        bb.setdefault("grid_shape", pillar_grid_from_reader_cfg(cfg["reader"]))
        bb.setdefault("num_input_features", cfg["reader"].get("num_filters", [64])[-1])
    elif voxel_generator is not None:
        bb.setdefault("sparse_shape", sparse_shape_from_voxel_cfg(voxel_generator))
    backbone = _build(bb, BACKBONES, "backbone")
    # the neck takes the backbone's BEV width (Flax infers it from the input;
    # some reference-schema configs state another)
    neck = dict(cfg.pop("neck"), num_input_features=backbone.bev_channels)
    parts = dict(reader=_build(cfg.pop("reader"), READERS, "reader"), backbone=backbone,
                 neck=_build(neck, NECKS, "neck"),
                 bbox_head=_build(cfg.pop("bbox_head"), HEADS, "head"))
    if cfg["type"] in ("KD_VoxelNet", "KD_PointPillars") and voxel_generator is not None:
        cfg.setdefault("pc_range_full", tuple(float(v) for v in voxel_generator["range"]))
    return _build(cfg, DETECTORS, "detector", test_cfg=test_cfg, **parts)
