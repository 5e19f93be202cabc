"""Synthetic LiDAR frames: a random point cloud with planted box objects,
voxelized and padded to a static budget, with the CenterHead targets and the
distillation streams of a training batch. A copy of the reference's
``sparse2dense_tpu/training/synthetic.py`` (CenterHead targets only); for the
same seed it yields bit-identical arrays. Beside it, ``synth_voxels``: a
voxel scene with no point cloud, for the microbenchmarks."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.pipelines.assign_label import AssignLabel
from ..device import resolve_device
from ..ops.voxelize import VoxelGenerator


def pad_to(a: np.ndarray, n: int, fill=0):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    m = min(len(a), n)
    out[:m] = a[:m]
    return out


def make_points(rng: np.random.RandomState, n_points: int, pc_range,
                gt_boxes: Optional[np.ndarray] = None, n_feats: int = 5):
    """LiDAR-like cloud: ground-plane beam rings, surface clusters with
    vertical extent, a small isolated-return fraction, and a clump of points
    inside each box of ``gt_boxes``."""
    lo = np.asarray(pc_range[:3])
    hi = np.asarray(pc_range[3:])
    r_max = float(min(hi[0], hi[1])) * 0.98
    h = -float(lo[2]) * 0.95  # sensor height above the ground plane
    n_g = int(n_points * 0.55)
    n_c = int(n_points * 0.40)
    n_s = n_points - n_g - n_c
    parts = []
    # ground rings from 48 downward beams
    els = np.linspace(np.deg2rad(-18.0), np.deg2rad(-0.5), 48)
    per = max(n_g // 48, 1)
    for el in els:
        r = min(h / np.tan(-el), r_max)
        az = rng.uniform(-np.pi, np.pi, per)
        rr = r * (1 + rng.normal(0, 0.02, per))
        parts.append(np.stack([rr * np.cos(az), rr * np.sin(az),
                               -h + rng.normal(0, 0.04, per)], 1))
    # object / wall / vegetation clusters with vertical extent
    k = 140
    cth = rng.uniform(-np.pi, np.pi, k)
    cr = np.sqrt(rng.uniform(0.01, 1, k)) * r_max * 0.95
    per_c = max(n_c // k, 1)
    for i in range(k):
        sx = rng.uniform(0.5, 4.0)
        sy = rng.uniform(0.5, 4.0)
        sz = rng.uniform(0.5, 2.2)
        parts.append(np.stack(
            [cr[i] * np.cos(cth[i]) + rng.normal(0, sx, per_c),
             cr[i] * np.sin(cth[i]) + rng.normal(0, sy, per_c),
             rng.uniform(-h, -h + sz, per_c)], 1))
    # isolated returns (canopy, noise)
    th = rng.uniform(-np.pi, np.pi, n_s)
    r = np.sqrt(rng.uniform(0.01, 1, n_s)) * r_max * 0.95
    parts.append(np.stack([r * np.cos(th), r * np.sin(th),
                           rng.uniform(lo[2] * 0.75, hi[2] * 0.95, n_s)], 1))
    pts = np.concatenate(parts)[:n_points].astype(np.float32)
    pts = np.clip(pts, lo + 1e-3, hi - 1e-3)
    extra = rng.uniform(0, 1, size=(len(pts), n_feats - 3)).astype(np.float32)
    pts = np.concatenate([pts, extra], axis=1)
    if gt_boxes is not None:
        clumps = []
        for b in gt_boxes:
            c = b[:3] + rng.normal(0, 0.2, size=(64, 3)) * b[3:6] * 0.25
            clumps.append(np.concatenate(
                [c.astype(np.float32),
                 rng.uniform(0, 1, size=(64, n_feats - 3)).astype(np.float32)],
                axis=1))
        pts = np.concatenate([pts] + clumps, axis=0)
    return pts


def make_gt(rng: np.random.RandomState, n_obj: int, pc_range,
            class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST")):
    lo = np.asarray(pc_range[:3]) * 0.6
    hi = np.asarray(pc_range[3:]) * 0.6
    centers = rng.uniform(lo, hi, size=(n_obj, 3)).astype(np.float32)
    dims = rng.uniform(1.2, 4.5, size=(n_obj, 3)).astype(np.float32)
    vel = np.zeros((n_obj, 2), np.float32)
    rot = rng.uniform(-np.pi, np.pi, size=(n_obj, 1)).astype(np.float32)
    boxes = np.concatenate([centers, dims, vel, rot], axis=1)  # 9-dof layout
    classes = rng.randint(1, len(class_names) + 1, size=n_obj)
    names = np.asarray(list(class_names))[classes - 1]
    return boxes, classes, names


def synth_voxels(v: int, seed: int = 0):
    """Roughly Waymo-shaped synthetic scene for the microbenchmarks: points
    concentrated near the ego on a ground plane and objects, so BEV occupancy
    clusters like real scans. A copy of ``synth_voxels`` of the reference's
    ``sparse2dense_tpu/tools/profile_model.py``: for the same seed it yields
    the same arrays. Returns (features (1, v, 5) float32, coords (1, v, 3)
    zyx int32 on the 41x1504x1504 grid, -1 padding past the occupied
    voxels)."""
    rng = np.random.RandomState(seed)
    n = v * 2
    r = np.abs(rng.gamma(2.0, 12.0, n)).clip(0, 74)  # radial falloff
    th = rng.uniform(-np.pi, np.pi, n)
    x, y = r * np.cos(th), r * np.sin(th)
    z = rng.choice([0.0, 1.0], n, p=[0.7, 0.3]) * rng.uniform(0, 2.5, n) \
        + rng.normal(0, 0.2, n)
    pts = np.stack([x, y, z], -1)
    grid = np.floor((pts - np.array([-75.2, -75.2, -2.0])) /
                    np.array([0.1, 0.1, 0.15])).astype(np.int64)
    ok = ((grid >= 0).all(1) & (grid < np.array([1504, 1504, 41])).all(1))
    grid = grid[ok]
    lin = (grid[:, 2] * 1504 + grid[:, 1]) * 1504 + grid[:, 0]
    _, first = np.unique(lin, return_index=True)
    grid = grid[np.sort(first)][:v]
    coords = grid[:, [2, 1, 0]].astype(np.int32)  # zyx
    nv = len(coords)
    coords = np.pad(coords, ((0, v - nv), (0, 0)), constant_values=-1)
    feats = rng.randn(v, 5).astype(np.float32)
    feats[nv:] = 0
    return feats[None], coords[None]


def make_batch(cfg, batch_size: int, max_voxels: int, seed: int = 0,
               n_points: int = 4000, n_obj: int = 8, device=None,
               with_targets: bool = False, distillation: bool = False):
    """Static-shape batch from a reference-schema config, on ``device``
    (CUDA unless given): "voxels" (B, V, P, C), "coordinates" (B, V, 3) zyx
    int32 with -1 padding, "num_points" (B, V) int32.

    ``with_targets`` adds the CenterHead targets of ``AssignLabel`` as
    per-task lists: "hm" (B, H, W, C), "anno_box" (B, M, 10), "ind" and
    "cat" (B, M) int32, "mask" (B, M) uint8, and "gt_boxes_and_cls". With
    ``distillation``, also the streams the reference's Voxelization stage
    makes when ``cfg.distillation`` is set: "dense_*" (the same cloud with
    extra in-box points) and "reconstruction_*{,_2,_4}" (the cloud
    voxelized at 1x, 2x and 4x the voxel size)."""
    device = resolve_device(device)
    vg_cfg = cfg["voxel_generator"]
    pc_range = np.asarray(vg_cfg["range"], np.float32)
    gen = VoxelGenerator(vg_cfg["voxel_size"], pc_range,
                         vg_cfg["max_points_in_voxel"], max_voxels)
    model_cfg = cfg["S_model"]
    n_feats = model_cfg["reader"].get("num_input_features", 5)
    names = tuple(cfg.get("class_names") or ("VEHICLE", "PEDESTRIAN", "CYCLIST"))
    # (key prefix, key suffix, voxel generator) of each stream
    streams = [("", "", gen)]
    if distillation:
        streams += [("dense_", "", gen)] + [
            ("reconstruction_", tag, VoxelGenerator([v * mult for v in vg_cfg["voxel_size"]],
                                                    pc_range, vg_cfg["max_points_in_voxel"],
                                                    max_voxels))
            for tag, mult in (("", 1), ("_2", 2), ("_4", 4))]
    if with_targets:
        if model_cfg["bbox_head"]["type"] != "CenterHead":
            raise NotImplementedError(
                f"targets of {model_cfg['bbox_head']['type']} come with the other model "
                "families, a later slice")
        assigner = AssignLabel(cfg=cfg["train_cfg"]["assigner"])
    arrays = {(pre, suf): ([], [], []) for pre, suf, _ in streams}
    targets = []
    for i in range(batch_size):
        rng = np.random.RandomState(seed + i)
        gt_boxes, gt_classes, gt_names = make_gt(rng, n_obj, pc_range, names)
        pts = make_points(rng, n_points, pc_range, gt_boxes, n_feats)
        dense_pts = (np.concatenate([pts, make_points(rng, n_points // 2, pc_range, gt_boxes,
                                                      n_feats)], axis=0)
                     if distillation else None)
        for pre, suf, g in streams:
            v, c, n = g.generate(dense_pts if pre == "dense_" else pts)
            for lst, a, fill in zip(arrays[pre, suf], (v, c, n), (0, -1, 0)):
                lst.append(pad_to(a, max_voxels, fill=fill))
        if with_targets:
            res = {"mode": "train", "type": "WaymoDataset",
                   "lidar": {"voxels": {"shape": gen.grid_size, "range": pc_range,
                                        "size": np.asarray(vg_cfg["voxel_size"], np.float32)},
                             "annotations": {"gt_boxes": gt_boxes, "gt_classes": gt_classes,
                                             "gt_names": gt_names}}}
            targets.append(assigner(res, None)[0]["lidar"]["targets"])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = {f"{pre}{part}{suf}": put(np.stack(lst))
             for (pre, suf), lists in arrays.items()
             for part, lst in zip(("voxels", "coordinates", "num_points"), lists)}
    if with_targets:
        for key in ("hm", "anno_box", "ind", "mask", "cat"):
            batch[key] = [put(np.stack([t[key][ti] for t in targets]))
                          for ti in range(len(targets[0]["hm"]))]
        batch["gt_boxes_and_cls"] = put(np.stack([t["gt_boxes_and_cls"] for t in targets]))
    return batch
