"""Synthetic LiDAR frames: a random point cloud with planted box objects,
voxelized and padded to a static budget, with the head's targets and the
distillation streams of a training batch. A copy of the reference's
``sparse2dense_tpu/training/synthetic.py`` (CenterHead and MultiGroupHead
targets); for the same seed it yields bit-identical arrays. A nuScenes
config's frame (a CenterHead of ``dataset="nuscenes"``) goes further than
the reference's: its boxes move (non-zero velocities, drawn after the
reference's draws) and its points' last feature is a sweep's time lag;
under the test config's ``double_flip`` a frame without targets is 4 views
in the loader's layout. Beside it, ``synth_voxels``: a voxel scene with no
point cloud, for the microbenchmarks."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.pipelines.assign_label import AssignLabel
from ..data.pipelines.assign_target import AssignTarget
from ..data.pipelines.preprocess import flip_views
from ..device import resolve_device
from ..ops.voxelize import VoxelGenerator
from ..utils.config import detector_cfg


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
            class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST"), moving: bool = False):
    """(boxes (n, 9) x y z w l h vx vy yaw, 1-based classes, names); the
    velocities are 0 unless ``moving``."""
    lo = np.asarray(pc_range[:3]) * 0.6
    hi = np.asarray(pc_range[3:]) * 0.6
    centers = rng.uniform(lo, hi, size=(n_obj, 3)).astype(np.float32)
    dims = rng.uniform(1.2, 4.5, size=(n_obj, 3)).astype(np.float32)
    vel = np.zeros((n_obj, 2), np.float32)
    rot = rng.uniform(-np.pi, np.pi, size=(n_obj, 1)).astype(np.float32)
    boxes = np.concatenate([centers, dims, vel, rot], axis=1)  # 9-dof layout
    classes = rng.randint(1, len(class_names) + 1, size=n_obj)
    names = np.asarray(list(class_names))[classes - 1]
    if moving:
        boxes[:, 6:8] = rng.uniform(-4, 4, size=(n_obj, 2))
    return boxes, classes, names


NUSC_SWEEPS, NUSC_SWEEP_S = 10, 0.05   # a nuScenes frame's sweeps, 20 Hz apart


def add_time_lags(rng: np.random.RandomState, pts: np.ndarray) -> np.ndarray:
    """``pts`` with its last feature a time lag: each point from one of the
    frame's ``NUSC_SWEEPS`` sweeps, ``NUSC_SWEEP_S`` s apart."""
    pts[:, -1] = rng.randint(0, NUSC_SWEEPS, len(pts)) * np.float32(NUSC_SWEEP_S)
    return pts


NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                "motorcycle", "bicycle", "pedestrian", "traffic_cone")


def write_nusc_records(root: str, n_samples: int, n_points: int,
                       sweep_points: Optional[int] = None, n_obj: int = 8,
                       pc_range=(-54, -54, -5.0, 54, 54, 3.0)) -> str:
    """nuScenes-layout records of ``n_samples`` synthetic scenes under
    ``root``: ``samples/<s>.bin`` and ``sweeps/<s>_<k>.bin``, float32 rows of
    (x, y, z, intensity, ring), and ``infos.pkl``, the list of infos
    (``lidar_path``, ``sweeps``: ``lidar_path``, ``transform_matrix`` (4x4,
    the sweep's sensor pose in the key frame) and ``time_lag``, ``gt_boxes``
    (N, 9) x y z w l h vx vy yaw, one with NaN velocities as the devkit
    writes for a box without them, ``gt_names``, ``gt_boxes_velocity`` (N,
    3), ``token``), seeded by the sample's index. A scene is a cloud of 2 *
    ``n_points``; the key frame sees ``n_points`` of them and the k-th of
    ``NUSC_SWEEPS`` sweeps ``sweep_points`` (``n_points`` by default), with
    2 cm of range noise, from a sensor ``k * NUSC_SWEEP_S`` s earlier, the ego
    moving ~10 m/s along x. So the sweeps return from the same surfaces, as
    a lidar's do, and share voxels. Returns the infos' path."""
    import os
    import pickle

    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
    sweep_points = sweep_points or n_points
    pc_range = np.asarray(pc_range, np.float32)
    infos = []
    for s in range(n_samples):
        rng = np.random.RandomState(s)
        boxes, _, names = make_gt(rng, n_obj, pc_range, NUSC_CLASSES, moving=True)
        scene = make_points(rng, 2 * n_points, pc_range, boxes, 5)
        lidar_path = os.path.join(root, "samples", f"{s}.bin")
        key = scene[rng.choice(len(scene), n_points, replace=False)]
        key.astype(np.float32).tofile(lidar_path)
        sweeps = []
        for k in range(1, NUSC_SWEEPS + 1):
            dt = k * NUSC_SWEEP_S
            yaw = rng.uniform(-0.01, 0.01) * k
            pose = np.eye(4)
            pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
            pose[:3, 3] = [-10.0 * dt, rng.normal(0, 0.05), 0.0]
            pts = scene[rng.choice(len(scene), sweep_points, replace=False)].astype(np.float64)
            pts[:, :3] += rng.normal(0, 0.02, (sweep_points, 3))
            pts[:, :3] = (pts[:, :3] - pose[:3, 3]) @ pose[:3, :3]   # in the sweep's frame
            path = os.path.join(root, "sweeps", f"{s}_{k}.bin")
            pts.astype(np.float32).tofile(path)
            sweeps.append(dict(lidar_path=path, transform_matrix=pose, time_lag=dt))
        gt = boxes.copy()
        gt[0, 6:8] = np.nan
        infos.append(dict(lidar_path=lidar_path, sweeps=sweeps, gt_boxes=gt, gt_names=names,
                          gt_boxes_velocity=np.concatenate(
                              [gt[:, 6:8], np.zeros((len(gt), 1), np.float32)], 1),
                          token=f"sample_{s}"))
    path = os.path.join(root, "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


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

    ``with_targets`` adds the head's targets as per-task lists: the
    CenterHead's of ``AssignLabel``, "hm" (B, H, W, C), "anno_box" (B, M,
    10), "ind" and "cat" (B, M) int32, "mask" (B, M) uint8, and
    "gt_boxes_and_cls"; the MultiGroupHead's of ``AssignTarget``, "labels"
    (B, A) int32, "reg_targets" (B, A, 7), "reg_weights" (B, A). A
    MultiGroupHead batch always carries its "anchors" (B, A, 7), which the
    head decodes against (the reference's ``AssignTarget`` stage gives them
    in inference too). With ``distillation``, also the streams the reference's Voxelization stage
    makes when ``cfg.distillation`` is set: "dense_*" (the same cloud with
    extra in-box points) and "reconstruction_*{,_2,_4}" (the cloud
    voxelized at 1x, 2x and 4x the voxel size). A nuScenes config's frames
    have moving boxes and time lags; with its test config's ``double_flip``
    and no targets, the batch holds 4 * ``batch_size`` rows, each frame's
    views [orig, yflip, xflip, double] in a row."""
    device = resolve_device(device)
    vg_cfg = cfg["voxel_generator"]
    pc_range = np.asarray(vg_cfg["range"], np.float32)
    gen = VoxelGenerator(vg_cfg["voxel_size"], pc_range,
                         vg_cfg["max_points_in_voxel"], max_voxels)
    model_cfg = detector_cfg(cfg)
    if "first_stage_cfg" in model_cfg:   # a TwoStageDetector wraps the detector
        model_cfg = model_cfg["first_stage_cfg"]
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
    head_type = model_cfg["bbox_head"]["type"]
    nusc = model_cfg["bbox_head"].get("dataset") == "nuscenes"
    double_flip = nusc and not with_targets and bool(
        (cfg.get("test_cfg") or {}).get("double_flip", False))
    if with_targets and head_type not in ("CenterHead", "MultiGroupHead"):
        raise NotImplementedError(f"targets of {head_type} come with its model family, a "
                                  "later slice")
    # the anchor head decodes against the anchors, in training and inference
    anchor_head = head_type == "MultiGroupHead"
    if with_targets or anchor_head:
        assigner = (AssignTarget if anchor_head else AssignLabel)(
            cfg=cfg["train_cfg"]["assigner"])
    arrays = {(pre, suf): ([], [], []) for pre, suf, _ in streams}
    targets = []
    for i in range(batch_size):
        rng = np.random.RandomState(seed + i)
        gt_boxes, gt_classes, gt_names = make_gt(rng, n_obj, pc_range, names, moving=nusc)
        pts = make_points(rng, n_points, pc_range, gt_boxes, n_feats)
        if nusc:
            pts = add_time_lags(rng, pts)
        dense_pts = (np.concatenate([pts, make_points(rng, n_points // 2, pc_range, gt_boxes,
                                                      n_feats)], axis=0)
                     if distillation else None)
        for pre, suf, g in streams:
            clouds = [dense_pts] if pre == "dense_" else flip_views(pts) if double_flip \
                else [pts]
            for cloud in clouds:
                v, c, n = g.generate(cloud)
                for lst, a, fill in zip(arrays[pre, suf], (v, c, n), (0, -1, 0)):
                    lst.append(pad_to(a, max_voxels, fill=fill))
        if with_targets or anchor_head:
            res = {"mode": "train" if with_targets else "val", "type": "WaymoDataset",
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
    if targets:   # an anchor batch without targets holds only its anchors
        keys = (("anchors", "labels", "reg_targets", "reg_weights") if anchor_head else
                ("hm", "anno_box", "ind", "mask", "cat"))
        for key in [k for k in keys if k in targets[0]]:
            batch[key] = [put(np.stack([t[key][ti] for t in targets]))
                          for ti in range(len(targets[0][key]))]
    if with_targets and not anchor_head:
        batch["gt_boxes_and_cls"] = put(np.stack([t["gt_boxes_and_cls"] for t in targets]))
    return batch
