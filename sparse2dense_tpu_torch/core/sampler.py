"""The GT-AUG database sampler and the dense object sets (host side): the
port's copy of ``sparse2dense_tpu/core/sampler.py`` (det3d's
DataBaseSamplerV2, core/sampler/sample_ops.py:49-430, and its BatchSampler
and filters, core/sampler/preprocess.py:19-105). Class-balanced sampling of
per-object point clouds from a gt database, pruned by a BEV collision test
against the scene's boxes, and, for distillation, the dense object set of
each pasted object as ``recon_points``.

One difference of state, not of draws: the reference's per-class samplers
shuffle once when built and keep their position from sample to sample in
one process. Here :meth:`DataBaseSamplerV2.sample_all` takes the sample's
own ``np.random.RandomState`` and starts every sample from a fresh shuffle
drawn from it (the classes in the database's order, as the reference's
constructor draws them), so a sample does not depend on the input worker
that made it or on what that worker made before. For a generator in the
same state it returns what the reference's sampler, built just then,
returns. Group sampling (multi-object groups) is not implemented, as in the
reference: no shipped Sparse2Dense config uses it.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

from . import box_np_ops
from .augment import box_collision_test, rotation_points_single_angle


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def pad_box_dims(boxes: np.ndarray, nd: int) -> np.ndarray:
    """Align 7-dof db boxes with a 9-dof (velocity-carrying) scene layout by
    inserting zero velocity before the rotation column."""
    if boxes.shape[-1] >= nd:
        return boxes
    pad = np.zeros((len(boxes), nd - boxes.shape[-1]), boxes.dtype)
    return np.concatenate([boxes[:, :-1], pad, boxes[:, -1:]], axis=-1)


def mirror_vehicle_points(gt_point: np.ndarray) -> np.ndarray:
    """Left/right symmetrization of a vehicle's dense object points: the
    side with more points, and its mirror image in y."""
    ind = gt_point[:, 1] > 0
    vind = gt_point[:, 1] < 0
    keep = ind if ind.sum() > vind.sum() else vind
    gt_point = gt_point[keep]
    mirrored = gt_point.copy()
    mirrored[:, 1] *= -1
    return np.concatenate([gt_point, mirrored], 0)


def dense_points_for_box(gt_dir, obj_id, name, box, fallback_points=None):
    """The dense object set of one object (``<gt_dir>/<obj_id>.pkl``, key
    "gt", in the object's canonical frame; a vehicle's mirrored) placed at
    its box; ``fallback_points`` if the file is missing."""
    path = os.path.join(gt_dir, f"{obj_id}.pkl") if gt_dir else None
    if path and os.path.exists(path):
        gt_point = get_obj(path)["gt"].copy()
        if name == "VEHICLE":
            gt_point = mirror_vehicle_points(gt_point)
        gt_point[:, :3] = rotation_points_single_angle(gt_point[:, :3], np.pi / 2 + box[-1],
                                                       axis=2)
        gt_point[:, :3] += box[None][:, :3]
        return gt_point
    return fallback_points


class BatchSampler:
    """Shuffled round-robin sampler over a db-info list: ``sample(num)``
    takes the next ``num`` entries, or the rest of the pass and reshuffles."""

    def __init__(self, sampled_list, rng: np.random.RandomState, shuffle=True):
        self._sampled_list = sampled_list
        self._rng = rng
        self._indices = np.arange(len(sampled_list))
        self._shuffle = shuffle
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0
        self._n = len(sampled_list)

    def sample(self, num):
        if self._idx + num >= self._n:
            idx = self._indices[self._idx:].copy()
            if self._shuffle:
                self._rng.shuffle(self._indices)
            self._idx = 0
        else:
            idx = self._indices[self._idx:self._idx + num]
            self._idx += num
        return [self._sampled_list[i] for i in idx]


def filter_db_infos(db_infos, db_prep_steps):
    """det3d's DBFilterByDifficulty and DBFilterByMinNumPoint."""
    for step in db_prep_steps or []:
        step = dict(step)
        if "filter_by_difficulty" in step:
            removed = step["filter_by_difficulty"]
            db_infos = {k: [i for i in v if i.get("difficulty", 0) not in removed]
                        for k, v in db_infos.items()}
        if "filter_by_min_num_points" in step:
            for name, mn in dict(step["filter_by_min_num_points"]).items():
                if mn > 0 and name in db_infos:
                    db_infos[name] = [i for i in db_infos[name]
                                      if i.get("num_points_in_gt", 0) >= mn]
    return db_infos


class DataBaseSamplerV2:
    def __init__(self, db_infos, groups, db_prep_steps=None, rate=1.0, gt_dir=None):
        self.db_infos = filter_db_infos(db_infos, db_prep_steps)
        self._rate = rate
        self._gt_dir = gt_dir
        self._sample_classes = []
        self._sample_max_nums = []
        for group in groups:
            if len(group) > 1:
                raise NotImplementedError("group sampling is unused by Sparse2Dense")
            self._sample_classes += list(group.keys())
            self._sample_max_nums += list(group.values())

    def _sample_class(self, samplers, name, num, gt_boxes):
        """Candidates of class ``name`` that collide with no box of
        ``gt_boxes`` nor an earlier candidate."""
        if name not in samplers or num <= 0:
            return []
        sampled = copy.deepcopy(samplers[name].sample(num))
        if not sampled:
            return []
        num_gt = gt_boxes.shape[0]
        sp_boxes = np.stack([i["box3d_lidar"] for i in sampled], axis=0)
        sp_boxes = pad_box_dims(sp_boxes, gt_boxes.shape[-1])
        for info, b in zip(sampled, sp_boxes):
            info["box3d_lidar"] = b
        boxes = np.concatenate([gt_boxes, sp_boxes], axis=0)
        bv = boxes[:, [0, 1, 3, 4, -1]]
        coll = box_collision_test(bv, bv)
        np.fill_diagonal(coll, False)
        valid = []
        for i in range(num_gt, num_gt + len(sampled)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(sampled[i - num_gt])
        return valid

    def sample_all(self, root_path, gt_boxes, gt_names, num_point_features,
                   distillation=False, *, rng: np.random.RandomState) -> Optional[dict]:
        """dict(gt_names, difficulty, gt_boxes, points, gt_masks[,
        recon_points]) of the objects pasted into this sample, or None."""
        samplers = {k: BatchSampler(v, rng) for k, v in self.db_infos.items()}
        sampled = []
        sampled_gt_boxes = []
        avoid = gt_boxes
        for class_name, max_num in zip(self._sample_classes, self._sample_max_nums):
            n = int(max_num - np.sum([x == class_name for x in gt_names]))
            n = int(np.round(self._rate * n))
            if n <= 0:
                continue
            cls_sampled = self._sample_class(samplers, class_name, n, avoid)
            sampled += cls_sampled
            if cls_sampled:
                boxes = np.stack([s["box3d_lidar"] for s in cls_sampled], axis=0)
                sampled_gt_boxes.append(boxes)
                avoid = np.concatenate([avoid, boxes], axis=0)
        if not sampled:
            return None
        s_points_list, c_points_list = [], []
        for info in sampled:
            s_points = np.fromfile(str(Path(root_path) / info["path"]),
                                   dtype=np.float32).reshape(-1, num_point_features)
            s_points[:, :3] += info["box3d_lidar"][:3]
            s_points_list.append(s_points)
            if distillation:
                gt_point = dense_points_for_box(self._gt_dir, info.get("gt_signs", ""),
                                                info["name"], info["box3d_lidar"])
                if gt_point is None:   # no dense set: the raw points
                    gt_point = s_points
                else:
                    gt_point = gt_point[np.any(box_np_ops.points_in_rbbox(
                        gt_point, info["box3d_lidar"][None]), axis=1)]
                c_points_list.append(gt_point)
        ret = {
            "gt_names": np.array([s["name"] for s in sampled]),
            "difficulty": np.array([s.get("difficulty", 0) for s in sampled]),
            "gt_boxes": np.concatenate(sampled_gt_boxes, axis=0),
            "points": np.concatenate(s_points_list, axis=0),
            "gt_masks": np.ones((len(sampled),), dtype=bool),
        }
        if distillation:
            ret["recon_points"] = np.concatenate(c_points_list, axis=0)
        return ret


def build_dbsampler(cfg, gt_dir=None) -> Optional[DataBaseSamplerV2]:
    """From the reference's db_sampler schema (type "GT-AUG"); None when
    ``enable`` is false or the database file is missing (a warning)."""
    cfg = dict(cfg)
    if not cfg.get("enable", True):
        return None
    info_path = cfg["db_info_path"]
    if not os.path.exists(info_path):
        logging.getLogger("sparse2dense_tpu_torch").warning(
            f"db_info_path {info_path} missing; GT-AUG disabled")
        return None
    with open(info_path, "rb") as f:
        db_infos = pickle.load(f)
    prep_steps = []
    for step in cfg.get("db_prep_steps", []):
        step = dict(step)
        if "filter_by_min_num_point" in step:   # the singular alias of some configs
            step["filter_by_min_num_points"] = step.pop("filter_by_min_num_point")
        prep_steps.append(step)
    return DataBaseSamplerV2(db_infos, cfg["sample_groups"], db_prep_steps=prep_steps,
                             rate=cfg.get("rate", 1.0), gt_dir=gt_dir)
