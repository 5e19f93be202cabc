"""The Preprocess and Voxelization stages (host side): the port's copy of
``sparse2dense_tpu/data/pipelines/preprocess.py`` (det3d's
datasets/pipelines/preprocess.py:38-463).

``Preprocess`` is where Sparse2Dense makes its data:

- in training with distillation, every annotated object's raw points are
  replaced by its dense object set (``<gt_dir>/<obj_id>.pkl``, vehicles
  mirrored left/right, turned from the canonical frame to the box's) to
  form ``dense_points``; the same per-object points restricted to their
  boxes form ``reconstruction_points``;
- GT-AUG (the db sampler) pastes objects into all three streams alike;
- global flip, rotation, scaling and translation move all three streams
  with the same draw.

The sample's ``np.random.RandomState`` is ``res["rng"]`` (the dataset sets
it): it feeds the db sampler, the augmentations and the point shuffles, in
the reference's order.

A nuScenes frame takes the same path with its 9-dof boxes (x, y, z, w, l,
h, vx, vy, yaw: the flips, the rotation and the scaling move the
velocities too) and its points with the time-lag channel.

``DoubleFlip`` (test-time augmentation) adds the y-flipped, x-flipped and
doubly flipped copies of the points. ``Voxelization`` emits the base voxel
stream and, for distillation, the dense voxels and the reconstruction
voxels at 1x, 2x and 4x the voxel size, under the train budget in training
and the test budget otherwise; with ``double_flip``, outside training, also
the three flipped streams.
"""
from __future__ import annotations

import os

import numpy as np

from ...core import augment, box_np_ops
from ...core.sampler import build_dbsampler, dense_points_for_box
from ...ops.voxelize import VoxelGenerator

def _dict_select(d, inds):
    for k, v in d.items():
        if isinstance(v, dict):
            _dict_select(v, inds)
        else:
            d[k] = v[inds]


def drop_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x not in used_classes]
    return np.array(inds, dtype=np.int64)


def _shuffle_rows(a: np.ndarray, rng: np.random.RandomState) -> None:
    """``rng.shuffle(a)`` in place, through a shuffled index: the same draws
    and the same order (NumPy swaps a 2-D array's rows one Python-level
    step at a time, ~0.2 s for a Waymo frame)."""
    perm = np.arange(len(a))
    rng.shuffle(perm)
    a[...] = a[perm]


def synthesize_dense_streams(points, info, gt_dir):
    """(dense_points, reconstruction_points) of one frame: the points out of
    every box, plus each object's dense set (its raw in-box points for a
    SIGN or an object with no set), and the non-SIGN objects' sets kept in
    the boxes."""
    gt_boxes = info["gt_boxes"]
    point_out_box = ~np.any(box_np_ops.points_in_rbbox(points, gt_boxes), axis=1)
    combined = [points[point_out_box]]
    recon = []
    for obj, box, typ in zip(info["gt_signs"], gt_boxes, info["gt_names"]):
        gt_point = None
        if typ != "SIGN":
            gt_point = dense_points_for_box(gt_dir, obj, typ, box)
        if gt_point is None:
            gt_point = points[box_np_ops.points_in_rbbox(points, box[None])[:, 0]]
        combined.append(gt_point)
        if typ != "SIGN":
            recon.append(gt_point)
    dense_points = np.concatenate(combined, 0)
    if len(recon) == 0:
        recon_points = np.zeros([1, points.shape[1]], points.dtype)
    else:
        recon_points = np.concatenate(recon, 0)
        recon_points = recon_points[
            np.any(box_np_ops.points_in_rbbox(recon_points, gt_boxes), axis=1)]
    return dense_points, recon_points


class Preprocess:
    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg if cfg is not None else kwargs["cfg"])
        self.shuffle_points = cfg["shuffle_points"]
        self.min_points_in_gt = cfg.get("min_points_in_gt", -1)
        self.distillation = cfg.get("distillation", False)
        self.mode = cfg["mode"]
        self.no_augmentation = cfg.get("no_augmentation", False)
        # the dense object sets' directory; the reference hardcodes
        # '../data/waymo/{train,val}/gt/' (det3d preprocess.py:88, :222)
        self.gt_dir = cfg.get("gt_dir")
        if self.mode == "train":
            self.global_rotation_noise = cfg["global_rot_noise"]
            self.global_scaling_noise = cfg["global_scale_noise"]
            self.global_translate_std = cfg.get("global_translate_std", 0)
            self.class_names = cfg["class_names"]
            self.db_sampler = (build_dbsampler(cfg["db_sampler"], gt_dir=self.gt_dir)
                               if cfg.get("db_sampler") else None)

    def _gt_dir(self, res):
        if self.gt_dir is not None:
            return self.gt_dir
        root = res.get("metadata", {}).get("image_prefix", "../data/waymo")
        return os.path.join(str(root), "train" if self.mode == "train" else "val", "gt")

    def _classes(self, names):
        return np.array([self.class_names.index(n) + 1 for n in names], dtype=np.int32)

    def __call__(self, res, info):
        res["mode"] = self.mode
        if res["type"] not in ("WaymoDataset", "NuScenesDataset"):
            raise NotImplementedError(res["type"])
        rng = res.get("rng")
        points = res["lidar"].get("combined", res["lidar"]["points"])

        dense_points = recon_points = None
        if self.mode == "train":
            anno = res["lidar"]["annotations"]
            gt_dict = {"gt_boxes": anno["boxes"],
                       "gt_names": np.array(anno["names"]).reshape(-1)}
            if self.distillation:
                dense_points, recon_points = synthesize_dense_streams(points, info,
                                                                      self._gt_dir(res))

        if self.mode == "train" and not self.no_augmentation:
            _dict_select(gt_dict, drop_arrays_by_name(gt_dict["gt_names"],
                                                      ["DontCare", "ignore", "UNKNOWN"]))
            if self.min_points_in_gt > 0:
                counts = box_np_ops.points_in_rbbox(points, gt_dict["gt_boxes"]).sum(0)
                _dict_select(gt_dict, counts >= self.min_points_in_gt)
            gt_boxes_mask = np.array([n in self.class_names for n in gt_dict["gt_names"]],
                                     dtype=bool)
            if self.db_sampler:
                sampled = self.db_sampler.sample_all(
                    res["metadata"]["image_prefix"], gt_dict["gt_boxes"], gt_dict["gt_names"],
                    res["metadata"]["num_point_features"], distillation=self.distillation,
                    rng=rng)
                if sampled is not None:
                    gt_dict["gt_names"] = np.concatenate(
                        [gt_dict["gt_names"], sampled["gt_names"]], axis=0)
                    gt_dict["gt_boxes"] = np.concatenate(
                        [gt_dict["gt_boxes"], sampled["gt_boxes"]])
                    gt_boxes_mask = np.concatenate([gt_boxes_mask, sampled["gt_masks"]], axis=0)
                    points = np.concatenate([sampled["points"], points], axis=0)
                    if self.distillation:
                        dense_points = np.concatenate([sampled["points"], dense_points], axis=0)
                        recon_points = np.concatenate([sampled["recon_points"], recon_points],
                                                      axis=0)
            _dict_select(gt_dict, gt_boxes_mask)
            gt_dict["gt_classes"] = self._classes(gt_dict["gt_names"])

            streams = [points] + ([dense_points, recon_points] if self.distillation else [])
            boxes = gt_dict["gt_boxes"]
            boxes, streams = augment.random_flip_both(boxes, streams, rng=rng)
            boxes, streams = augment.global_rotation(boxes, streams, rng=rng,
                                                     rotation=self.global_rotation_noise)
            boxes, streams = augment.global_scaling(boxes, streams, *self.global_scaling_noise,
                                                    rng=rng)
            boxes, streams = augment.global_translate(
                boxes, streams, rng=rng, noise_translate_std=self.global_translate_std)
            gt_dict["gt_boxes"] = boxes
            points = streams[0]
            if self.distillation:
                dense_points, recon_points = streams[1], streams[2]
        elif self.mode == "train":   # no augmentation
            _dict_select(gt_dict, np.array([n in self.class_names for n in gt_dict["gt_names"]],
                                           dtype=bool))
            gt_dict["gt_classes"] = self._classes(gt_dict["gt_names"])
        elif self.distillation:
            dense_points, recon_points = synthesize_dense_streams(points, info,
                                                                  self._gt_dir(res))

        if self.shuffle_points:
            _shuffle_rows(points, rng)
            if dense_points is not None:
                _shuffle_rows(dense_points, rng)

        res["lidar"]["points"] = points
        if self.distillation and dense_points is not None:
            res["lidar"]["dense_points"] = dense_points
            res["lidar"]["reconstruction_points"] = recon_points
        if self.mode == "train":
            res["lidar"]["annotations"] = gt_dict
        return res, info


def filter_gt_box_outside_range(gt_boxes, bv_range):
    """Boxes whose BEV centre lies in ``bv_range`` (x0, y0, x1, y1)."""
    return ((gt_boxes[:, 0] >= bv_range[0]) & (gt_boxes[:, 0] <= bv_range[2])
            & (gt_boxes[:, 1] >= bv_range[1]) & (gt_boxes[:, 1] <= bv_range[3]))


def flip_views(points: np.ndarray):
    """The double-flip views of a cloud: [the cloud, y negated, x negated,
    both] (the flipped three are copies)."""
    views = [points]
    for cols in ([1], [0], [0, 1]):
        v = points.copy()
        v[:, cols] = -v[:, cols]
        views.append(v)
    return views


class DoubleFlip:
    """Test-time augmentation: the points with y negated, with x negated and
    with both, as ``yflip_points``, ``xflip_points`` and
    ``double_flip_points``."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, res, info):
        flips = flip_views(res["lidar"]["points"])[1:]
        for key, v in zip(("yflip", "xflip", "double_flip"), flips):
            res["lidar"][f"{key}_points"] = v
        return res, info


class Voxelization:
    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg if cfg is not None else kwargs["cfg"])
        if kwargs.get("distillation") is not None:
            cfg["distillation"] = kwargs["distillation"]
        self.range = np.asarray(cfg["range"], np.float32)
        self.voxel_size = np.asarray(cfg["voxel_size"], np.float32)
        self.max_points_in_voxel = cfg["max_points_in_voxel"]
        mv = cfg["max_voxel_num"]
        self.max_voxel_num = [mv, mv] if isinstance(mv, int) else list(mv)
        self.distillation = cfg.get("distillation", False)
        self.double_flip = cfg.get("double_flip", False)

        def gen(mult):
            return VoxelGenerator(self.voxel_size * mult, self.range, self.max_points_in_voxel,
                                  self.max_voxel_num[0])

        self.voxel_generator = gen(1)
        if self.distillation:
            self.voxel_generator_recon = {"": gen(1), "_2": gen(2), "_4": gen(4)}

    def _pack(self, voxels, coordinates, num_points):
        return dict(voxels=voxels, coordinates=coordinates, num_points=num_points,
                    num_voxels=np.array([voxels.shape[0]], dtype=np.int64),
                    shape=self.voxel_generator.grid_size,
                    range=self.voxel_generator.point_cloud_range,
                    size=self.voxel_generator.voxel_size)

    def __call__(self, res, info):
        if res["mode"] == "train":
            gt_dict = res["lidar"]["annotations"]
            _dict_select(gt_dict, filter_gt_box_outside_range(gt_dict["gt_boxes"],
                                                              self.range[[0, 1, 3, 4]]))
            res["lidar"]["annotations"] = gt_dict
            max_voxels = self.max_voxel_num[0]
        else:
            max_voxels = self.max_voxel_num[1]
        lidar = res["lidar"]
        lidar["voxels"] = self._pack(*self.voxel_generator.generate(lidar["points"], max_voxels))
        if self.distillation:
            lidar["dense_voxels"] = self._pack(
                *self.voxel_generator.generate(lidar["dense_points"], max_voxels))
            recon = lidar["reconstruction_points"].astype(np.float32)
            for tag, g in self.voxel_generator_recon.items():
                lidar[f"reconstruction_voxels{tag}"] = self._pack(*g.generate(recon, max_voxels))
        if self.double_flip and res["mode"] != "train":
            for key in ("yflip", "xflip", "double_flip"):
                lidar[f"{key}_voxels"] = self._pack(
                    *self.voxel_generator.generate(lidar[f"{key}_points"], max_voxels))
        return res, info
