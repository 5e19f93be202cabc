"""Global augmentations over the gt boxes and any number of point streams:
the port's copy of ``sparse2dense_tpu/core/augment.py`` (det3d's
core/sampler/preprocess.py family). Each transform takes a list of point
arrays and applies the identical transform to all of them, which keeps the
distillation streams coherent (det3d's ``f_`` variants), and an explicit
``np.random.RandomState``; it draws from it in the reference's order, so
for a generator in the same state it gives the same arrays. Also the BEV
collision test of GT-AUG's placement (:func:`box_collision_test`).
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import box_np_ops


def rotation_points_single_angle(points, angle, axis=2):
    """(N, 3) points rotated by a scalar angle about an axis."""
    sin, cos = np.sin(angle), np.cos(angle)
    if axis == 2:
        rot = np.array([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]], points.dtype)
    elif axis == 1:
        rot = np.array([[cos, 0, -sin], [0, 1, 0], [sin, 0, cos]], points.dtype)
    else:
        rot = np.array([[1, 0, 0], [0, cos, -sin], [0, sin, cos]], points.dtype)
    return points @ rot.T


def random_flip_both(gt_boxes, point_streams: List[np.ndarray], *,
                     rng: np.random.RandomState, probability=0.5, flip_coor=None):
    """Flips about the x axis (y negated), then about the y axis, each with
    ``probability``."""
    if rng.rand() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        for p in point_streams:
            p[:, 1] = -p[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    if rng.rand() < probability:
        if flip_coor is None:
            gt_boxes[:, 0] = -gt_boxes[:, 0]
            for p in point_streams:
                p[:, 0] = -p[:, 0]
        else:
            gt_boxes[:, 0] = flip_coor * 2 - gt_boxes[:, 0]
            for p in point_streams:
                p[:, 0] = flip_coor * 2 - p[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
    return gt_boxes, point_streams


def global_rotation(gt_boxes, point_streams: List[np.ndarray], *,
                    rng: np.random.RandomState, rotation=np.pi / 4):
    """One yaw, uniform in ``rotation`` ([-r, r] for a scalar), about z."""
    if not isinstance(rotation, (list, tuple)):
        rotation = [-rotation, rotation]
    angle = rng.uniform(rotation[0], rotation[1])
    for p in point_streams:
        p[:, :3] = rotation_points_single_angle(p[:, :3], angle, axis=2)
    gt_boxes[:, :3] = rotation_points_single_angle(gt_boxes[:, :3], angle, axis=2)
    if gt_boxes.shape[1] > 7:
        vel = np.hstack([gt_boxes[:, 6:8], np.zeros((gt_boxes.shape[0], 1))])
        gt_boxes[:, 6:8] = rotation_points_single_angle(vel, angle, axis=2)[:, :2]
    gt_boxes[:, -1] += angle
    return gt_boxes, point_streams


def global_scaling(gt_boxes, point_streams: List[np.ndarray], min_scale=0.95,
                   max_scale=1.05, *, rng: np.random.RandomState):
    """One scale, uniform in [min_scale, max_scale]; as the reference, every
    box column but the yaw scales, the velocity too."""
    s = rng.uniform(min_scale, max_scale)
    for p in point_streams:
        p[:, :3] *= s
    gt_boxes[:, :-1] *= s
    return gt_boxes, point_streams


def global_translate(gt_boxes, point_streams: List[np.ndarray], *,
                     rng: np.random.RandomState, noise_translate_std=0):
    """One normal shift a axis; no draw when every std is 0."""
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = [noise_translate_std] * 3
    if all(e == 0 for e in noise_translate_std):
        return gt_boxes, point_streams
    t = np.array([rng.normal(0, s) for s in noise_translate_std], gt_boxes.dtype)
    for p in point_streams:
        p[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, point_streams


def box_collision_test(boxes, qboxes):
    """(N, 5) x (K, 5) [x y w l yaw] BEV rotated-box overlap (N, K): exact
    separating-axis test on the corner polygons, vectorized."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)
    c1 = box_np_ops.center_to_corner_box2d(boxes[:, :2], boxes[:, 2:4], boxes[:, 4])
    c2 = box_np_ops.center_to_corner_box2d(qboxes[:, :2], qboxes[:, 2:4], qboxes[:, 4])

    def axes_of(corners):
        e = np.roll(corners, -1, axis=1) - corners  # (M, 4, 2)
        ax = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        norm = np.linalg.norm(ax, axis=-1, keepdims=True)
        return ax / np.maximum(norm, 1e-9)

    a1, a2 = axes_of(c1), axes_of(c2)  # (N, 4, 2), (K, 4, 2)
    sep = np.zeros((n, k), dtype=bool)
    for i in range(4):   # the 4 edge normals of each box of the first set
        ax = a1[:, i, :]
        pa = np.einsum("ncd,nd->nc", c1, ax)
        pb = np.einsum("kcd,nd->nkc", c2, ax)
        sep |= (pa.max(1)[:, None] < pb.min(2)) | (pb.max(2) < pa.min(1)[:, None])
    for i in range(4):   # then of each box of the second
        ax = a2[:, i, :]
        pa = np.einsum("ncd,kd->nkc", c1, ax)
        pb = np.einsum("kcd,kd->kc", c2, ax)
        sep |= (pa.max(2) < pb.min(1)[None, :]) | (pb.max(1)[None, :] < pa.min(2))
    return ~sep
