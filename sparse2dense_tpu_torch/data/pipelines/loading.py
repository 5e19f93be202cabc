"""Point-cloud loading stages (host side): the port's copy of
``sparse2dense_tpu/data/pipelines/loading.py`` (det3d's
datasets/pipelines/loading.py:101-199).

- A Waymo frame is a pickle with ``lidars.points_xyz`` and
  ``lidars.points_feature`` (intensity, elongation; the intensity
  tanh-normalized on load); with ``nsweeps > 1`` the earlier sweeps named by
  the info are moved by their transform matrices and concatenated with a
  time-lag channel.
- A nuScenes frame is a ``.bin`` of float32 rows of 5 (x, y, z, intensity,
  ring), of which the first 4 are kept; ``nsweeps - 1`` of the info's
  sweeps, drawn without replacement from the sample's generator
  (``res["rng"]``) in the reference's order, lose their points within 1 m
  of the sensor in x and y, are moved by their ``transform_matrix`` and
  joined with a time-lag channel (0 for the key frame).
"""
from __future__ import annotations

import pickle

import numpy as np


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def read_file(path, num_point_feature=4):
    """The first ``num_point_feature`` columns of a nuScenes ``.bin``."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :num_point_feature]


def remove_close(points, radius: float):
    """points (C, N) without those within ``radius`` of the origin in both
    x and y."""
    x_filt = np.abs(points[0, :]) < radius
    y_filt = np.abs(points[1, :]) < radius
    return points[:, ~(x_filt & y_filt)]


def read_single_waymo(obj):
    """(N, 5) xyz + tanh(intensity) + elongation of one frame's pickle."""
    points_xyz = obj["lidars"]["points_xyz"]
    points_feature = obj["lidars"]["points_feature"].copy()
    points_feature[:, 0] = np.tanh(points_feature[:, 0])
    return np.concatenate([points_xyz, points_feature], axis=-1)


def read_single_waymo_sweep(sweep):
    """An earlier sweep's points in the current frame, and its time lags."""
    points_sweep = read_single_waymo(get_obj(sweep["path"])).T  # (5, N)
    if sweep["transform_matrix"] is not None:
        n = points_sweep.shape[1]
        points_sweep[:3, :] = sweep["transform_matrix"].dot(
            np.vstack((points_sweep[:3, :], np.ones(n))))[:3, :]
    times = sweep["time_lag"] * np.ones((1, points_sweep.shape[1]))
    return points_sweep.T, times.T


def read_sweep(sweep):
    """A nuScenes sweep's points in the key frame, and its time lags."""
    points_sweep = remove_close(read_file(str(sweep["lidar_path"])).T, 1.0)
    if sweep["transform_matrix"] is not None:
        n = points_sweep.shape[1]
        points_sweep[:3, :] = sweep["transform_matrix"].dot(
            np.vstack((points_sweep[:3, :], np.ones(n))))[:3, :]
    times = sweep["time_lag"] * np.ones((1, points_sweep.shape[1]))
    return points_sweep.T, times.T


class LoadPointCloudFromFile:
    def __init__(self, dataset="WaymoDataset", **kwargs):
        if dataset not in ("WaymoDataset", "NuScenesDataset"):
            raise NotImplementedError(dataset)
        self.type = dataset

    def __call__(self, res, info):
        res["type"] = self.type
        nsweeps = res["lidar"]["nsweeps"]
        if self.type == "NuScenesDataset":
            points = read_file(str(info["lidar_path"]))
            picks = res["rng"].choice(len(info["sweeps"]), nsweeps - 1, replace=False)
            sweeps = [read_sweep(info["sweeps"][i]) for i in picks]
        else:
            points = read_single_waymo(get_obj(info["path"]))
            res["lidar"]["points"] = points
            if nsweeps == 1:
                return res, info
            sweeps = [read_single_waymo_sweep(info["sweeps"][i]) for i in range(nsweeps - 1)]
        key = points
        points = np.concatenate([key] + [p for p, _ in sweeps], axis=0)
        times = np.concatenate([np.zeros((len(key), 1))] + [t for _, t in sweeps],
                               axis=0).astype(points.dtype)
        res["lidar"]["points"] = points
        res["lidar"]["times"] = times
        res["lidar"]["combined"] = np.hstack([points, times])
        return res, info


class LoadPointCloudAnnotations:
    def __init__(self, with_bbox=True, **kwargs):
        pass

    def __call__(self, res, info):
        if res["type"] == "NuScenesDataset" and "gt_boxes" in info:
            gt_boxes = info["gt_boxes"].astype(np.float32)
            gt_boxes[np.isnan(gt_boxes)] = 0
            res["lidar"]["annotations"] = {
                "boxes": gt_boxes, "names": info["gt_names"],
                "tokens": info.get("gt_boxes_token"),
                "velocities": info["gt_boxes_velocity"].astype(np.float32)}
        elif res["type"] == "WaymoDataset" and "gt_boxes" in info:
            res["lidar"]["annotations"] = {"boxes": info["gt_boxes"].astype(np.float32),
                                           "names": info["gt_names"]}
        return res, info
