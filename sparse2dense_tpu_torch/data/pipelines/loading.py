"""Point-cloud loading stages (host side): the port's copy of the Waymo
branch of ``sparse2dense_tpu/data/pipelines/loading.py`` (det3d's
datasets/pipelines/loading.py:101-199). A Waymo frame is a pickle with
``lidars.points_xyz`` and ``lidars.points_feature`` (intensity, elongation;
the intensity tanh-normalized on load); with ``nsweeps > 1`` the earlier
sweeps named by the info are moved by their transform matrices and
concatenated with a time-lag channel. The nuScenes branch raises: it comes
with the nuScenes datasets (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import pickle

import numpy as np

NUSCENES_LATER = ("the nuScenes datasets come in a later slice (ROADMAP Queue 1 item 9: "
                  "the nuScenes families)")


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


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


class LoadPointCloudFromFile:
    def __init__(self, dataset="WaymoDataset", **kwargs):
        if dataset != "WaymoDataset":
            raise NotImplementedError(f"{dataset}: {NUSCENES_LATER}")
        self.type = dataset

    def __call__(self, res, info):
        res["type"] = self.type
        nsweeps = res["lidar"]["nsweeps"]
        points = read_single_waymo(get_obj(info["path"]))
        res["lidar"]["points"] = points
        if nsweeps > 1:
            sweep_points = [points]
            sweep_times = [np.zeros((points.shape[0], 1))]
            for i in range(nsweeps - 1):
                p, t = read_single_waymo_sweep(info["sweeps"][i])
                sweep_points.append(p)
                sweep_times.append(t)
            points = np.concatenate(sweep_points, axis=0)
            times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
            res["lidar"]["points"] = points
            res["lidar"]["times"] = times
            res["lidar"]["combined"] = np.hstack([points, times])
        return res, info


class LoadPointCloudAnnotations:
    def __init__(self, with_bbox=True, **kwargs):
        pass

    def __call__(self, res, info):
        if res["type"] == "WaymoDataset" and "gt_boxes" in info:
            res["lidar"]["annotations"] = {"boxes": info["gt_boxes"].astype(np.float32),
                                           "names": info["gt_names"]}
        return res, info
