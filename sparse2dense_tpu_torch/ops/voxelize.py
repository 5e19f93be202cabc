"""Hard voxelization on the host, first-come-first-serve: the port's copy of
``sparse2dense_tpu/ops/voxelize.py``. :func:`points_to_voxel_native` runs
``csrc/voxelizer.cpp`` (built by the host C++ compiler at first use, bound
through ctypes); :func:`points_to_voxel` is its plain NumPy version. Both
give the same arrays:

- a point is dropped if any of its xyz cells falls outside the grid;
- voxels are indexed in order of first appearance along the point order;
- once ``max_voxels`` distinct voxels exist, points of new voxels are dropped;
- within a voxel only the first ``max_points`` points are kept;
- coordinates are returned zyx.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "voxelizer.cpp")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libvoxelizer.so")
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The native voxelizer, built on first use; raises if it cannot be."""
    global _lib
    if _lib is None:
        cuda_build.build_host(SOURCE, LIBRARY)
        lib = ctypes.CDLL(LIBRARY)
        lib.points_to_voxel_fcfs.restype = ctypes.c_int64
        lib.points_to_voxel_fcfs.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 3)
        _lib = lib
    return _lib


def points_to_voxel_native(points: np.ndarray, voxel_size, coors_range,
                           max_points: int = 35, max_voxels: int = 20000
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`points_to_voxel` in C++ on float32 points (zyx coordinates)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"points must be (N, >=3), got {points.shape}")
    n, c = points.shape
    vs = np.ascontiguousarray(voxel_size, dtype=np.float32)
    cr = np.ascontiguousarray(coors_range, dtype=np.float32)
    if vs.shape != (3,) or cr.shape != (6,):
        raise ValueError(f"voxel_size (3,) and coors_range (6,), got {vs.shape}, {cr.shape}")
    voxels = np.zeros((max_voxels, max_points, c), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    num_points = np.zeros((max_voxels,), np.int32)
    m = _library().points_to_voxel_fcfs(
        points.ctypes.data, n, c, vs.ctypes.data, cr.ctypes.data, max_points, max_voxels,
        voxels.ctypes.data, coords.ctypes.data, num_points.ctypes.data)
    return voxels[:m], coords[:m], num_points[:m]


def points_to_voxel(points: np.ndarray, voxel_size, coors_range,
                    max_points: int = 35, max_voxels: int = 20000
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, >=3) points -> (voxels (M, max_points, C), coords (M, 3) zyx int32,
    num_points (M,) int32), M <= max_voxels."""
    points = np.asarray(points)
    voxel_size = np.asarray(voxel_size, dtype=points.dtype)
    coors_range = np.asarray(coors_range, dtype=points.dtype)
    grid_size = np.round((coors_range[3:] - coors_range[:3]) / voxel_size).astype(np.int64)
    empty = (np.zeros((0, max_points, points.shape[-1]), dtype=points.dtype),
             np.zeros((0, 3), dtype=np.int32), np.zeros((0,), dtype=np.int32))
    if points.shape[0] == 0:
        return empty

    cell = np.floor((points[:, :3] - coors_range[:3]) / voxel_size).astype(np.int64)
    valid = np.all((cell >= 0) & (cell < grid_size[None, :]), axis=1)
    pts = points[valid]
    cell = cell[valid]
    if pts.shape[0] == 0:
        return empty

    keys = (cell[:, 0] * grid_size[1] + cell[:, 1]) * grid_size[2] + cell[:, 2]
    # voxel ids in order of first appearance
    _, first_idx, inverse = np.unique(keys, return_index=True, return_inverse=True)
    appearance_rank = np.empty(len(first_idx), dtype=np.int64)
    appearance_rank[np.argsort(first_idx, kind="stable")] = np.arange(len(first_idx))
    voxel_ids = appearance_rank[inverse]

    # arrival rank of each point inside its voxel
    perm = np.argsort(voxel_ids, kind="stable")
    sorted_vids = voxel_ids[perm]
    n = len(sorted_vids)
    is_start = np.empty(n, dtype=bool)
    is_start[0] = True
    is_start[1:] = sorted_vids[1:] != sorted_vids[:-1]
    group_start = np.maximum.accumulate(np.where(is_start, np.arange(n), 0))
    ranks = np.empty(n, dtype=np.int64)
    ranks[perm] = np.arange(n) - group_start

    keep = (voxel_ids < max_voxels) & (ranks < max_points)
    kept_vids = voxel_ids[keep]
    num_voxels = int(kept_vids.max()) + 1 if kept_vids.size else 0
    voxels = np.zeros((num_voxels, max_points, points.shape[-1]), dtype=points.dtype)
    voxels[kept_vids, ranks[keep]] = pts[keep]
    num_points = np.bincount(kept_vids, minlength=num_voxels).astype(np.int32)
    coords = np.zeros((num_voxels, 3), dtype=np.int32)
    coords[kept_vids] = cell[keep].astype(np.int32)
    return voxels, np.ascontiguousarray(coords[:, ::-1]), num_points  # xyz -> zyx


class VoxelGenerator:
    """Config-driven wrapper around :func:`points_to_voxel_native`."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points, max_voxels=20000):
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.voxel_size = np.asarray(voxel_size, dtype=np.float32)
        self.grid_size = np.round((self.point_cloud_range[3:] - self.point_cloud_range[:3])
                                  / self.voxel_size).astype(np.int64)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels

    def generate(self, points: np.ndarray, max_voxels: Optional[int] = None):
        """Voxels of ``points`` under ``max_voxels`` (the generator's own
        budget unless given: the pipeline passes its train or test one)."""
        return points_to_voxel_native(points, self.voxel_size, self.point_cloud_range,
                                      self.max_num_points,
                                      self.max_voxels if max_voxels is None else max_voxels)
