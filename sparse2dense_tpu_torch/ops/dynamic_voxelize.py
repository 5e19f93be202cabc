"""Dynamic voxelization on the tensors' device (counterpart of
``sparse2dense_tpu/ops/dynamic_voxelize.py``): points -> per-voxel mean
features without a per-voxel point cap, and the per-point pillar
decoration with a segment-max scatter to the BEV canvas, by sorts and
segment reductions. No config reaches these functions; they stand beside
the host voxelizer (``ops/voxelize.py``) as its alternative on the device.

- :func:`dynamic_voxelize_mean`: rows in ascending cell id (z-major), the
  mean of every point of a cell, a fixed budget of rows; cells past the
  budget are dropped (the highest cell ids), as the reference's.
- :func:`dynamic_pillar_features`: each point's raw features, its offset
  from its pillar's mean and from its pillar's centre, and its flat BEV
  index (``ny * nx`` for a point out of range).
- :func:`scatter_max_to_canvas`: (N, C) per-point features -> (ny, nx, C),
  each cell the max of 0 and its points' features (the reference's
  segment max into a zero canvas).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def point_cell_ids(points, valid, voxel_size, pc_range, grid_size):
    """Per-point linear cell id, z-major (z, y, x), with ``gx * gy * gz``
    for a point that is invalid or out of the grid; also the (x, y, z) cell
    and the in-grid mask."""
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    gx, gy, gz = (int(g) for g in grid_size)
    cell = torch.floor((points[:, :3] - lo) / vs).to(torch.int32)
    ok = valid & (cell >= 0).all(1) & (cell[:, 0] < gx) & (cell[:, 1] < gy) & (cell[:, 2] < gz)
    lin = (cell[:, 2] * gy + cell[:, 1]) * gx + cell[:, 0]
    return torch.where(ok, lin, torch.full_like(lin, gx * gy * gz)), cell, ok


def dynamic_voxelize_mean(points: torch.Tensor, valid: torch.Tensor,
                          voxel_size: Sequence[float], pc_range: Sequence[float],
                          grid_size: Sequence[int], max_voxels: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """points (N, C) with a validity mask -> (features (V, C) means, coords
    (V, 3) zyx int32 with -1 padding, valid (V,)), V = ``max_voxels``."""
    c = points.shape[1]
    gx, gy, gz = (int(g) for g in grid_size)
    n_cells = gx * gy * gz
    lin, _, _ = point_cell_ids(points, valid, voxel_size, pc_range, grid_size)
    slin, order = torch.sort(lin, stable=True)
    in_grid = slin < n_cells
    is_start = torch.ones_like(in_grid)
    is_start[1:] = slin[1:] != slin[:-1]
    slot = torch.cumsum((is_start & in_grid).to(torch.int64), 0) - 1
    slot = torch.where(in_grid, slot, torch.full_like(slot, max_voxels)).clamp(max=max_voxels)
    sums = points.new_zeros(max_voxels + 1, c).index_add_(0, slot, points[order])[:max_voxels]
    counts = torch.zeros(max_voxels + 1, dtype=torch.int32, device=points.device).index_add_(
        0, slot, torch.ones_like(slot, dtype=torch.int32))[:max_voxels]
    row_lin = torch.full((max_voxels + 1,), -1, dtype=torch.int32, device=points.device)
    row_lin = row_lin.scatter_reduce(0, slot, slin, "amax")[:max_voxels]
    out_valid = counts > 0
    feats = sums / counts.clamp(min=1).to(points.dtype)[:, None]
    feats = feats * out_valid[:, None].to(points.dtype)
    safe = row_lin.clamp(min=0)
    coords = torch.stack([safe // (gy * gx), (safe // gx) % gy, safe % gx], -1)
    coords = torch.where(out_valid[:, None], coords, torch.full_like(coords, -1))
    return feats, coords, out_valid


def dynamic_pillar_features(points, valid, voxel_size, pc_range, grid_size):
    """Per-point decorated pillar features: [raw (C), offset from the
    pillar's mean (3), offset from the pillar's centre (2)] -> (N, C + 5),
    zero for a point out of range, with each point's flat BEV index
    (y * nx + x; ``nx * ny`` out of range) and its in-range mask."""
    gx, gy = int(grid_size[0]), int(grid_size[1])
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    cell = torch.floor((points[:, :3] - lo) / vs).to(torch.int32)
    ok = valid & (cell[:, :2] >= 0).all(1) & (cell[:, 0] < gx) & (cell[:, 1] < gy)
    ncell = gx * gy
    flat = torch.where(ok, cell[:, 1] * gx + cell[:, 0], torch.full_like(cell[:, 0], ncell))
    okf = ok[:, None].to(points.dtype)
    sums = points.new_zeros(ncell + 1, 3).index_add_(0, flat.long(), points[:, :3] * okf)
    counts = torch.zeros(ncell + 1, dtype=torch.int32, device=points.device).index_add_(
        0, flat.long(), ok.to(torch.int32))
    means = sums / counts.clamp(min=1).to(points.dtype)[:, None]
    f_cluster = points[:, :3] - means[flat.long()]
    cx = (cell[:, 0].to(points.dtype) + 0.5) * vs[0] + lo[0]
    cy = (cell[:, 1].to(points.dtype) + 0.5) * vs[1] + lo[1]
    f_center = torch.stack([points[:, 0] - cx, points[:, 1] - cy], -1)
    feats = torch.cat([points, f_cluster, f_center], -1) * okf
    return feats, flat, ok


def scatter_max_to_canvas(point_feats, flat, ny: int, nx: int):
    """(N, C) per-point features -> the (ny, nx, C) canvas: each cell the
    max of 0 and the features of its points (``flat`` as
    :func:`dynamic_pillar_features` gives it; the ``ny * nx`` entries
    dropped)."""
    c = point_feats.shape[-1]
    canvas = point_feats.new_zeros(ny * nx + 1, c).scatter_reduce(
        0, flat.long()[:, None].expand(-1, c), point_feats, "amax")
    return canvas[:ny * nx].reshape(ny, nx, c)
