"""Sparse-tensor helpers shared by the backbone engines, and the gather
oracle: the dense index grid, neighbour tables, the strided active set and
the gather-GEMM conv (counterpart of ``sparse2dense_tpu/ops/sparse_conv.py``;
every integer result is bit-exact against it).

Coordinates are (z, y, x) int32 with -1 rows for padding. The index grid
maps each grid cell to the row that occupies it (-1 empty); neighbour lookup
is a plain gather through it. Row indices are int32, as in the reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_I32 = torch.int32


def ravel_coords(coords: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """(..., 3) zyx int coords -> int32 linear index; off-grid or -1 coords -> -1."""
    d, h, w = grid
    z, y, x = coords.long().unbind(-1)
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return torch.where(ok, (z * h + y) * w + x, -1).to(_I32)


def build_index_grid(coords: torch.Tensor, valid: torch.Tensor,
                     grid: Sequence[int]) -> torch.Tensor:
    """Dense cell -> row map (D*H*W,) int32, -1 where no row sits. Invalid rows
    go to one spare cell past the end, which is cut off (never to -1, which
    would clobber the last cell). Coordinates are unique per valid row; a
    duplicate would keep its highest row."""
    size = 1
    for g in grid:
        size *= g
    lin = ravel_coords(coords, grid).long()
    lin = torch.where(valid & (lin >= 0), lin, size)
    table = torch.full((size + 1,), -1, dtype=_I32, device=coords.device)
    table.scatter_reduce_(0, lin, torch.arange(coords.shape[0], dtype=_I32,
                                               device=coords.device), reduce="amax")
    return table[:size]


def kernel_offsets(ksize: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
    """All tap offsets from the kernel's origin, zyx order (tap k is z-major)."""
    kz, ky, kx = ksize
    return [(z, y, x) for z in range(kz) for y in range(ky) for x in range(kx)]


def _lookup(cells: torch.Tensor, index_grid: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """Row of each (..., 3) cell through the index grid; -1 off the grid."""
    lin = ravel_coords(cells, grid)
    return torch.where(lin >= 0, index_grid[lin.clamp(min=0).long()], -1)


def subm_neighbor_table(coords: torch.Tensor, valid: torch.Tensor, index_grid: torch.Tensor,
                        grid: Sequence[int], ksize: Tuple[int, int, int] = (3, 3, 3)
                        ) -> torch.Tensor:
    """(V, K) int32: for output row v and tap k, the input row of the active
    neighbour at coords[v] + offset_k - centre, or -1."""
    center = torch.tensor([(k - 1) // 2 for k in ksize], dtype=torch.long)
    rel = (torch.tensor(kernel_offsets(ksize), dtype=torch.long) - center).to(coords.device)
    idx = _lookup(coords.long()[:, None, :] + rel[None], index_grid, grid)
    return torch.where(valid[:, None], idx, -1)


def downsample_active_set(coords: torch.Tensor, valid: torch.Tensor, grid_in: Sequence[int],
                          grid_out: Sequence[int], stride: Tuple[int, int, int],
                          padding: Tuple[int, int, int], ksize: Tuple[int, int, int],
                          out_budget: int):
    """Active output set of a strided sparse conv: every output cell
    o = (c + p - k) / s (exact division, in range) of an active input c, in
    grid-linear order, the first ``out_budget`` of them (the overflow drop
    keeps the lowest linear indices). Per axis only ceil(k / s) candidates
    o in {q, q - 1, ...}, q = (c + p) // s, can satisfy the exactness; they
    are enumerated, sorted and compacted at their first occurrence.

    Returns (out_coords (budget, 3) int32 with -1 padding, out_valid (budget,))."""
    dev = coords.device
    c = coords.long()
    s = torch.tensor(stride, dtype=torch.long, device=dev)
    p = torch.tensor(padding, dtype=torch.long, device=dev)
    ks = torch.tensor(ksize, dtype=torch.long, device=dev)
    ncand = [-(-k // st) for k, st in zip(ksize, stride)]
    combos = torch.tensor([(a, b, e) for a in range(ncand[0]) for b in range(ncand[1])
                           for e in range(ncand[2])], dtype=torch.long, device=dev)
    q = torch.div(c + p, s, rounding_mode="floor")
    o = q[:, None, :] - combos[None]                            # (V, C, 3)
    k = c[:, None, :] + p - o * s
    ok = valid[:, None] & ((k >= 0) & (k < ks)).all(-1)
    lin = ravel_coords(o, grid_out).long()
    size_out = 1
    for g in grid_out:
        size_out *= g
    flat = torch.where(ok & (lin >= 0), lin, size_out).reshape(-1)
    sorted_lin = torch.sort(flat).values
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_lin[1:] != sorted_lin[:-1]]) & (sorted_lin < size_out)
    slot = torch.cumsum(is_first.long(), 0) - 1
    slot = torch.where(is_first, slot.clamp(max=out_budget), out_budget)
    out_lin = torch.full((out_budget + 1,), -1, dtype=torch.long, device=dev)
    out_lin.scatter_reduce_(0, slot, sorted_lin, reduce="amax")
    out_lin = out_lin[:out_budget]
    out_valid = out_lin >= 0
    safe = out_lin.clamp(min=0)
    _, h, w = grid_out
    out_coords = torch.stack([torch.div(safe, h * w, rounding_mode="floor"),
                              torch.div(safe, w, rounding_mode="floor") % h, safe % w], -1)
    return torch.where(out_valid[:, None], out_coords, -1).to(_I32), out_valid


def downsample_neighbor_table(out_coords: torch.Tensor, out_valid: torch.Tensor,
                              in_index_grid: torch.Tensor, grid_in: Sequence[int],
                              stride: Tuple[int, int, int], padding: Tuple[int, int, int],
                              ksize: Tuple[int, int, int]) -> torch.Tensor:
    """(Vo, K) int32 input rows feeding each output site: c = o*s - p + k."""
    dev = out_coords.device
    offs = torch.tensor(kernel_offsets(ksize), dtype=torch.long, device=dev)
    s = torch.tensor(stride, dtype=torch.long, device=dev)
    p = torch.tensor(padding, dtype=torch.long, device=dev)
    c = out_coords.long()[:, None, :] * s - p + offs[None]
    idx = _lookup(c, in_index_grid, grid_in)
    return torch.where(out_valid[:, None], idx, -1)


def gather_conv(features: torch.Tensor, neighbor_table: torch.Tensor, weights: torch.Tensor,
                bias=None) -> torch.Tensor:
    """Gather-GEMM-accumulate sparse conv: features (V_in, Cin), neighbor_table
    (V_out, K) int32 (-1 = no input), weights (K, Cin, Cout) -> (V_out, Cout)
    in the features' dtype. Per tap: gather (row 0 under a zero mask where the
    table holds -1), a product in float32 (at least), then a cast to the features' dtype
    before it is added, as the reference rounds after each tap."""
    vout, k = neighbor_table.shape
    acc = torch.promote_types(features.dtype, torch.float32)
    out = features.new_zeros((vout, weights.shape[-1]))
    for tap in range(k):
        idx = neighbor_table[:, tap]
        g = features[idx.clamp(min=0).long()] * (idx >= 0)[:, None].to(features.dtype)
        out = out + (g.to(acc) @ weights[tap].to(acc)).to(features.dtype)
    return out if bias is None else out + bias


def gather_conv_batched(features: torch.Tensor, neighbor_table: torch.Tensor,
                        weights: torch.Tensor, bias=None) -> torch.Tensor:
    """:func:`gather_conv` over a batch: features (B, V_in, Cin), table
    (B, V_out, K), weights (K, Cin, Cout) -> (B, V_out, Cout)."""
    b, vout, k = neighbor_table.shape
    bi = torch.arange(b, device=features.device)[:, None]
    acc = torch.promote_types(features.dtype, torch.float32)
    out = features.new_zeros((b, vout, weights.shape[-1]))
    for tap in range(k):
        idx = neighbor_table[:, :, tap]
        g = features[bi, idx.clamp(min=0).long()] * (idx >= 0)[..., None].to(features.dtype)
        out = out + (g.to(acc) @ weights[tap].to(acc)).to(features.dtype)
    return out if bias is None else out + bias


def build_index_grid_batched(coords, valid, grid):
    return torch.stack([build_index_grid(c, v, grid) for c, v in zip(coords, valid)])


def subm_neighbor_table_batched(coords, valid, index_grid, grid, ksize=(3, 3, 3)):
    return torch.stack([subm_neighbor_table(c, v, g, grid, ksize)
                        for c, v, g in zip(coords, valid, index_grid)])


def downsample_active_set_batched(coords, valid, grid_in, grid_out, stride, padding, ksize,
                                  out_budget):
    outs = [downsample_active_set(c, v, grid_in, grid_out, stride, padding, ksize, out_budget)
            for c, v in zip(coords, valid)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def downsample_neighbor_table_batched(out_coords, out_valid, in_index_grid, grid_in, stride,
                                      padding, ksize):
    return torch.stack([downsample_neighbor_table(oc, ov, g, grid_in, stride, padding, ksize)
                        for oc, ov, g in zip(out_coords, out_valid, in_index_grid)])


def conv_out_grid(grid_in: Sequence[int], stride: Tuple[int, int, int],
                  padding: Tuple[int, int, int], ksize: Tuple[int, int, int]
                  ) -> Tuple[int, int, int]:
    """Static output grid of a strided sparse conv."""
    return tuple((g + 2 * p - k) // s + 1
                 for g, s, p, k in zip(grid_in, stride, padding, ksize))


def scatter_to_dense(features: torch.Tensor, coords: torch.Tensor,
                     valid: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """(V, C) rows -> dense (D, H, W, C) (spconv ``SparseConvTensor.dense()``).

    Invalid rows go to one spare row past the end, which is cut off: the
    reference's ``.at[].set(mode="drop")`` drops them, and torch would raise
    on an out-of-range index."""
    d, h, w = grid
    z, y, x = coords.long().unbind(-1)
    ok = valid & (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    lin = torch.where(ok, (z * h + y) * w + x, d * h * w)
    canvas = features.new_zeros((d * h * w + 1, features.shape[-1]))
    canvas[lin] = features
    return canvas[:-1].view(d, h, w, features.shape[-1])
