"""Occupied-tile sets of BEV tiles (counterpart of the parts of
``sparse2dense_tpu/ops/tile_conv.py`` that the plane and tile engines use).

A ``TileSet`` holds the occupied (z-chunk, by, bx) tiles of one stage, or,
with the plane engine, its occupied (by, bx, z) planes; ranks ascend with
the tile key. Rank ``T`` (the budget) stands for an absent tile: it indexes
an always-zero phantom row. Every integer field is bit-exact against the
reference.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

BIG = 2 ** 30      # key of an absent tile
_I32 = torch.int32


class TileSet(NamedTuple):
    """Occupied-tile structure of one stage (one batch element)."""

    tile_pos: torch.Tensor  # (T, 3) int32 (bz, by, bx) or (z, by, bx); -1 on padding
    valid: torch.Tensor     # (T,) bool
    nbr: torch.Tensor       # (T, 26) int32 neighbour ranks in DIRS order; T absent
    tmap: torch.Tensor      # (n_keys + 1,) int32 key -> rank (T absent)
    n_tiles: torch.Tensor   # () int32 occupied tile count (before the budget)
    n_drop: torch.Tensor    # () int32 rows or tiles lost to the budget


# the 26 neighbour directions (dz, dy, dx) != 0: faces, edges and corners
DIRS = tuple((dz, dy, dx)
             for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dz, dy, dx) != (0, 0, 0))


def tile_counts(grid: Sequence[int], ty: int, tx: int, tz: int) -> Tuple[int, int, int]:
    d, h, w = grid
    return -(-d // tz), -(-h // ty), -(-w // tx)


def _compact_keys(keys: torch.Tensor, budget: int, nkey: int):
    """Sorted-unique compaction of tile keys (BIG = absent) into ranks that
    ascend with the key: an occupancy scatter and a cumsum over the dense
    key space. JAX's ``.at[].max(mode="drop")`` scatters become scatters
    onto a spare slot that is cut off. Returns (tid (budget,) key or -1,
    tvalid, tmap (nkey + 1,), n_tiles)."""
    dev = keys.device
    keys = keys.long()
    valid = (keys >= 0) & (keys < nkey)
    occ = torch.zeros(nkey + 1, dtype=torch.long, device=dev)
    occ[torch.where(valid, keys, nkey)] = 1
    occ = occ[:nkey]
    csum = torch.cumsum(occ, 0)
    n_tiles = csum[-1].to(_I32)
    rank = torch.where(occ > 0, csum - 1, budget).clamp(max=budget)
    tmap = torch.cat([rank, rank.new_full((1,), budget)]).to(_I32)
    kk = torch.where(valid, keys, 0)
    slot = torch.where(valid, tmap[kk].long(), budget)
    tid = torch.full((budget + 1,), -1, dtype=torch.long, device=dev)
    tid.scatter_reduce_(0, slot, torch.where(valid, kk, -1), reduce="amax")
    tid = tid[:budget]
    return tid, tid >= 0, tmap, n_tiles


def _neighbor_ranks(tpos, tvalid, tmap, nbz, nby, nbx, budget):
    """(T, 26) neighbour ranks in DIRS order; rank = budget when absent."""
    nbrs = []
    for dbz, dby, dbx in DIRS:
        zz = tpos[:, 0] + dbz
        yy = tpos[:, 1] + dby
        xx = tpos[:, 2] + dbx
        ok = (tvalid & (zz >= 0) & (zz < nbz) & (yy >= 0) & (yy < nby)
              & (xx >= 0) & (xx < nbx))
        key = torch.where(ok, (zz * nby + yy) * nbx + xx, nbz * nby * nbx)
        nbrs.append(torch.where(ok, tmap[key.long()], budget))
    return torch.stack(nbrs, -1).to(_I32)


def _floor(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _tile_keys(coords: torch.Tensor, grid: Sequence[int], ty: int, tx: int, tz: int):
    """(V,) (bz, by, bx) chunk-tile key of each zyx row (undefined on padded
    rows), the valid-row mask and the tile counts."""
    nbz, nby, nbx = tile_counts(grid, ty, tx, tz)
    z, y, x = coords.long().unbind(-1)
    key = (_floor(z, tz) * nby + _floor(y, ty)) * nbx + _floor(x, tx)
    return key, (coords >= 0).all(-1), (nbz, nby, nbx)


def build_tile_set(coords: torch.Tensor, grid: Sequence[int], ty: int, tx: int, tz: int,
                   budget: int) -> Tuple[TileSet, torch.Tensor]:
    """Occupied (tz, ty, tx) chunk tiles of rows (V, 3) zyx (-1 padding).
    Returns (TileSet, row_slot) as :func:`row_slots` gives it; n_drop counts
    the valid rows whose tile fell past the budget."""
    key, valid, (nbz, nby, nbx) = _tile_keys(coords, grid, ty, tx, tz)
    tid, tvalid, tmap, n_tiles = _compact_keys(torch.where(valid, key, BIG), budget,
                                               nbz * nby * nbx)
    t = tid.clamp(min=0)
    tpos = torch.where(tvalid[:, None],
                       torch.stack([t // (nby * nbx), (t // nbx) % nby, t % nbx], -1),
                       -1).to(_I32)
    nbr = _neighbor_ranks(tpos, tvalid, tmap, nbz, nby, nbx, budget)
    ts = TileSet(tpos, tvalid, nbr, tmap, n_tiles, n_tiles.new_zeros(()))
    row_slot, in_set = row_slots(coords, ts, grid, ty, tx, tz)
    return ts._replace(n_drop=(valid & ~in_set).sum(dtype=_I32)), row_slot


def row_slots(coords: torch.Tensor, ts: TileSet, grid: Sequence[int], ty: int, tx: int,
              tz: int):
    """Flat slot of each zyx row inside the halo-padded (T+1, tz+2, ty+2,
    tx+2) tile buffer, and whether it is in the set; (NSLOT, False) for
    padded rows and rows of tiles past the budget."""
    key, valid, (nbz, nby, nbx) = _tile_keys(coords, grid, ty, tx, tz)
    budget = ts.tile_pos.shape[0]
    rank = ts.tmap[torch.where(valid, key, nbz * nby * nbx)].long()
    in_set = valid & (rank < budget)
    z, y, x = coords.long().unbind(-1)
    zi, yi, xi = z - _floor(z, tz) * tz + 1, y - _floor(y, ty) * ty + 1, x - _floor(x, tx) * tx + 1
    nslot = (budget + 1) * (tz + 2) * (ty + 2) * (tx + 2)
    flat = ((rank * (tz + 2) + zi) * (ty + 2) + yi) * (tx + 2) + xi
    return torch.where(in_set, flat, nslot).to(_I32), in_set


def _z_sources(pzn: int, pz: int, tz: int):
    """Static (chunk offset s, halo-padded buffer row, n rows) groups of the
    downsample patch's z rows: input z = bz' * tz + (m - pz), so the source
    chunk is bz' + floor((m - pz) / tz) and the buffer row is static."""
    groups = []
    for m in range(pzn):
        s = (m - pz) // tz
        r = (m - pz) - s * tz + 1
        if groups and groups[-1][0] == s and groups[-1][1] + groups[-1][2] == r:
            groups[-1][2] += 1
        else:
            groups.append([s, r, 1])
    return [tuple(g) for g in groups]


# index entries a chunk of the gather's backward handles at once
_TAKE_CHUNK = 2 ** 23


class _TakeRows(torch.autograd.Function):
    """``rows[idx]`` whose backward adds each entry's gradient into its row
    in float32 (``index_add_``) and skips the entries of the zero row. A
    source row is named a few times (the patches and halos that hold it),
    the zero row by every absent neighbour of a frame, so leaving it out
    keeps the adds from queueing on one row; a sorting backward
    (``F.embedding``'s) costs far more on the tens of millions of entries
    of a frame's patches."""

    @staticmethod
    def forward(ctx, rows, idx, zero):
        ctx.save_for_backward(idx)
        ctx.rows_shape, ctx.rows_dtype, ctx.zero = rows.shape, rows.dtype, zero
        return F.embedding(idx, rows, padding_idx=zero)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = grad.reshape(flat.shape[0], -1)
        out = g.new_zeros(ctx.rows_shape, dtype=torch.float32)
        for i in range(0, flat.shape[0], _TAKE_CHUNK):
            fi, gi = flat[i:i + _TAKE_CHUNK], g[i:i + _TAKE_CHUNK]
            named = fi != ctx.zero
            out.index_add_(0, fi[named], gi[named].float())
        return out.to(ctx.rows_dtype), None, None


def take_rows(rows: torch.Tensor, idx: torch.Tensor, zero: int) -> torch.Tensor:
    """rows[idx] for a (R, D) table whose row ``zero`` is always zero (the
    index of an absent tile or plane); its backward (:class:`_TakeRows`)
    adds the gradients in float32 and skips the zero row."""
    return _TakeRows.apply(rows, idx.long(), zero)


def tiles_to_dense(interior: torch.Tensor, ts: TileSet, grid: Sequence[int],
                   tz: int) -> torch.Tensor:
    """(T+1, tz, ty, tx, C) -> dense (D, H, W, C) by one rank gather per
    chunk (absent chunks read the phantom row T)."""
    d, h, w = grid
    t1, tzi, ty, tx, c = interior.shape
    assert tzi == tz
    nbz, nby, nbx = tile_counts(grid, ty, tx, tz)
    g = take_rows(interior.reshape(t1, -1), ts.tmap[:nbz * nby * nbx], t1 - 1)
    g = g.reshape(nbz, nby, nbx, tz, ty, tx, c).permute(0, 3, 1, 4, 2, 5, 6)
    return g.reshape(nbz * tz, nby * ty, nbx * tx, c)[:d, :h, :w, :]
