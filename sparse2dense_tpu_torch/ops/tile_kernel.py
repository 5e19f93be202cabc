"""Tile engine with the fused tile subm conv ("tile", ``tile_backend=
"pallas"``): block plans, z-major tile state and its layouts, and the plain
version of the conv (counterpart of ``sparse2dense_tpu/ops/tile_kernel.py``
and of the constants of ``sparse2dense_tpu/ops/pallas/tile_block_kernel.py``).

State is z-major: (tz, T1p, 16C), one row per (z, tile) plane of a
(tz, 4, 4) chunk tile, cells ``y4 * 4 + x4``; tile ranks are the
lexicographic (bz, by, bx) ranks of ``tile_conv.build_tile_set``. The block
plan keeps the reference's nine rank windows per 128-tile block, one per
(dz, dy) cluster: a neighbour rank outside its window is written as
``SENTINEL`` and counted in ``n_miss`` (the ``tilek_miss`` telemetry), and the
conv leaves that tap out, as the TPU kernel does. The conv itself
(``tile_block_kernel.tile_subm``: a CUDA kernel on the card, the plain version
below on the CPU) reads neighbour planes straight from the state by ``tgt``;
it needs none of the TPU kernel's weight matrices or export arrays. Every
integer field (plans, states) is bit-exact against the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import tile_conv as TC

BLK = 128           # tiles per plan block
SENTINEL = 2 ** 30  # neighbour rank of an absent or out-of-window tile
GRAN = 16           # window-start granule of the plan

_I32 = torch.int32
_DIR_IDX = {d: i for i, d in enumerate(TC.DIRS)}


def dir_row(dz: int, dy: int, dx: int) -> int:
    """Row of direction (dz, dy, dx) in a plan's (nb, 32, 128) target block."""
    return ((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)


def t1p_of(budget: int) -> int:
    """Tile rows of a stage: the budget plus the phantom tile, in whole blocks."""
    return -(-(budget + 1) // BLK) * BLK


# ---------------------------------------------------------------------------
# block plan: one rank window per (dz, dy) cluster and block of 128 tiles
# ---------------------------------------------------------------------------

class TKPlan(NamedTuple):
    ws: torch.Tensor      # (nb, 9) int32 window starts / GRAN per cluster
    tgt: torch.Tensor     # (nb, 32, 128) int32 neighbour ranks, SENTINEL pad
    n_miss: torch.Tensor  # () int32 targets dropped for window overflow; (B,) batched


def make_block_plan(ts: TC.TileSet, t1p: int, w0: int, wz: int, rank_offset: int = 0) -> TKPlan:
    """Rank windows and targets of one sample's tile set: window ``w0``
    tiles for the same-layer clusters (dz = 0), ``wz`` for the z-side ones.
    Targets outside their cluster's window become SENTINEL and are counted.
    ``rank_offset`` shifts every rank (batch-flattened state); windows are
    placed before the shift, so they never cross samples."""
    budget = ts.tile_pos.shape[0]
    nb = t1p // BLK
    dev = ts.nbr.device
    w0 = min(w0, (t1p // GRAN) * GRAN)
    wz = min(wz, (t1p // GRAN) * GRAN)

    # (32, T1p) targets by dir_row; row 13 (the tile itself) and rows 27-31 SENTINEL
    tgt = torch.full((32, t1p), SENTINEL, dtype=torch.long, device=dev)
    for d, i in _DIR_IDX.items():
        r = ts.nbr[:, i].long()
        tgt[dir_row(*d), :budget] = torch.where(r < budget, r, SENTINEL)
    tgt = tgt.reshape(32, nb, BLK).permute(1, 0, 2).contiguous()   # (nb, 32, 128)

    ws_cols, miss = [], torch.zeros((), dtype=torch.long, device=dev)
    for ci in range(9):
        w = w0 if ci // 3 == 1 else wz
        g = tgt[:, 3 * ci:3 * ci + 3, :]
        lo = g.reshape(nb, -1).amin(1)                     # SENTINEL if none
        ws = torch.div(lo.clamp(0, max(t1p - w, 0)), GRAN, rounding_mode="floor") * GRAN
        inside = g < (ws[:, None, None] + w)
        miss = miss + ((g < SENTINEL) & ~inside).sum()
        tgt[:, 3 * ci:3 * ci + 3, :] = torch.where(inside, g, SENTINEL)
        ws_cols.append(ws // GRAN)
    tgt = torch.where(tgt < SENTINEL, tgt + rank_offset, SENTINEL)
    ws = torch.stack(ws_cols, -1) + rank_offset // GRAN
    return TKPlan(ws.to(_I32), tgt.to(_I32), miss.to(_I32))


def flatten_batch_plan(plans: Sequence[TKPlan]) -> TKPlan:
    """Per-sample plans, built with rank_offset = b * T1p, -> one plan over
    the (B * T1p) tiles; n_miss keeps the per-sample counts (B,) (the
    reference sums them)."""
    return TKPlan(torch.cat([p.ws for p in plans]), torch.cat([p.tgt for p in plans]),
                  torch.stack([p.n_miss for p in plans]))


def make_block_plan_batched(sets: Sequence[TC.TileSet], t1p: int, w0: int, wz: int) -> TKPlan:
    """Plan of a batch flattened to (B * T1p) tile rows."""
    return flatten_batch_plan([make_block_plan(ts, t1p, w0, wz, rank_offset=b * t1p)
                               for b, ts in enumerate(sets)])


# ---------------------------------------------------------------------------
# state and its layouts
# ---------------------------------------------------------------------------

def build_state(feats: torch.Tensor, coords: torch.Tensor, ts: TC.TileSet,
                grid: Sequence[int], ty: int, tx: int, tz: int, t1p: int):
    """(V, C) rows, (V, 3) zyx -> (state (tz, T1p, 16C), mask (tz, T1p, 16)),
    both in feats' dtype; rows of tiles past the budget are dropped."""
    assert (ty, tx) == (4, 4), "the tile kernel is specialised to 4x4 BEV tiles"
    key, valid, (nbz, nby, nbx) = TC._tile_keys(coords, grid, ty, tx, tz)
    budget = ts.tile_pos.shape[0]
    c = feats.shape[-1]
    rank = ts.tmap[torch.where(valid, key, nbz * nby * nbx)].long()
    in_set = valid & (rank < budget)
    z, y, x = coords.long().unbind(-1)
    cell = ((z % tz) * t1p + rank) * 16 + (y % ty) * 4 + x % tx
    nslot = tz * t1p * 16
    slot = torch.where(in_set, cell, nslot)
    buf = feats.new_zeros((nslot + 1, c)).index_add_(0, slot, feats)
    m = feats.new_zeros(nslot + 1)
    m[slot] = 1
    return buf[:nslot].reshape(tz, t1p, 16 * c), m[:nslot].reshape(tz, t1p, 16)


def build_state_batched(feats, coords, sets: Sequence[TC.TileSet], grid, ty, tx, tz, t1p):
    """Per-sample build_state, flattened to the batch-flat layout:
    (tz, B * T1p, 16C) state and (tz, B * T1p, 16) mask."""
    st, mk = zip(*[build_state(f, c, t, grid, ty, tx, tz, t1p)
                   for f, c, t in zip(feats, coords, sets)])
    return torch.cat(st, 1), torch.cat(mk, 1)


def expand_mask(mask: torch.Tensor, co: int) -> torch.Tensor:
    """(tz, T1p, 16) cell mask -> (tz, T1p, 16 * co), the conv output's layout."""
    return mask.repeat_interleave(co, dim=-1)


def state_to_planes_batched(state: torch.Tensor, b: int, t1p: int, tz: int,
                            t1: int) -> torch.Tensor:
    """(tz, B * T1p, 16C) -> chunk planes (B, t1 * tz, 4, 4, C), tile-major
    (t1 = tile budget + 1: the phantom tile last)."""
    c16 = state.shape[-1]
    st = state.reshape(tz, b, t1p, c16)[:, :, :t1]
    return st.permute(1, 2, 0, 3).reshape(b, t1 * tz, 4, 4, c16 // 16)


def planes_to_state_batched(p: torch.Tensor, tz: int, t1p: int) -> torch.Tensor:
    """Chunk planes (B, t1 * tz, 4, 4, C) -> (tz, B * T1p, 16C), tile rows
    padded with zeros."""
    b, n = p.shape[:2]
    c16 = 16 * p.shape[-1]
    st = p.reshape(b, n // tz, tz, c16).permute(2, 0, 1, 3)
    st = torch.cat([st, st.new_zeros((tz, b, t1p - n // tz, c16))], 2)
    return st.reshape(tz, b * t1p, c16)


def state_to_planes(state: torch.Tensor, tz: int, c: int) -> torch.Tensor:
    """(tz, T1p, 16C) -> chunk planes (T1p * tz, 4, 4, C), tile-major."""
    return state_to_planes_batched(state, 1, state.shape[1], tz, state.shape[1])[0]


def planes_to_state(p: torch.Tensor, tz: int) -> torch.Tensor:
    """Chunk planes (T1 * tz, 4, 4, C) -> (tz, T1p, 16C) with T1p =
    t1p_of(T1 - 1)."""
    return planes_to_state_batched(p[None], tz, t1p_of(p.shape[0] // tz - 1))


# ---------------------------------------------------------------------------
# the plain version of the fused tile subm conv
# ---------------------------------------------------------------------------

def _tap_sources(tz: int):
    """For tap k = kz*9 + ky*3 + kx: per output z, the source z-plane index
    in the source tile; per (z, cell), the plan row that names the source
    tile (27 = the tile itself); per cell, the source cell. A halo cell
    outside the chunk or the 4x4 tile is the mirrored cell of the neighbour
    tile in that direction."""
    zsrc, rows, cells = [], [], []
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                zs, rr, cc = [], [], []
                for z in range(tz):
                    zz = z + kz - 1
                    dz = -1 if zz < 0 else (1 if zz >= tz else 0)
                    zs.append(zz % tz)
                    rz = []
                    for y4 in range(4):
                        for x4 in range(4):
                            yy, xx = y4 + ky - 1, x4 + kx - 1
                            dy = -1 if yy < 0 else (1 if yy > 3 else 0)
                            dx = -1 if xx < 0 else (1 if xx > 3 else 0)
                            rz.append(27 if (dz, dy, dx) == (0, 0, 0) else dir_row(dz, dy, dx))
                            if z == 0:
                                cc.append((yy % 4) * 4 + xx % 4)
                    rr.append(rz)
                zsrc.append(zs)
                rows.append(rr)
                cells.append(cc)
    return zsrc, rows, cells


def tile_subm_plain(state: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
                    scale16: torch.Tensor, shift16: torch.Tensor, mask16: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """Plain version of the fused tile subm conv (contract of the reference's
    ``tile_subm_pallas`` without its export arrays). For tile row t, plane z
    and cell (y4, x4):

        acc = sum over taps (kz, ky, kx) of src(t; z+kz-1, y4+ky-1, x4+kx-1) @ w[tap]
        y = acc * scale16 + shift16 (+ residual); ReLU if relu; * mask16

    where src is tile t's own cell inside the chunk and the 4x4 tile, else
    the mirrored cell (z' mod tz, y' mod 4, x' mod 4) of the neighbour tile
    tgt[t // 128, dir_row(dz, dy, dx), t % 128] (SENTINEL, or any target
    outside [0, T1p), reads zero). state (tz, T1p, 16C); tgt (T1p // 128, 32,
    128) int32 global ranks; w (27, C, Co) z-major taps, rounded to the
    state's dtype; scale16 / shift16 (1, 16Co) f32; mask16 / residual (tz,
    T1p, 16Co). Products and sums in float32; returns (tz, T1p, 16Co) in the
    state's dtype."""
    tz, t1p, c16 = state.shape
    c, co = c16 // 16, w.shape[2]
    dev = state.device
    sv = torch.cat([state.float().reshape(tz, t1p, 16, c),
                    state.new_zeros((tz, 1, 16, c), dtype=torch.float32)], 1)
    tg = tgt.permute(1, 0, 2).reshape(32, t1p).long()
    tg = torch.where((tg >= 0) & (tg < t1p), tg, t1p)
    src_rows = torch.cat([tg[:27], torch.arange(t1p, device=dev)[None]])   # (28, T1p)
    wf = w.to(state.dtype).float()
    zsrc, rows, cells = (torch.tensor(a, device=dev) for a in _tap_sources(tz))
    acc = state.new_zeros((tz, t1p, 16, co), dtype=torch.float32)
    for k in range(27):
        r = src_rows[rows[k]].permute(0, 2, 1)                            # (tz, T1p, 16)
        acc += sv[zsrc[k][:, None, None], r, cells[k][None, None, :]] @ wf[k]
    y = acc.reshape(tz, t1p, 16 * co) * scale16.float() + shift16.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = y.clamp(min=0)
    return (y * mask16.float()).to(state.dtype)


def tk_subm_conv(state, plan: TKPlan, w, scale16, shift16, mask16, residual=None,
                 relu=True) -> torch.Tensor:
    """Fused tile subm conv + epilogue; w (27, C, Co) z-major taps. On CUDA
    tensors the hand-written kernel, on CPU tensors the plain version."""
    from .tile_block_kernel import tile_subm

    return tile_subm(state, plan.tgt, w, scale16, shift16, mask16, residual, relu)
