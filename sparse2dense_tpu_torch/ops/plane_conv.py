"""Active-plane submanifold conv engine ("plane"): plane sets, block plans,
plane state and the permutations to and from the chunk-planes layout
(counterpart of ``sparse2dense_tpu/ops/plane_conv.py`` and of the constants
of ``sparse2dense_tpu/ops/pallas/plane_block_kernel.py``).

The unit of work is an occupied z-plane of a 4x4 BEV tile: a (by, bx, z) key
holding at least one voxel. Planes are ranked lexicographically in
(by, bx, z), so the dz = +-1 neighbours of a plane are rank-adjacent. A plane
row of the state is (16 cells x C), cell = yi * 4 + xi. Every integer field
(sets, plans, permutations) is bit-exact against the reference.

The block plan keeps the reference's two rank windows per dy cluster: a
neighbour rank outside both windows is written as ``SENTINEL`` and counted in
``n_miss``, and the conv leaves that tap out, as the TPU kernel does. The
conv itself (``plane_kernel.plane_subm``: a CUDA kernel on the card, the
plain version below on the CPU) reads neighbour planes straight from the
state rows by ``tgt``; it needs none of the TPU kernel's export arrays.

In training the conv runs under autograd (``pk_subm_conv_train``,
``plane_kernel.PlaneConv``): the forward as above with an identity
epilogue, the backward the float32 VJP of the reference formula over the
batch's neighbour table (``flat_neighbor_ranks``, ``plane_conv_grad``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import tile_conv as TC

BLK = 128           # plane rows per plan block
SENTINEL = 2 ** 30  # neighbour rank of an absent or out-of-window plane
GRAN = 16           # window-start granule of the plan

_I32 = torch.int32


def dir_row(dz: int, dy: int, dx: int) -> int:
    """Row of direction (dz, dy, dx) in a plan's (nb, 32, 128) target block."""
    return ((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)


def t1p_of(budget: int) -> int:
    """Plane rows of a stage: the budget plus a zero row, in whole blocks."""
    return -(-(budget + 1) // BLK) * BLK


def _plane_grid(grid: Sequence[int]):
    d, h, w = grid
    nby, nbx = -(-h // 4), -(-w // 4)
    return d, nby, nbx, nby * nbx * d


def plane_key(coords: torch.Tensor, grid: Sequence[int]):
    """(V,) lexicographic (by, bx, z) plane key; BIG for padded rows."""
    d, _, nbx, _ = _plane_grid(grid)
    z, y, x = coords.long().unbind(-1)
    valid = (coords >= 0).all(-1)
    key = (torch.div(y, 4, rounding_mode="floor") * nbx
           + torch.div(x, 4, rounding_mode="floor")) * d + z
    return torch.where(valid, key, TC.BIG), valid


def _plane_nbr(tpos, tvalid, tmap, grid, budget):
    """(T, 26) neighbour plane ranks in tile_conv.DIRS order, budget absent."""
    d, nby, nbx, nkey = _plane_grid(grid)
    dirs = torch.tensor(TC.DIRS, dtype=torch.long, device=tpos.device)
    tp = tpos.long()
    zz = tp[:, 0:1] + dirs[None, :, 0]
    yy = tp[:, 1:2] + dirs[None, :, 1]
    xx = tp[:, 2:3] + dirs[None, :, 2]
    ok = (tvalid[:, None] & (zz >= 0) & (zz < d) & (yy >= 0) & (yy < nby)
          & (xx >= 0) & (xx < nbx))
    k = torch.where(ok, (yy * nbx + xx) * d + zz, nkey)
    return torch.where(ok, tmap[k], budget).to(_I32)


def _plane_tileset(tid, tvalid, tmap, n_tiles, grid, budget, n_drop) -> TC.TileSet:
    d, _, nbx, _ = _plane_grid(grid)
    t = tid.clamp(min=0)
    tpos = torch.where(tvalid[:, None],
                       torch.stack([t % d, t // (nbx * d), (t // d) % nbx], -1),
                       -1).to(_I32)
    return TC.TileSet(tpos, tvalid, _plane_nbr(tpos, tvalid, tmap, grid, budget), tmap,
                      n_tiles, n_drop)


def _plane_set_from_keys(keys: torch.Tensor, grid: Sequence[int], budget: int) -> TC.TileSet:
    """Compact (by, bx, z) plane keys (BIG = absent) into a plane TileSet:
    (z, by, bx) tile_pos rows, 26-direction neighbour table."""
    tid, tvalid, tmap, n_tiles = TC._compact_keys(keys, budget, _plane_grid(grid)[3])
    return _plane_tileset(tid, tvalid, tmap, n_tiles, grid, budget,
                          (n_tiles - budget).clamp(min=0))


def build_plane_set(coords: torch.Tensor, grid: Sequence[int], budget: int):
    """Occupied-plane set of rows (V, 3) zyx. Returns (TileSet, in_set);
    n_drop counts the valid rows whose plane fell past the budget."""
    nkey = _plane_grid(grid)[3]
    key, valid = plane_key(coords, grid)
    tid, tvalid, tmap, n_tiles = TC._compact_keys(key, budget, nkey)
    rank = tmap[torch.where(valid, key, nkey)]
    in_set = valid & (rank < budget)
    n_drop = (valid & ~in_set).sum(dtype=_I32)
    return _plane_tileset(tid, tvalid, tmap, n_tiles, grid, budget, n_drop), in_set


def plane_set_from_chunk_mask(mask: torch.Tensor, ts_chunk: TC.TileSet,
                              grid: Sequence[int], tz: int, budget: int) -> TC.TileSet:
    """Occupied-plane set of a chunk-planes stage output: mask
    (N = (T+1) * tz, ty, tx, 1) with the phantom chunk last; a plane
    (by, bx, z) is occupied iff a cell of its chunk row is active."""
    d, _, nbx, _ = _plane_grid(grid)
    t1 = mask.shape[0] // tz
    tpos = ts_chunk.tile_pos.long()
    occ = (mask.reshape(t1, tz, -1) > 0).any(-1)[:t1 - 1]
    z = tpos[:, 0:1] * tz + torch.arange(tz, device=mask.device)[None, :]
    ok = occ & (tpos[:, 0:1] >= 0) & (z < d)
    key = (tpos[:, 1:2] * nbx + tpos[:, 2:3]) * d + z
    return _plane_set_from_keys(torch.where(ok, key, TC.BIG).reshape(-1), grid, budget)


def chunk_set_of_planes(plane_ts: TC.TileSet, grid: Sequence[int], tz: int,
                        budget_t: int) -> TC.TileSet:
    """Chunk (z-major tz-chunk) TileSet covering a plane set, ranked
    lexicographically in (bz, by, bx)."""
    nbz, nby, nbx = TC.tile_counts(grid, 4, 4, tz)
    ppos = plane_ts.tile_pos.long()
    ok = ppos[:, 0] >= 0
    key = (torch.div(ppos[:, 0], tz, rounding_mode="floor") * nby + ppos[:, 1]) * nbx + ppos[:, 2]
    tid, tvalid, tmap, n_tiles = TC._compact_keys(torch.where(ok, key, TC.BIG), budget_t,
                                                  nbz * nby * nbx)
    t = tid.clamp(min=0)
    tpos = torch.where(tvalid[:, None],
                       torch.stack([t // (nby * nbx), (t // nbx) % nby, t % nbx], -1),
                       -1).to(_I32)
    nbr = TC._neighbor_ranks(tpos, tvalid, tmap, nbz, nby, nbx, budget_t)
    return TC.TileSet(tpos, tvalid, nbr, tmap, n_tiles, (n_tiles - budget_t).clamp(min=0))


# ---------------------------------------------------------------------------
# block plan: two rank windows per dy cluster and block of 128 planes
# ---------------------------------------------------------------------------

class PKPlan(NamedTuple):
    ws: torch.Tensor      # (nb, 3, 2) int32 window starts / GRAN
    tgt: torch.Tensor     # (nb, 32, 128) int32 neighbour ranks, SENTINEL pad
    n_miss: torch.Tensor  # () int32 targets dropped (outside both windows); (B,) batched
    nbr: Optional[torch.Tensor] = None  # (B * T1p, 26) flat_neighbor_ranks, for the backward


_DIR_IDX = {d: i for i, d in enumerate(TC.DIRS)}


def _cluster_rows(dy: int) -> List[int]:
    return [dir_row(dz, dy, dx) for dz in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dz, dy, dx) != (0, 0, 0)]


def make_plane_plan(ts: TC.TileSet, t1p: int, w0: int, wy: int, rank_offset: int = 0) -> PKPlan:
    """Two rank windows per dy cluster per 128-plane block (a block that
    straddles a BEV tile-row boundary has bimodal neighbour ranks; the
    second window covers the second mode). Targets outside both windows
    become SENTINEL and are counted. ``rank_offset`` shifts every rank
    (batch-flattened state)."""
    budget = ts.tile_pos.shape[0]
    nb = t1p // BLK
    dev = ts.nbr.device
    wcap = (t1p // GRAN) * GRAN
    # windows rounded up to a GRAN multiple, as the reference rounds them
    w0 = min(-(-w0 // GRAN) * GRAN, wcap)
    wy = min(-(-wy // GRAN) * GRAN, wcap)

    tgt = torch.full((32, t1p), SENTINEL, dtype=torch.long, device=dev)
    for d, i in _DIR_IDX.items():
        r = ts.nbr[:, i].long()
        tgt[dir_row(*d), :budget] = torch.where(r < budget, r, SENTINEL)
    tgt = tgt.reshape(32, nb, BLK).permute(1, 0, 2).contiguous()   # (nb, 32, 128)

    ws_cols, miss = [], torch.zeros((), dtype=torch.long, device=dev)
    for ci in range(3):
        w = w0 if ci == 1 else wy
        idx = torch.tensor(_cluster_rows(ci - 1), device=dev)
        g = tgt[:, idx, :]
        lo = g.reshape(nb, -1).amin(1)
        ws0 = torch.div(lo.clamp(0, max(t1p - w, 0)), GRAN, rounding_mode="floor") * GRAN
        in0 = g < (ws0[:, None, None] + w)
        lo1 = torch.where(in0, SENTINEL, g).reshape(nb, -1).amin(1)
        lo1 = torch.where(lo1 >= SENTINEL, ws0 + w, lo1)
        ws1 = torch.div(lo1.clamp(0, max(t1p - w, 0)), GRAN, rounding_mode="floor") * GRAN
        # ranks of window 1 below the end of window 0 belong to window 0
        in1 = (g >= torch.maximum(ws1, ws0 + w)[:, None, None]) & (g < (ws1[:, None, None] + w))
        inside = in0 | in1
        miss = miss + ((g < SENTINEL) & ~inside).sum()
        tgt[:, idx, :] = torch.where(inside, g, SENTINEL)
        ws_cols.append(torch.stack([ws0 // GRAN, ws1 // GRAN], -1))
    tgt = torch.where(tgt < SENTINEL, tgt + rank_offset, SENTINEL)
    ws = torch.stack(ws_cols, 1) + rank_offset // GRAN
    return PKPlan(ws.to(_I32), tgt.to(_I32), miss.to(_I32))


def make_plane_plan_batched(sets: Sequence[TC.TileSet], t1p: int, w0: int, wy: int) -> PKPlan:
    """Plan of a batch flattened to (B * T1p) plane rows: sample b's ranks
    are offset by b * T1p. n_miss holds the per-sample counts (B,) (the
    reference sums them)."""
    plans = [make_plane_plan(ts, t1p, w0, wy, rank_offset=b * t1p)
             for b, ts in enumerate(sets)]
    return PKPlan(torch.cat([p.ws for p in plans]), torch.cat([p.tgt for p in plans]),
                  torch.stack([p.n_miss for p in plans]))


def flat_neighbor_ranks(sets: Sequence[TC.TileSet], t1p: int) -> torch.Tensor:
    """Plane sets of a batch -> (B * T1p, 26) global neighbour ranks in
    ``tile_conv.DIRS`` order for the batch-flattened plane state; an absent
    neighbour, and every row past a set's budget, points at the sample's
    first always-zero row (rank ``budget``)."""
    out = []
    for b, ts in enumerate(sets):
        budget = ts.nbr.shape[0]
        n = torch.cat([ts.nbr.clamp(max=budget),
                       ts.nbr.new_full((t1p - budget, 26), budget)])
        out.append(n + b * t1p)
    return torch.cat(out).to(_I32)


# ---------------------------------------------------------------------------
# state and epilogue
# ---------------------------------------------------------------------------

def build_plane_state(feats: torch.Tensor, coords: torch.Tensor, ts: TC.TileSet,
                      grid: Sequence[int], t1p: int):
    """(V, C) rows -> ((T1p, 16C) plane rows, (T1p, 16) occupancy), both in
    feats' dtype; rows of planes past the budget are dropped."""
    nkey = _plane_grid(grid)[3]
    budget = ts.tile_pos.shape[0]
    c = feats.shape[-1]
    key, valid = plane_key(coords, grid)
    rank = ts.tmap[torch.where(valid, key, nkey)].long()
    in_set = valid & (rank < budget)
    cell = rank * 16 + (coords[:, 1].long() % 4) * 4 + coords[:, 2].long() % 4
    nslot = t1p * 16
    slot = torch.where(in_set, cell, nslot)
    buf = feats.new_zeros((nslot + 1, c)).index_add_(0, slot, feats)
    m = feats.new_zeros(nslot + 1)
    m[slot] = 1
    return buf[:nslot].reshape(t1p, 16 * c), m[:nslot].reshape(t1p, 16)


def expand_mask(mask: torch.Tensor, co: int) -> torch.Tensor:
    """(T1p, 16) cell mask -> (T1p, 16 * co), the layout of the conv output."""
    return mask.repeat_interleave(co, dim=-1)


def fold_epilogue(co: int, bias=None, bn_scale=None, bn_bias=None, bn_mean=None,
                  bn_var=None, eps: float = 1e-5):
    """Conv bias + inference BatchNorm folded into (1, 16co) float32 scale
    and shift vectors: y = x * scale + shift (``ops/tile_kernel.py``'s
    ``fold_epilogue``; PlaneKBlock passes the BatchNorm's eps 1e-3)."""
    dev = next((t.device for t in (bias, bn_scale) if t is not None), None)
    scale = torch.ones(co, dtype=torch.float32, device=dev)
    shift = torch.zeros(co, dtype=torch.float32, device=dev)
    if bias is not None:
        shift = shift + bias.float()
    if bn_scale is not None:
        s = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
        shift = (shift - bn_mean.float()) * s + bn_bias.float()
        scale = scale * s
    return scale.repeat(16)[None, :], shift.repeat(16)[None, :]


def _tap_sources():
    """For tap k = kz*9 + ky*3 + kx and output cell (y4, x4): the plan row
    that names the source plane (27 = the plane itself) and the source cell,
    mirrored into the neighbour tile as in the reference's halo."""
    rows, cells = [], []
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                rr, cc = [], []
                for y4 in range(4):
                    for x4 in range(4):
                        yy, xx = y4 + ky - 1, x4 + kx - 1
                        dyb = -1 if yy < 0 else (1 if yy > 3 else 0)
                        dxb = -1 if xx < 0 else (1 if xx > 3 else 0)
                        own = kz == 1 and dyb == 0 and dxb == 0
                        rr.append(27 if own else dir_row(kz - 1, dyb, dxb))
                        cc.append((yy % 4) * 4 + xx % 4)
                rows.append(rr)
                cells.append(cc)
    return rows, cells


TAP_ROWS, TAP_CELLS = _tap_sources()


def plane_subm_plain(state: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
                     scale16: torch.Tensor, shift16: torch.Tensor, mask16: torch.Tensor,
                     residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """Plain version of the fused plane subm conv (contract of the
    reference's ``plane_subm_pallas``). For plane row p and cell (y4, x4):

        acc = sum over taps (kz, ky, kx) of src(p, kz, y4+ky-1, x4+kx-1) @ w[tap]
        y = acc * scale16 + shift16 (+ residual); ReLU if relu; * mask16

    where src is the plane's own cell at kz = 1 inside the tile, else the
    mirrored cell of neighbour plane tgt[p // 128, dir_row, p % 128]
    (SENTINEL reads zero). state (T1p, 16C); tgt (T1p // 128, 32, 128) int32
    global ranks; w (27, C, Co) z-major taps, rounded to the state's dtype;
    scale16 / shift16 (1, 16Co) f32; mask16 / residual (T1p, 16Co). Products
    and sums in float32; returns (T1p, 16Co) in the state's dtype."""
    t1p, c16 = state.shape
    c, co = c16 // 16, w.shape[2]
    dev = state.device
    sv = torch.cat([state.float().reshape(t1p, 16, c), state.new_zeros((1, 16, c)).float()])
    tg = tgt.permute(1, 0, 2).reshape(32, t1p).long()
    tg = torch.where((tg >= 0) & (tg < t1p), tg, t1p)
    src_rows = torch.cat([tg[:27], torch.arange(t1p, device=dev)[None]])   # (28, T1p)
    wf = w.to(state.dtype).float()
    acc = state.new_zeros((t1p, 16, co), dtype=torch.float32)
    for k in range(27):
        rows = src_rows[torch.tensor(TAP_ROWS[k], device=dev)].T          # (T1p, 16)
        cells = torch.tensor(TAP_CELLS[k], device=dev)
        acc += sv[rows, cells[None, :]] @ wf[k]
    y = acc.reshape(t1p, 16 * co) * scale16.float() + shift16.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = y.clamp(min=0)
    return (y * mask16.float()).to(state.dtype)


def _rows_of_nbr(nbr: torch.Tensor) -> torch.Tensor:
    """(28, N) source plane of each plan row from an (N, 26) neighbour table
    in ``tile_conv.DIRS`` order (``flat_neighbor_ranks``)."""
    n = nbr.shape[0]
    rows = torch.full((28, n), n, dtype=torch.long, device=nbr.device)
    for d, i in _DIR_IDX.items():
        rows[dir_row(*d)] = nbr[:, i].long()
    rows[27] = torch.arange(n, device=nbr.device)
    return rows


# the halo of a 4x4 plane: for a tile offset (-1, 0 or +1 along y or x),
# the rows (columns) of the neighbour tile it gives and where they land in
# the 6x6 halo
_HALO = {-1: (slice(3, 4), slice(0, 1)), 0: (slice(0, 4), slice(1, 5)),
         1: (slice(0, 1), slice(5, 6))}


def _halos(x: torch.Tensor, rows: torch.Tensor):
    """The reference formula's halos, one dz at a time: yields (kz, (N, 6, 6,
    C) float32) with the plane, or its dz neighbour, in the centre and the
    edge cells of the 8 (dy, dx) neighbours around it (zero where absent).
    x (N, 16, C); rows (28, N) in [0, N] (N reads zero). Each piece of a
    plane that a halo takes is cut out once (its "export") and gathered by
    plane rank, so no cell is read more often than the halos hold it."""
    n, _, c = x.shape
    xz = torch.cat([x.float(), x.new_zeros((1, 16, c), dtype=torch.float32)]).view(n + 1, 4, 4, c)
    exports = {(dyb, dxb): xz[:, ys, xs].contiguous()
               for dyb, (ys, _) in _HALO.items() for dxb, (xs, _) in _HALO.items()}
    for kz in range(3):
        h = xz.new_empty((n, 6, 6, c))
        for dyb, (_, yd) in _HALO.items():
            for dxb, (_, xd) in _HALO.items():
                r = rows[27] if (kz, dyb, dxb) == (1, 0, 0) else rows[dir_row(kz - 1, dyb, dxb)]
                h[:, yd, xd] = exports[dyb, dxb].index_select(0, r)
        yield kz, h.permute(0, 3, 1, 2)                                   # (N, C, 6, 6)


def _halo_conv(x: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The linear plane conv as the reference formula computes it: one VALID
    3x3 2D conv a dz over the halos (:func:`_halos`), float32. x (N, 16, C),
    rows (28, N), w (27, C, Co) z-major taps -> (N, 16, Co)."""
    n, _, c = x.shape
    co = w.shape[2]
    wk = w.float().reshape(3, 3, 3, c, co).permute(0, 4, 3, 1, 2)       # (kz, Co, C, ky, kx)
    out = sum(F.conv2d(h, wk[kz]) for kz, h in _halos(x, rows))        # (N, Co, 4, 4)
    return out.permute(0, 2, 3, 1).reshape(n, 16, co)


def _halo_conv_weight(x: torch.Tensor, rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(27, C, Co) weight gradient of :func:`_halo_conv` for the output
    gradient g (N, 16, Co): a dz, the 2D conv's weight gradient over the
    halos; float32."""
    n, _, c = x.shape
    co = g.shape[2]
    gy = g.float().reshape(n, 4, 4, co).permute(0, 3, 1, 2)
    dw = torch.stack([torch.nn.grad.conv2d_weight(h, (co, c, 3, 3), gy)
                      for _, h in _halos(x, rows)])                     # (kz, Co, C, ky, kx)
    return dw.permute(0, 3, 4, 2, 1).reshape(27, c, co)


def plane_conv_grad(state: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor,
                    grad: torch.Tensor, need_state: bool = True):
    """(d state or None, d w) of the linear plane conv over the neighbour
    table ``nbr`` ((N, 26) ``flat_neighbor_ranks``; the reference's
    ``plane_subm_reference``: the conv and the output mask, no bias, BN or
    ReLU) for the output gradient ``grad`` (N, 16Co), already masked, in
    float32 (cuDNN's TF32 off): its VJP with no scatter, on the reference
    formula's halos (:func:`_halos`). The plane neighbour relation is
    symmetric (q is p's neighbour in direction d iff p is q's in -d), so d
    state is the same plane conv of the gradient with the taps mirrored
    (tap k reads what tap 26 - k wrote) and transposed (Co x C); d w is the
    weight gradient of each dz's 2D conv over the state's halos. Rows that
    no plane reads (the samples' always-zero rows, which absent neighbours
    name) get no gradient: they are zero in every state."""
    n, c16 = state.shape
    co = w.shape[2]
    rows = _rows_of_nbr(nbr)
    g = grad.float().reshape(n, 16, co)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        dw = _halo_conv_weight(state.reshape(n, 16, c16 // 16), rows, g).to(w.dtype)
        if not need_state:
            return None, dw
        wt = w.to(state.dtype).float().flip(0).transpose(1, 2)
        return _halo_conv(g, rows, wt).reshape(n, c16).to(state.dtype), dw


def pk_subm_conv(state, plan: PKPlan, w, scale16, shift16, mask16, residual=None,
                 relu=True) -> torch.Tensor:
    """Fused plane subm conv + epilogue; w (27, C, Co) z-major taps. On CUDA
    tensors the hand-written kernel, on CPU tensors the plain version."""
    from .plane_kernel import plane_subm

    return plane_subm(state, plan.tgt, w, scale16, shift16, mask16, residual, relu)


def pk_subm_conv_train(state, plan: PKPlan, w, mask16) -> torch.Tensor:
    """Trainable plane subm conv: the masked linear conv only (the caller
    adds the bias, train-mode BatchNorm, ReLU and residual), w (27, C, Co)
    z-major taps; ``plan.nbr`` holds the batch's ``flat_neighbor_ranks``.
    The fused conv forward (the kernel on CUDA tensors), the float32 VJP of
    the plain formula backward (``plane_kernel.PlaneConv``,
    :func:`plane_conv_grad`)."""
    from .plane_kernel import PlaneConv

    return PlaneConv.apply(state, w, mask16, plan)


# ---------------------------------------------------------------------------
# plane rows <-> chunk planes layout (around the downsample)
# ---------------------------------------------------------------------------

def plane_ranks_of_chunks(tile_ts: TC.TileSet, plane_ts: TC.TileSet, grid: Sequence[int],
                          tz: int, budget_p: int) -> torch.Tensor:
    """(T1_tile, tz) plane rank of each (chunk tile, zi), the phantom tile
    last; rank ``budget_p`` (an always-zero row) where the plane is absent."""
    d = grid[0]
    _, nby, nbx = TC.tile_counts(grid, 4, 4, tz)
    tpos = torch.cat([tile_ts.tile_pos, tile_ts.tile_pos.new_full((1, 3), -1)]).long()
    zg = tpos[:, 0:1] * tz + torch.arange(tz, device=tpos.device)[None, :]
    ok = (tpos[:, 0:1] >= 0) & (zg < d)
    key = torch.where(ok, (tpos[:, 1:2] * nbx + tpos[:, 2:3]) * d + zg, d * nby * nbx)
    pr = plane_ts.tmap[key]
    return torch.where(ok & (pr < budget_p), pr, budget_p).to(_I32)


def chunk_ranks_of_planes(plane_ts: TC.TileSet, tile_ts: TC.TileSet, grid: Sequence[int],
                          tz: int, budget_t: int) -> torch.Tensor:
    """(P,) row of each plane in the chunk-planes layout (rank * tz + zi);
    absent planes point at the phantom tile's row (always zero)."""
    _, nby, nbx = TC.tile_counts(grid, 4, 4, tz)
    ppos = plane_ts.tile_pos.long()
    ok = ppos[:, 0] >= 0
    bz = torch.div(ppos[:, 0], tz, rounding_mode="floor")
    key = (bz * nby + ppos[:, 1]) * nbx + ppos[:, 2]
    tr = tile_ts.tmap[torch.where(ok, key, tile_ts.tmap.shape[0] - 1)].long()
    tr = torch.where(ok & (tr < budget_t), tr, budget_t)
    zi = torch.where(ok, ppos[:, 0] - bz * tz, 0)
    return (tr * tz + zi).to(_I32)


def planes_to_plane_state(p: torch.Tensor, prank_rows: torch.Tensor, t1p: int) -> torch.Tensor:
    """Chunk planes (N, ty, tx, C) + (P,) chunk row per plane -> (T1p, 16C)
    plane rows (absent planes read a zero row)."""
    n, ty, tx, c = p.shape
    rows = torch.cat([p.reshape(n, 16 * c), p.new_zeros((1, 16 * c))])
    out = TC.take_rows(rows, prank_rows.long().clamp(max=n), n)
    return torch.cat([out, out.new_zeros((t1p - out.shape[0], 16 * c))])


def plane_state_to_planes(state: torch.Tensor, plane_of_chunk: torch.Tensor,
                          tz: int) -> torch.Tensor:
    """(T1p, 16C) plane rows + (T1_tile, tz) plane rank per chunk row ->
    chunk planes (T1_tile * tz, 4, 4, C)."""
    t1p, c16 = state.shape
    rows = torch.cat([state, state.new_zeros((1, c16))])
    return TC.take_rows(rows, plane_of_chunk.reshape(-1).long().clamp(max=t1p),
                        t1p).reshape(-1, 4, 4, c16 // 16)
