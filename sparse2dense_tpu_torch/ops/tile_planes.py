"""Strided convs of the plane and tile engines in the chunk-planes layout
(counterpart of ``downsample``, ``zconv``, ``to_dense`` and ``_pad_phantom``
of ``sparse2dense_tpu/ops/tile_planes.py``).

State is interior plane rows y (N, ty, tx, C), N = (T+1) * tz: the rows of
(tz-chunk, by, bx) tiles of 4x4 BEV cells, the phantom tile T last. The
reference gathers neighbour tiles with a one-hot MXU gather whose window
misses it patches exactly and counts (``halo_miss``); on a GPU a gather is
native, so this module gathers the rows directly (zero where a tile is
absent), which is what the patched one-hot gather returns. ``halo_miss`` has
no counterpart here: it counts window misses of that TPU gather only. The
stride-2 conv runs as ``F.conv2d`` per z tap, as the reference runs it in
XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import tile_conv as TC

_I32 = torch.int32


def _pad_phantom(x: torch.Tensor) -> torch.Tensor:
    """(T, ...) -> (T+1, ...) with a zero phantom row at rank T."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def _ceil2(x: torch.Tensor) -> torch.Tensor:
    return -torch.div(-x, 2, rounding_mode="floor")


def _cast(x, dtype):
    return x if dtype is None else x.to(dtype)


def downsample(y: torch.Tensor, mask: torch.Tensor, ts: TC.TileSet, grid: Sequence[int],
               w: torch.Tensor, ksize: Tuple[int, int, int], padding: Tuple[int, int, int],
               tz: int, tz_out: int, budget_out: int, compute_dtype=None):
    """Strided (2, 2, 2) sparse conv in the chunk-planes layout. Needs
    ksize (3, 3, 3), padding (pz, 1, 1) and 2 * tz_out == tz or a single
    output chunk. y (N, ty, tx, C); mask (N, ty, tx, 1); w (27, C, Co)
    z-major taps. Every output tile takes up to 8 candidates per occupied
    input tile (the round-5 two-candidate y/x rule), and
    ``ts_out.n_drop`` counts active input cells whose every candidate
    output tile was lost to ``budget_out``. Returns (y_out, mask_out,
    ts_out, grid_out) with the phantom tile appended."""
    d, h, w_g = grid
    n, ty, tx, cin = y.shape
    t1 = n // tz
    kz, ky, kx = ksize
    pz = padding[0]
    assert (ky, kx) == (3, 3) and padding[1] == 1 and padding[2] == 1
    dev = y.device
    nbz, nby, nbx = TC.tile_counts(grid, ty, tx, tz)
    d_out = (d + 2 * pz - kz) // 2 + 1
    grid_out = (d_out, (h + 2 - 3) // 2 + 1, (w_g + 2 - 3) // 2 + 1)
    nbzo, nbyo, nbxo = TC.tile_counts(grid_out, ty, tx, tz_out)
    assert 2 * tz_out == tz or nbzo == 1

    # ---- output tile set ------------------------------------------------
    tp = ts.tile_pos.long()
    zlo_in = tp[:, 0] * tz
    zplo = _ceil2(zlo_in + pz - kz + 1).clamp(0, d_out - 1)
    zphi = torch.div(zlo_in + tz - 1 + pz, 2, rounding_mode="floor").clamp(0, d_out - 1)
    byo = torch.div(tp[:, 1], 2, rounding_mode="floor")
    bxo = torch.div(tp[:, 2], 2, rounding_mode="floor")
    # an input row at a tile's high edge also reaches the next output tile
    byo2 = torch.div(tp[:, 1] + 1, 2, rounding_mode="floor")
    bxo2 = torch.div(tp[:, 2] + 1, 2, rounding_mode="floor")
    cand = []
    for zp_ in (zplo, zphi):
        for yc in (byo, byo2):
            for xc in (bxo, bxo2):
                ok = ts.valid & (yc < nbyo) & (xc < nbxo)
                k_ = (torch.div(zp_, tz_out, rounding_mode="floor") * nbyo + yc) * nbxo + xc
                cand.append(torch.where(ok, k_, TC.BIG))
    tid, tvalid, tmap_out, n_out = TC._compact_keys(torch.cat(cand), budget_out,
                                                    nbzo * nbyo * nbxo)
    t = tid.clamp(min=0)
    tpos = torch.where(tvalid[:, None],
                       torch.stack([t // (nbyo * nbxo), (t // nbxo) % nbyo, t % nbxo], -1),
                       -1).to(_I32)

    # ---- input patch (T_out, pzn, 2ty+2, 2tx+2, C): every cell from the
    # source tile that holds it (4x4 source tiles around the 2x2 children)
    pzn = 2 * tz_out + kz - 2
    zgroups = TC._z_sources(pzn, pz, tz)
    s_vals = sorted({g[0] for g in zgroups})
    to = tpos.long()
    bz_src = to[:, 0] if 2 * tz_out == tz else torch.zeros_like(to[:, 0])
    ab = torch.arange(4, device=dev)
    sy = (to[:, 1] * 2 - 1)[:, None, None, None] + ab[:, None]          # (T, 1, 4, 1)
    sx = (to[:, 2] * 2 - 1)[:, None, None, None] + ab                   # (T, 1, 1, 4)
    sz = bz_src[:, None, None, None] + torch.tensor(s_vals, device=dev)[:, None, None]
    ok = (tvalid[:, None, None, None] & (sz >= 0) & (sz < nbz) & (sy >= 0) & (sy < nby)
          & (sx >= 0) & (sx < nbx))
    key = torch.where(ok, (sz * nby + sy) * nbx + sx, nbz * nby * nbx)
    rank = torch.where(ok, ts.tmap[key].long(), t1 - 1)
    rank = torch.where(rank < t1 - 1, rank, t1)          # t1: the zero row appended below
    # static maps of the patch axes: z row -> (source chunk, row in it);
    # y (x) -> (source tile a (b) in 0..3, cell row (column) in it)
    zs, zr = zip(*[(s_vals.index(s), r0 - 1 + i) for s, r0, nr in zgroups for i in range(nr)])
    a_of = [0] + [1] * ty + [2] * ty + [3]
    i_of = [ty - 1] + list(range(ty)) * 2 + [0]
    t_ = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    rk = rank[:, t_(zs)[:, None, None], t_(a_of)[None, :, None], t_(a_of)[None, None, :]]
    cell = t_(i_of)[:, None] * tx + t_(i_of)[None, :]
    rows = (rk * tz + t_(zr)[:, None, None]) * (ty * tx) + cell      # (T, pzn, 2ty+2, 2tx+2)
    src = torch.cat([y, mask.to(y.dtype)], -1).reshape(n * ty * tx, cin + 1)
    src = torch.cat([src, src.new_zeros((1, cin + 1))])               # a zero row
    zero = n * ty * tx
    both = TC.take_rows(src, torch.where(rk == t1, zero, rows), zero)
    patch, mpatch = _cast(both[..., :cin], compute_dtype), both[..., cin:].to(mask.dtype)

    # ---- stride-2 VALID conv, one 2D conv per z tap ---------------------
    wk = _cast(w, compute_dtype).reshape(kz, 3, 3, cin, -1)
    cout = wk.shape[-1]
    out = None
    for iz in range(kz):
        zsl = patch[:, iz:iz + 2 * (tz_out - 1) + 1:2]
        planes = zsl.reshape((-1,) + zsl.shape[2:]).permute(0, 3, 1, 2)
        o = F.conv2d(planes, wk[iz].permute(3, 2, 0, 1), stride=2)
        out = o if out is None else out + o
    out = out.permute(0, 2, 3, 1).reshape(budget_out, tz_out, ty, tx, cout).to(y.dtype)

    mout = F.max_pool3d(mpatch.permute(0, 4, 1, 2, 3), (kz, 3, 3), 2).permute(0, 2, 3, 4, 1)
    mout = (mout > 0).to(mask.dtype)
    zin = (to[:, 0:1] * tz_out + torch.arange(tz_out, device=dev)[None, :]) < d_out
    yin = (to[:, 1:2] * ty + torch.arange(ty, device=dev)[None, :]) < grid_out[1]
    xin = (to[:, 2:3] * tx + torch.arange(tx, device=dev)[None, :]) < grid_out[2]
    keep = (zin[:, :, None, None, None] & yin[:, None, :, None, None]
            & xin[:, None, None, :, None] & tvalid[:, None, None, None, None])
    mout = mout * keep.to(mout.dtype)
    out = out * mout.to(out.dtype)

    # ---- budget-drop telemetry ------------------------------------------
    m6 = mask.reshape(t1, tz, ty, tx)
    zsum = m6[:t1 - 1].float().sum((2, 3))                   # (T, tz)
    absz = zlo_in[:, None] + torch.arange(tz, device=dev)[None, :]
    rlo = _ceil2(absz + pz - kz + 1).clamp(0, d_out - 1)
    rhi = torch.div(absz + pz, 2, rounding_mode="floor").clamp(0, d_out - 1)
    lost = ts.valid[:, None]
    for r_ in (rlo, rhi):
        k_ = (torch.div(r_, tz_out, rounding_mode="floor") * nbyo + byo[:, None]) * nbxo \
            + bxo[:, None]
        k_ = torch.where(ts.valid[:, None], k_, nbzo * nbyo * nbxo)
        lost = lost & (tmap_out[k_] >= budget_out)
    n_drop = torch.where(lost, zsum, 0.0).sum().to(_I32)

    nbr = TC._neighbor_ranks(tpos, tvalid, tmap_out, nbzo, nbyo, nbxo, budget_out)
    ts_out = TC.TileSet(tpos, tvalid, nbr, tmap_out, n_out, n_drop)
    return (_pad_phantom(out).reshape(-1, ty, tx, cout),
            _pad_phantom(mout).reshape(-1, ty, tx, 1), ts_out, grid_out)


def zconv(y: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, d: int, tz: int,
          compute_dtype=None):
    """extra_conv: (3, 1, 1) kernel, stride (2, 1, 1), no padding, inside
    one z-chunk (tz >= d). y (N, ty, tx, C); w (3, C, Co). Returns
    (out (T1, d2, ty, tx, Co), mask_out (T1, d2, ty, tx, 1))."""
    n, ty, tx, cin = y.shape
    t1 = n // tz
    assert tz >= d
    d2 = (d - 3) // 2 + 1
    x6 = _cast(y, compute_dtype).reshape(t1, tz, ty, tx, cin)
    wk = _cast(w, compute_dtype)
    out = None
    for iz in range(3):
        o = x6[:, iz:iz + 2 * (d2 - 1) + 1:2] @ wk[iz]
        out = o if out is None else out + o
    out = out.to(y.dtype)
    m6 = mask.reshape(t1, tz, ty, tx)[:, :d]
    m = F.max_pool3d(m6[:, None], (3, 1, 1), (2, 1, 1))[:, 0, ..., None]
    m = (m > 0).to(mask.dtype)
    return out * m.to(out.dtype), m


def to_dense(y: torch.Tensor, ts: TC.TileSet, grid: Sequence[int], tz: int) -> torch.Tensor:
    """Chunk planes (N, ty, tx, C), N = (T+1) * tz -> dense (D, H, W, C)
    (absent tiles read the phantom tile, which is zero)."""
    n, ty, tx, c = y.shape
    return TC.tiles_to_dense(y.reshape(n // tz, tz, ty, tx, c), ts, grid, tz)
