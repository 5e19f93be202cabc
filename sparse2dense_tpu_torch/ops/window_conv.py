"""Windowed sparse 3D convolution: plans, residual pass and plain window pass.

Counterpart of ``sparse2dense_tpu/ops/window_conv.py``; every integer field of
a plan is bit-exact against it. Rows are kept sorted by a guard-banded
(y, x, z) linear key, so the inputs of a 3x3x3 conv for a block of 128
consecutive output rows lie in one contiguous rank window per dy group. The
window pass (``ops/window_kernel.py``: a CUDA kernel, or the plain version
below on the CPU) computes the taps of every dy group whose window certainly
covers them; the exact gather-based residual pass computes the rest, so the
sum is the exact sparse conv.

The guard band pads every axis of the key space by one cell on each side, so
a tap that steps off the grid lands on an empty guard key and never matches.
``kbase`` carries ``GATE`` for dy groups left to the residual pass.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

MISS = 2 ** 30     # key of padded rows (never matches)
GATE = -(2 ** 29)  # kbase of dy groups owned by the residual pass

_I32 = torch.int32


def key_dims(grid: Sequence[int]) -> Tuple[int, int, int]:
    """Guard-banded key-space dims (D, H, W) = grid dims + 2."""
    d, h, w = grid
    return d + 2, h + 2, w + 2


def yxz_lin(coords: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """(..., 3) zyx coords -> guard-banded (y, x, z)-major int32 key;
    out-of-grid or padded coords -> MISS."""
    d, h, w = grid
    kd, _, kw = key_dims(grid)
    z, y, x = coords.to(_I32).unbind(-1)
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return torch.where(ok, ((y + 1) * kw + (x + 1)) * kd + (z + 1),
                       torch.full_like(z, MISS))


def sort_rows(features: torch.Tensor, coords: torch.Tensor, grid: Sequence[int]):
    """Sort rows by (y, x, z); padded rows go last. Valid keys are unique, so
    only the order of the padded rows (all alike) is left to the sort."""
    lin = yxz_lin(coords, grid)
    order = torch.argsort(lin, stable=True)
    return features[order], coords[order], lin[order]


def build_rank_table(lin: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """T[col] = rank of the first row whose key-space BEV column is >= col;
    shape (kH*kW + 1,). Requires ``lin`` sorted."""
    kd, kh, kw = key_dims(grid)
    col = torch.where(lin < MISS, torch.div(lin, kd, rounding_mode="floor"),
                      torch.full_like(lin, kh * kw))
    counts = torch.bincount(col.long(), minlength=kh * kw + 1)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts[:-1], 0)]).to(_I32)


class ConvPlan(NamedTuple):
    """Plan shared by every conv of a stage (same active set)."""

    lin: torch.Tensor         # (V,) sorted keys of the input rows, MISS pad
    out_lin: torch.Tensor     # (Vo,) sorted keys of the output rows
    base: torch.Tensor        # (Vo, 3) input key of the (dy, 0, 0) tap
    tap_ok: torch.Tensor      # (Vo, 27) bool: tap target inside the grid
    ws: torch.Tensor          # (nb, 3) window start rank per block and dy
    windowed: torch.Tensor    # (Vo, 3) bool: dy group owned by the window pass
    resid_rows: torch.Tensor  # (R,) output rows for the residual pass, -1 pad
    resid_nbr: torch.Tensor   # (R, 27) input rank per tap, -1 absent
    n_resid: torch.Tensor     # () true residual row count (may exceed R)
    offsets: torch.Tensor     # (3, 9) per-dy key offsets of the (dx, dz) taps
    kbase: torch.Tensor       # (nb*block, 3) base where windowed, else GATE
    window: int
    block: int
    readers: Optional[torch.Tensor] = None  # (V, 27) reader table, for the backward


def make_subm_plan(features, coords, grid, block=128, window=512, resid_budget=1024):
    """Plan a submanifold conv stage. Rows may come unsorted: the returned
    (features, coords, plan) are sorted by (y, x, z). Rows already in yxz
    order go to :func:`make_subm_plan_presorted`."""
    features, coords, lin = sort_rows(features, coords, grid)
    return features, coords, make_subm_plan_presorted(lin, coords, grid, block, window,
                                                      resid_budget)


def make_subm_plan_presorted(lin, coords, grid, block=128, window=512,
                             resid_budget=1024) -> ConvPlan:
    """Submanifold 3x3x3 plan for rows already in yxz order."""
    return _plan(lin, lin, coords, grid, grid, (1, 1, 1), (1, 1, 1),
                 (3, 3, 3), block, window, resid_budget)


def make_strided_plan(in_lin, out_lin, out_coords, grid_in, grid_out,
                      stride, padding, ksize=(3, 3, 3), block=128,
                      window=512, resid_budget=1024) -> ConvPlan:
    """Strided plan: the output rows are the coarse active set, sorted."""
    return _plan(in_lin, out_lin, out_coords, grid_in, grid_out,
                 stride, padding, ksize, block, window, resid_budget)


def _plan(in_lin, out_lin, out_coords, grid_in, grid_out, stride, padding,
          ksize, block, window, resid_budget) -> ConvPlan:
    dev = in_lin.device
    d, h, w = grid_in
    kd, kh, kw = key_dims(grid_in)
    sz, sy, sx = stride
    pz, py, px = padding
    kz, ky, kx = ksize
    cz, cy, cx = (kz - 1) // 2, (ky - 1) // 2, (kx - 1) // 2
    v_in = in_lin.shape[0]
    window = min(window, v_in)
    if window >= 128:
        window = (window // 128) * 128
    vo = out_lin.shape[0]
    nb = -(-vo // block)
    pad_vo = nb * block
    out_coords = out_coords.to(_I32)

    # centre-tap input coordinate of each output row: o*s - p + c
    oz = out_coords[:, 0] * sz - pz + cz
    oy = out_coords[:, 1] * sy - py + cy
    ox = out_coords[:, 2] * sx - px + cx
    valid_out = (out_coords >= 0).all(-1)
    miss = torch.full_like(oz, MISS)
    base = torch.stack([((oy + 1 + dy) * kw + (ox + 1)) * kd + (oz + 1)
                        for dy in (-1, 0, 1)], -1)
    base = torch.where(valid_out[:, None], base, miss[:, None])

    # tap k = ((dy+1)*3 + (dx+1))*3 + (dz+1); offsets grouped by dy
    offsets = torch.tensor([[dx * kd + dz for dx in (-1, 0, 1) for dz in (-1, 0, 1)]
                            for _ in (-1, 0, 1)], dtype=_I32, device=dev)
    taps = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            for dz in (-1, 0, 1):
                live = abs(dy) <= ky // 2 and abs(dx) <= kx // 2 and abs(dz) <= kz // 2
                taps.append((oy + dy >= 0) & (oy + dy < h) & (ox + dx >= 0)
                            & (ox + dx < w) & (oz + dz >= 0) & (oz + dz < d)
                            & valid_out & live)
    tap_ok = torch.stack(taps, -1)

    # per (block, dy) rank interval [T[min col - 1], T[max col + 2]) from the
    # non-decreasing column-rank table
    T = build_rank_table(in_lin, grid_in)
    n_cols = kh * kw
    base_cols = torch.div(base, kd, rounding_mode="floor").clamp(0, n_cols)
    bc = torch.full((pad_vo, 3), n_cols, dtype=_I32, device=dev)
    bc[:vo] = base_cols
    bc_blk = bc.view(nb, block, 3)
    has_need = bc_blk < n_cols
    bc_min = torch.where(has_need, bc_blk, n_cols).amin(1)
    bc_max = torch.where(has_need, bc_blk, 0).amax(1)
    blk_lo = torch.where(bc_min < n_cols, T[(bc_min - 1).clamp(0, n_cols).long()],
                         torch.full_like(bc_min, v_in))
    blk_hi = T[(bc_max + 2).clamp(0, n_cols).long()]
    ws = blk_lo.clamp(0, max(v_in - window, 0))
    # window starts aligned down to the reference kernel's rank granule; the
    # coverage test below uses the aligned start, so it stays exact
    granule = 128 if window % 128 == 0 else 16
    ws = torch.div(ws, granule, rounding_mode="floor") * granule

    # a block's dy group is windowed iff its whole interval fits the window
    inside = (blk_lo >= ws) & (blk_hi <= ws + window)
    windowed = (inside[:, None, :] | ~has_need).reshape(pad_vo, 3)[:vo]

    # residual rows: a dy group of a valid row that is not windowed; the
    # first ``resid_budget`` of them in ascending row order
    resid_row_mask = (~windowed & valid_out[:, None]).any(-1)
    n_resid = resid_row_mask.sum(dtype=_I32)
    pos = torch.cumsum(resid_row_mask.to(_I32), 0, dtype=_I32) - 1
    slot = torch.where(resid_row_mask & (pos < resid_budget), pos, resid_budget)
    resid_rows = torch.full((resid_budget + 1,), -1, dtype=_I32, device=dev)
    resid_rows.scatter_(0, slot.long(), torch.arange(vo, dtype=_I32, device=dev))
    resid_rows = resid_rows[:resid_budget]  # the spare slot took the overflow

    # exact neighbour ranks of the residual rows through a dense rank grid
    # over the key space (padded rows all land on the spare cell ``size``)
    size = kd * kh * kw
    safe_lin = torch.where(in_lin < MISS, in_lin, size).long()
    rank_grid = torch.full((size + 1,), -1, dtype=_I32, device=dev)
    rank_grid.scatter_reduce_(0, safe_lin, torch.arange(v_in, dtype=_I32, device=dev),
                              reduce="amax")
    rr = resid_rows.clamp(min=0).long()
    tgt = (base[rr][:, :, None] + offsets[None]).reshape(resid_budget, 27)
    tgt_ok = tap_ok[rr] & (resid_rows >= 0)[:, None]
    tgt_safe = torch.where(tgt_ok & (tgt >= 0) & (tgt < size), tgt, size)
    resid_nbr = rank_grid[tgt_safe.long()]

    kb_ok = torch.zeros((pad_vo, 3), dtype=torch.bool, device=dev)
    kb_ok[:vo] = windowed & (base < MISS) & valid_out[:, None]
    kb_base = torch.full((pad_vo, 3), MISS, dtype=_I32, device=dev)
    kb_base[:vo] = base
    kbase = torch.where(kb_ok, kb_base, GATE)

    return ConvPlan(in_lin, out_lin, base, tap_ok, ws.contiguous(), windowed,
                    resid_rows, resid_nbr, n_resid, offsets, kbase, window, block)


def window_pass_plain(features: torch.Tensor, plan: ConvPlan,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the window pass: each output row sums, over the taps
    of the dy groups the window pass owns, the features of the input row the
    tap hits (:func:`hit_table`) times the tap's weights, in float32 whatever
    it is given; returns (V_out, Cout) float32. The reference's
    ``_window_pass_reference`` computes the same sums by a one-hot compare of
    each block's window keys with the rows' targets (the hit table finds the
    same rows: a windowed group's window holds every rank its targets can
    have); ``tests/test_torch_window_pass.py`` holds the two equal. One
    gather of every (row, tap) hit, the misses on a zero row, and a product
    a tap, summed tap after tap as the reference sums them."""
    v_in, cin = features.shape
    hits = hit_table(plan)
    rows = torch.cat([features.float(), features.new_zeros((1, cin), dtype=torch.float32)])
    g = F.embedding(torch.where(hits >= 0, hits, v_in).long(), rows,
                    padding_idx=v_in)                                 # (V_out, 27, Cin)
    w = weights.float()
    out = g.new_zeros((g.shape[0], w.shape[-1]))
    for k in range(27):
        out = out + g[:, k] @ w[k]
    return out


def hit_table(plan: ConvPlan) -> torch.Tensor:
    """(V_out, 27) int32: the input rank that the window pass reads for each
    (output row, tap), -1 where it reads none. A tap is read where its dy
    group is windowed (``kbase`` not ``GATE``), the tap is inside the grid
    (``tap_ok``) and an input row has the target key ``kbase + offset``. A
    windowed group's window holds every rank its targets can have (the plan
    tests the group's whole column interval), so one search over all of
    ``lin`` finds the same rows as a search inside the window."""
    vo, v_in = plan.out_lin.shape[0], plan.lin.shape[0]
    kb = plan.kbase[:vo]
    tgt = (kb[:, :, None] + plan.offsets[None]).reshape(vo, 27)
    live = (kb != GATE).repeat_interleave(9, dim=1) & plan.tap_ok
    pos = torch.searchsorted(plan.lin, tgt).clamp(max=v_in - 1)
    return torch.where(live & (plan.lin[pos] == tgt), pos, -1).to(_I32)


def reader_table(plan: ConvPlan) -> torch.Tensor:
    """(V_in, 27) int32: the hit table inverted, the output row that reads
    each input row at each tap, -1 where none does. A tap's targets are
    distinct keys (one output row, one target), so at most one row reads an
    input row at a tap and the inversion is exact."""
    hits = hit_table(plan)
    vo, v_in = hits.shape[0], plan.lin.shape[0]
    dev = hits.device
    # misses go to one spare slot past the end, which is cut off
    slot = torch.where(hits >= 0, hits.long() * 27 + torch.arange(27, device=dev), v_in * 27)
    readers = torch.full((v_in * 27 + 1,), -1, dtype=_I32, device=dev)
    readers[slot.view(-1)] = torch.arange(vo, dtype=_I32, device=dev).repeat_interleave(27)
    return readers[:-1].view(v_in, 27)


def with_readers(plan: ConvPlan) -> ConvPlan:
    """The plan with its reader table, built once for every conv that shares
    the plan and is differentiated."""
    return plan._replace(readers=reader_table(plan))


def window_pass_grad(features: torch.Tensor, weights: torch.Tensor, readers: torch.Tensor,
                     grad: torch.Tensor, need_features: bool = True):
    """(d features or None, d weights) of the window pass for the output
    gradient ``grad`` (V_out, Cout), in float32 whatever the forward ran:
    the VJP of the plain formula. With Gr[r, k] = G[readers[r, k]] (zero
    where no row reads r): dW[k] = X^T Gr[:, k] and dX[r] = sum_k Gr[r, k]
    W[k]^T, one gather and two GEMMs, no atomics."""
    cout = grad.shape[1]
    g = torch.cat([grad.float(), grad.new_zeros((1, cout), dtype=torch.float32)])
    gr = g[torch.where(readers >= 0, readers, grad.shape[0]).long()]   # (V_in, 27, Cout)
    dw = torch.einsum("ri,rko->kio", features.float(), gr).to(weights.dtype)
    if not need_features:
        return None, dw
    return torch.einsum("rko,kio->ri", gr, weights.float()).to(features.dtype), dw


def residual_conv(features: torch.Tensor, plan: ConvPlan,
                  weights: torch.Tensor) -> torch.Tensor:
    """Exact gather-GEMM for the residual rows, scattered into (V_out, Cout).
    Only the dy groups NOT owned by the window pass are computed, so the two
    passes partition the taps. All taps' rows are one gather, by
    ``F.embedding`` with the dead taps on a zero padding row: its backward
    sums duplicate rows in parallel and skips the padding row (an indexed
    gather's backward adds duplicates one after another)."""
    v_in = features.shape[0]
    vo = plan.out_lin.shape[0]
    rr = plan.resid_rows.clamp(min=0).long()
    dy_excluded = ~plan.windowed[rr]
    tap_live = (dy_excluded.repeat_interleave(9, dim=-1) & (plan.resid_nbr >= 0)
                & (plan.resid_rows >= 0)[:, None])
    rows = torch.cat([features, features.new_zeros((1, features.shape[1]))])
    g = F.embedding(torch.where(tap_live, plan.resid_nbr, v_in).long(), rows,
                    padding_idx=v_in)                                 # (R, 27, Cin)
    contrib = torch.einsum("rki,kio->ro", g.float(), weights.float())
    tgt = torch.where(plan.resid_rows >= 0, plan.resid_rows, vo).long()
    out = contrib.new_zeros((vo + 1, contrib.shape[-1]))
    out.index_add_(0, tgt, contrib)
    return out[:vo].to(features.dtype)


def window_conv(features: torch.Tensor, plan: ConvPlan, weights: torch.Tensor,
                bias=None, ksize: Tuple[int, int, int] = (3, 3, 3)) -> torch.Tensor:
    """Window pass + residual pass + bias + validity mask.

    features (V_in, Cin) sorted; weights (27, Cin, Cout) in (dy, dx, dz) tap
    order (``taps_zyx_to_dyx``). On CUDA the window pass is the hand-written
    kernel (bf16 products, f32 sums); on the CPU its plain version in f32.
    Under autograd the window pass is ``window_kernel.WindowPass``; the
    residual pass, the bias and the mask are plain autograd."""
    from .window_kernel import WindowPass

    out = WindowPass.apply(features, weights, plan, tuple(ksize)).to(features.dtype)
    out = out + residual_conv(features, plan, weights)
    if bias is not None:
        out = out + bias
    return out * (plan.out_lin < MISS)[:, None].to(out.dtype)


def downsample_active_set_yxz(coords, valid, grid_in, grid_out, stride,
                              padding, ksize, out_budget):
    """Active output set of a strided sparse conv in (y, x, z) key order:
    every output cell whose kernel footprint holds an active input, first
    ``out_budget`` of them. Returns (out_coords (budget, 3), out_lin)."""
    dev = coords.device
    coords = coords.to(_I32)
    s = torch.tensor(stride, dtype=_I32, device=dev)
    p = torch.tensor(padding, dtype=_I32, device=dev)
    ks = torch.tensor(ksize, dtype=_I32, device=dev)
    ncand = [-(-k // st) for k, st in zip(ksize, stride)]
    q = torch.div(coords + p, s, rounding_mode="floor")
    combos = torch.tensor([(a, b, c) for a in range(ncand[0]) for b in range(ncand[1])
                           for c in range(ncand[2])], dtype=_I32, device=dev)
    o = q[:, None, :] - combos[None]                          # (V, C, 3) zyx
    k = coords[:, None, :] + p - o * s
    ok = valid[:, None] & ((k >= 0) & (k < ks)).all(-1)
    lin = yxz_lin(o, grid_out)
    kd, kh, kw = key_dims(grid_out)
    size_out = kd * kh * kw
    flat = torch.where(ok & (lin < MISS), lin, size_out).reshape(-1)
    sorted_lin = torch.sort(flat).values
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_lin[1:] != sorted_lin[:-1]]) & (sorted_lin < size_out)
    slot = torch.cumsum(is_first.to(_I32), 0, dtype=_I32) - 1
    slot = torch.where(is_first, slot.clamp(max=out_budget), out_budget)
    out_lin = torch.full((out_budget + 1,), -1, dtype=_I32, device=dev)
    out_lin.scatter_reduce_(0, slot.long(), sorted_lin, reduce="amax")
    out_lin = out_lin[:out_budget]
    out_valid = out_lin >= 0
    safe = out_lin.clamp(min=0)
    oz = safe % kd - 1
    ox = torch.div(safe, kd, rounding_mode="floor") % kw - 1
    oy = torch.div(safe, kd * kw, rounding_mode="floor") - 1
    out_coords = torch.where(out_valid[:, None], torch.stack([oz, oy, ox], -1), -1)
    return out_coords, torch.where(out_valid, out_lin, MISS)


def taps_zyx_to_dyx(w: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (Cout, Cin, kz, ky, kx) -> this engine's dense
    (27, Cin, Cout) taps in (dy, dx, dz) order, zeros on taps outside the
    kernel extent (size-1 axes)."""
    cout, cin, kz, ky, kx = w.shape
    cz, cy, cx = (kz - 1) // 2, (ky - 1) // 2, (kx - 1) // 2
    taps = kz * ky * kx
    src = [((dz + cz) * ky + (dy + cy)) * kx + (dx + cx)
           if abs(dy) <= ky // 2 and abs(dx) <= kx // 2 and abs(dz) <= kz // 2
           else taps  # the zero slot
           for dy in (-1, 0, 1) for dx in (-1, 0, 1) for dz in (-1, 0, 1)]
    wz = w.permute(2, 3, 4, 1, 0).reshape(taps, cin, cout)  # z-major taps
    wz = torch.cat([wz, wz.new_zeros((1, cin, cout))])
    return wz[torch.tensor(src, device=w.device)]
