"""Times the bfloat16 tile subm kernel (B3, ``csrc/tile_subm.cu``) on the
conv1..conv4 tile states of a flagship frame, for this tree's source and for
variants of it, on one NVIDIA GPU, and counts what each unit of work would
gather and multiply there.

    python3 -m sparse2dense_tpu_torch.tools.bench_tile_subm [--rounds 2] [name=path ...]

The frame is ``profile_flagship``'s on the tile engine with every stage on
tiles (``TILE_FRAME_BUDGETS``, ``dense_from_stage`` 99, as ``chip_smoke.py``
checks it). A variant is a copy of the source (``name=path.cu``) or another
checkout of the repo (``name=dir``); ``bench_variants`` builds, times
(L2-warm and cold, with the residual and ReLU of the blocks) and checks each
against one bf16 step of ``tile_subm_plain``.

Before each conv's times, a JSON line gives :func:`unit_counts`: the halo
rows gathered and the 16-row tiles multiplied under each unit of work.
"""
from __future__ import annotations

import json

import torch

from ..ops import tile_block_kernel as TBK
from ..ops import tile_kernel as TKK
from ..ops.tile_kernel import dir_row
from . import bench_variants as BV
from .microbench import BF16_FLOOR, BF16_STEP

# (stage, channels, launches a frame on the tile main path, dense_from_stage 2)
TILE_STAGES = (("conv1", 16, 5), ("conv2", 32, 4), ("conv3", 64, 0), ("conv4", 128, 0))
GROUP = 4      # planes a group: the 64 rows of a wgmma
LAYER = 36     # 6 x 6 halo cells of one z layer


def tile_stage_data(batch, model):
    """(state, mask, sets, grid, plan) of conv1..conv4 of the tile flagship
    frame with every stage on tiles: the stage outputs of one backbone
    forward, in the tile state layout, with their plans. conv1 and conv2 are
    the same computation as on the main path (dense_from_stage 2)."""
    bb = model.backbone
    with torch.inference_mode():
        feats = model.reader(batch["voxels"], batch["num_points"])
        _, multi_scale, _ = bb(feats, batch["coordinates"])
    out = []
    for k, (name, _, _) in enumerate(TILE_STAGES):
        (p, mk, sets), grid = multi_scale[name]
        t1p = TKK.t1p_of(bb.tile_budgets[k])
        state = TKK.planes_to_state_batched(p, bb.tile_tz[k], t1p)
        mask = TKK.planes_to_state_batched(mk, bb.tile_tz[k], t1p)
        plan = TKK.make_block_plan_batched(sets, t1p, *bb.tile_wins[k])
        out.append((state, mask, sets, grid, plan))
    return out


def _present(tgt: torch.Tensor, t1p: int) -> torch.Tensor:
    """(28, T1p) bool: the tile a plan row names lies in [0, T1p); row 27 is
    the tile itself."""
    tg = tgt.permute(1, 0, 2).reshape(32, t1p)
    return torch.cat([(tg[:27] >= 0) & (tg[:27] < t1p),
                      torch.ones((1, t1p), dtype=torch.bool, device=tg.device)])


def _layer_reads(present: torch.Tensor, tz: int) -> torch.Tensor:
    """(tz + 2, T1p): rows of halo layer z' = -1..tz of each column whose
    source lies in a present tile (the rows a gather loads)."""
    out = []
    for zz in range(-1, tz + 1):
        dz = -1 if zz < 0 else (1 if zz >= tz else 0)
        n = 0
        for h in range(LAYER):
            yy, xx = h // 6 - 1, h % 6 - 1
            dy = -1 if yy < 0 else (1 if yy > 3 else 0)
            dx = -1 if xx < 0 else (1 if xx > 3 else 0)
            n = n + present[27 if (dz, dy, dx) == (0, 0, 0) else dir_row(dz, dy, dx)].long()
        out.append(n)
    return torch.stack(out)


def _groups(q: torch.Tensor, gid: torch.Tensor, tap: torch.Tensor, reads: torch.Tensor,
            t1p: int, tz: int, share: bool) -> dict:
    """Counts of the groups ``gid`` (0, 1, ... in list order) of the live
    planes ``q`` (z * T1p + t): halo rows (108 a plane, or 36 a distinct
    (tile, layer) of the group with ``share``), the rows of those with a
    present source, and the 16-row tiles multiplied with a tap skipped per
    group of 64 rows."""
    n_groups = int(gid.max()) + 1 if gid.numel() else 0
    z, t = q // t1p, q % t1p
    layer = t[:, None] * (tz + 2) + z[:, None] + torch.arange(3, device=q.device)  # (n, 3)
    if share:
        keys = torch.unique(gid[:, None] * (t1p * (tz + 2)) + layer)
        layer = keys % (t1p * (tz + 2))
    flat = reads.T.reshape(-1)            # (T1p * (tz + 2)), index t * (tz + 2) + z' + 1
    union = torch.zeros((27, n_groups), dtype=torch.long, device=q.device)
    union.index_add_(1, gid, tap[:, z, t].long())
    return dict(groups=n_groups, halo_rows=LAYER * int(layer.numel()),
                halo_reads=int(flat[layer.reshape(-1)].sum()),
                tiles=GROUP * int((union > 0).sum()))


def unit_counts(mask: torch.Tensor, tgt: torch.Tensor) -> dict:
    """Halo rows gathered and 16-row tiles multiplied by the tile conv on
    this mask (tz, T1p, 16) and plan (tgt), under each unit of work:

    - ``a``: the live planes in z-major order (q = z * T1p + t), groups of 4,
      a 108-row halo a plane (B2's unit);
    - ``b``: the live planes in column order (tile-major, z inside), groups
      of up to 4 live planes of one column, which share the halo layers of
      z-neighbours ((span + 2) x 36 rows for consecutive z);
    - ``b_cross``: the column order in groups of 4 consecutive entries
      (across columns where one runs out), each distinct (tile, layer) of a
      group gathered once (the unit csrc/tile_subm.cu builds);
    - ``c``: whole columns, (tz + 2) x 36 halo rows and every plane of a
      column with a live plane multiplied, in groups of 4 consecutive z.

    ``halo_reads`` counts the halo rows whose source tile is present (the
    others are zero-filled without a load); ``tiles`` the (group, tap) tiles
    with a tap skipped when none of the group's rows has a present source,
    and ``tiles_per_plane`` what a skip per plane (16 rows) would multiply."""
    tz, t1p = mask.shape[:2]
    dev = mask.device
    present = _present(tgt, t1p)
    _, rows, _ = TKK._tap_sources(tz)
    rows = torch.tensor(rows, device=dev)                                 # (27, tz, 16)
    tap = torch.stack([present[rows[k]].any(1) for k in range(27)])       # (27, tz, T1p)
    live = (mask != 0).any(-1)                                            # (tz, T1p)
    reads = _layer_reads(present, tz)
    q_z = torch.nonzero(live.reshape(-1)).reshape(-1)
    i_col = torch.nonzero(live.T.reshape(-1)).reshape(-1)                 # t * tz + z
    q_col = (i_col % tz) * t1p + i_col // tz
    n = q_col.numel()
    seq = torch.arange(n, device=dev)
    col = i_col // tz
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = col[1:] != col[:-1]
    first = torch.cummax(torch.where(starts, seq, 0), 0).values           # column's first entry
    in_col = torch.cumsum(((seq - first) % GROUP == 0).long(), 0) - 1     # column groups
    cols = live.any(0)
    block_tap = torch.stack([tap[:, z0:z0 + GROUP].any(1) for z0 in range(0, tz, GROUP)], 1)
    return dict(
        tz=tz, t1p=t1p, live_planes=n, columns=int(cols.sum()),
        tiles_per_plane=int((tap & live[None]).sum()),
        a=_groups(q_z, torch.arange(n, device=dev) // GROUP, tap, reads, t1p, tz, False),
        b=_groups(q_col, in_col, tap, reads, t1p, tz, True),
        b_cross=_groups(q_col, seq // GROUP, tap, reads, t1p, tz, True),
        c=dict(groups=block_tap.shape[1] * int(cols.sum()),
               halo_rows=(tz + 2) * LAYER * int(cols.sum()),
               halo_reads=int(reads[:, cols].sum()),
               tiles=GROUP * int((block_tap & cols).sum())))


def cases(stages, gen):
    """The bench's cases (``bench_variants.Case``) on the conv1..conv4 tile
    states, with the residual and ReLU of the blocks; prints each conv's
    :func:`unit_counts` first."""
    dev = torch.device("cuda")
    for (conv, c, per_frame), (state, mask, _, _, plan) in zip(TILE_STAGES, stages):
        print(json.dumps(dict(case=conv, **unit_counts(mask, plan.tgt))), flush=True)
        w = torch.randn((27, c, c), device=dev, generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device=dev, generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device=dev, generator=gen)
        st = state.to(torch.bfloat16)
        call = (st, plan.tgt, w.to(torch.bfloat16), scale, shift,
                TKK.expand_mask(mask, c).to(torch.bfloat16))
        want = TKK.tile_subm_plain(*call, residual=st).float()
        tol = BF16_STEP * want.abs() + BF16_FLOOR * want.abs().max()
        yield conv, per_frame, lambda m: m.tile_subm_cuda(*call, residual=st), want, tol
        del want, tol, call


def main() -> None:
    from ..models import build_detector
    from ..training.synthetic import make_batch
    from ..utils.config import TILE_FRAME_BUDGETS, flagship

    args = BV.parser(__doc__).parse_args()
    srcs = BV.sources(TBK, args.variants, "tile")
    cfg = flagship("tile", TILE_FRAME_BUDGETS)
    cfg["S_model"]["backbone"]["dense_from_stage"] = 99
    model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                           voxel_generator=cfg["voxel_generator"], device="cuda",
                           generator=torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32, device="cuda")
    stages = tile_stage_data(batch, model)
    del model
    BV.run(srcs, cases(stages, torch.Generator(device="cuda").manual_seed(1)), args.rounds)


if __name__ == "__main__":
    main()
