"""Times the window-pass kernel (B1, ``csrc/window_pass.cu``) on the window
plans of a flagship frame, for this tree's source and for variants of it, on
one NVIDIA GPU.

    python3 -m sparse2dense_tpu_torch.tools.bench_window_pass [--rounds 2] [name=path ...]

The frame is ``chip_smoke.py``'s (150k voxels, seed 0); the cases are the
window engine's: conv_input 5->16 and conv1 16->16 on the subm plan,
conv2_down 16->32 on the strided plan (V_out 320,000), and the z-only
(3,1,1) conv (window 384). A variant is a copy of the source
(``name=path.cu``) or another checkout of the repo (``name=dir``);
``bench_variants`` builds, times (L2-warm over 20 launches, and cold) and
checks each against 1e-4 + 1e-4*|p| of ``window_pass_plain``. Before each
case's times a JSON line gives its plan's blocks, live units and all-GATE
blocks.
"""
from __future__ import annotations

import json

import torch

from ..ops import window_conv as WC
from ..ops import window_kernel as WK
from ..ops.sparse_conv import conv_out_grid
from . import bench_variants as BV

TOL_ABS, TOL_REL = 1e-4, 1e-4


def window_cases(batch, grid, gen, down_budget: int = 320000):
    """(name, plan, features, cin, cout, ksize, launches a frame, stride,
    padding) of the window pass on the flagship frame's rows (or another
    frame's, on its ``grid``, with conv2_down's stage budget
    ``down_budget``): the voxel-mean features (5 channels) and a seeded
    16-channel state on the sorted rows, their subm plan and the strided
    plans of conv2_down and of a z-only (3,1,1) conv, all at window 384.
    Also returns the sorted coords."""
    vfe = (batch["voxels"].sum(-2) / batch["num_points"].clamp(min=1)[..., None])[0]
    feats5, coords, lin = WC.sort_rows(vfe, batch["coordinates"][0], grid)
    subm = WC.make_subm_plan_presorted(lin, coords, grid, window=384)
    valid = (lin < WC.MISS)[:, None]
    feats16 = torch.randn(lin.shape[0], 16, device=lin.device, generator=gen) * valid

    def strided(stride, pad, ksize, budget):
        g_out = conv_out_grid(grid, stride, pad, ksize)
        oc, ol = WC.downsample_active_set_yxz(coords, coords[:, 0] >= 0, grid, g_out,
                                              stride, pad, ksize, budget)
        return WC.make_strided_plan(lin, ol, oc, grid, g_out, stride, pad, ksize,
                                    window=384, resid_budget=16384)

    cases = [
        ("conv_input 5->16", subm, feats5, 5, 16, (3, 3, 3), 1, (1, 1, 1), (1, 1, 1)),
        ("conv1 16->16", subm, feats16, 16, 16, (3, 3, 3), 4, (1, 1, 1), (1, 1, 1)),
        ("conv2_down 16->32", strided((2, 2, 2), (1, 1, 1), (3, 3, 3), down_budget),
         feats16, 16, 32, (3, 3, 3), 1, (2, 2, 2), (1, 1, 1)),
        ("z-only (3,1,1) 16->16", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), 300000),
         feats16, 16, 16, (3, 1, 1), 0, (2, 1, 1), (0, 0, 0)),
    ]
    return cases, feats5, feats16, coords, lin


def plan_units(plan, ksize) -> dict:
    """Plan blocks, the (block, dy group) units the kernel stages (a live dy
    group with a row that is not GATE) and the blocks with none."""
    dy_mask, _ = WK.live_taps(ksize)
    live = (plan.kbase.view(-1, plan.block, 3) != WC.GATE).any(1)
    live &= torch.tensor([(dy_mask >> g) & 1 == 1 for g in range(3)], device=live.device)
    return dict(blocks=live.shape[0], units=int(live.sum()),
                blocks_without_units=int((~live.any(1)).sum()))


def cases(window_cases_, gen):
    """The bench's cases (``bench_variants.Case``) on the window plans;
    prints each plan's :func:`plan_units` first."""
    dev = torch.device("cuda")
    for name, plan, f, cin, cout, ksize, per_frame, *_ in window_cases_:
        print(json.dumps(dict(case=name, **plan_units(plan, ksize))), flush=True)
        w = torch.randn((cout, cin) + ksize, device=dev, generator=gen) * 0.2
        wd = WC.taps_zyx_to_dyx(w).to(torch.bfloat16)
        fb = f.to(torch.bfloat16).contiguous()
        want = WC.window_pass_plain(fb.float(), plan, wd.float())
        yield (name, per_frame, lambda m: m.window_pass_cuda(fb, plan, wd, ksize), want,
               TOL_ABS + TOL_REL * want.abs())


def main() -> None:
    from ..models.builder import sparse_shape_from_voxel_cfg
    from ..training.synthetic import make_batch
    from ..utils.config import flagship

    args = BV.parser(__doc__).parse_args()
    srcs = BV.sources(WK, args.variants, "window")
    cfg = flagship()
    batch = make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32, device="cuda")
    grid = sparse_shape_from_voxel_cfg(cfg["voxel_generator"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    BV.run(srcs, cases(window_cases(batch, grid, gen)[0], gen), args.rounds, reps=20)


if __name__ == "__main__":
    main()
