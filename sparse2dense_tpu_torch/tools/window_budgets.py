"""Counts what the window engine's knobs must hold on the flagship frame at
every sparse stage: each strided conv's active output cells (against its
stage budget) and each plan's residual rows at a range of plan windows
(against its residual budget), on one NVIDIA GPU.

    python3 -m sparse2dense_tpu_torch.tools.window_budgets [--device cuda|cpu]
        [--dense-from-stage 2|3|99] [--windows 256,384,512,...]

The frame is ``chip_smoke.py``'s (150k voxels, seed 0, the 41x1504x1504
grid). The stages follow the window engine's chain past conv1 (the strided
conv2_down, conv3_down, conv4_down and, past stage 4, ``extra_conv``, each
with the subm plan of the stage it starts), with the stage budgets and plan
windows of the frame settings of ``--dense-from-stage``
(``utils.config.DFS2_FRAME_SETTINGS`` and the others); each plan is also
counted at every window of ``--windows`` that the window-pass kernel takes
at its widths. Both backbones share the chain: their strided convs have the
same strides, paddings and kernels, so these counts hold for SpMiddleFHD
too. Prints one JSON line a plan; plans only, no kernel runs.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..models.backbones import scn
from ..ops import window_conv as WC
from ..ops import window_kernel as WK
from ..ops.sparse_conv import conv_out_grid


def chain():
    """(plan, input width, output width, stride, padding, ksize, the stage k
    whose window it takes, the stage budget of its output) past conv1, from
    the backbone's own stage table: each strided conv and the subm plan
    (stride None) of the stage it starts, then the z-only ``extra_conv``;
    widths are SpMiddleResNetFHD's (SpMiddleFHD's are 64 from conv3_down
    on)."""
    rows, cin = [], 16
    for k, (name, ch, stride, pad, ksize) in enumerate(scn._STAGES, start=1):
        rows += [(f"{name}_down", cin, ch, stride, pad, ksize, k, k - 1),
                 (name, ch, ch, None, None, None, k, None)]
        cin = ch
    return rows + [("extra_conv", cin, cin, *scn.EXTRA_CONV, k, k)]


SUBM_RESID_BUDGET = 1024   # a subm plan's, fixed (window_conv.make_subm_plan_presorted)


def frame_settings(dense_from_stage: int) -> dict:
    """The committed frame settings of the window engine at
    ``dense_from_stage``."""
    from ..utils import config as C

    return {2: C.DFS2_FRAME_SETTINGS, 3: C.DFS3_FRAME_SETTINGS,
            99: C.DFS99_FRAME_SETTINGS}[dense_from_stage]


def count(coords, lin, grid, settings, dense_from_stage, windows):
    """One dict a plan of the window engine's chain up to
    ``dense_from_stage`` (the strided conv that densifies included)."""
    wins = settings["win_window"]
    budgets, resid_budget = settings["stage_budgets"], settings["win_resid_budget"]
    n_stages = 4 if dense_from_stage > 4 else dense_from_stage
    rows = []
    for name, cin, cout, stride, pad, ksize, k, b in chain():
        if k > n_stages or name == "extra_conv" and dense_from_stage <= 4:
            break
        if stride is None and k == dense_from_stage:
            break   # the stage that densifies runs its blocks dense
        if stride is None:
            def plan(w, lin=lin, coords=coords, grid=grid):
                return WC.make_subm_plan_presorted(lin, coords, grid, window=w)
            row = dict(plan=name, kind="subm", v=int((lin < WC.MISS).sum()),
                       resid_budget=SUBM_RESID_BUDGET)
        else:
            g_out = conv_out_grid(grid, stride, pad, ksize)
            valid = coords[:, 0] >= 0
            ncand = 1
            for kk, s in zip(ksize, stride):
                ncand *= -(-kk // s)
            _, all_lin = WC.downsample_active_set_yxz(coords, valid, grid, g_out, stride, pad,
                                                      ksize, lin.shape[0] * ncand)
            active = int((all_lin < WC.MISS).sum())
            oc, ol = WC.downsample_active_set_yxz(coords, valid, grid, g_out, stride, pad,
                                                  ksize, budgets[b])

            def plan(w, lin=lin, ol=ol, oc=oc, grid=grid, g_out=g_out, stride=stride,
                     pad=pad, ksize=ksize):
                return WC.make_strided_plan(lin, ol, oc, grid, g_out, stride, pad, ksize,
                                            window=w, resid_budget=resid_budget)
            row = dict(plan=name, kind="strided", active_cells=active,
                       stage_budget=budgets[b], dropped=max(0, active - budgets[b]),
                       resid_budget=resid_budget)
        p = plan(wins[k])
        row.update(cin=cin, cout=cout, window=p.window, n_resid=int(p.n_resid),
                   units=int((p.kbase.view(-1, p.block, 3) != WC.GATE).any(1).sum()),
                   kernel_takes=WK.unsupported(p.block, cin, cout, p.window) is None,
                   by_window={w: int(plan(w).n_resid) for w in windows
                              if WK.unsupported(128, cin, cout, w) is None})
        rows.append(row)
        print(json.dumps(row), flush=True)
        if stride is not None:
            lin, coords, grid = ol, oc, g_out
    return rows


def main(argv=None) -> list:
    from ..models.builder import sparse_shape_from_voxel_cfg
    from ..training.synthetic import make_batch
    from ..utils.config import flagship

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dense-from-stage", type=int, default=99, choices=(2, 3, 99))
    ap.add_argument("--windows", default="256,384,512,640,768,1024,1280,1536")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("window_budgets: no CUDA device (pass --device cpu)")
    cfg = flagship()
    batch = make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32,
                       device=args.device)
    grid = sparse_shape_from_voxel_cfg(cfg["voxel_generator"])
    # conv2_down's input: the conv1 rows in (y, x, z) order
    coords = batch["coordinates"][0].to(torch.int32)
    lin = WC.yxz_lin(coords, grid)
    order = torch.argsort(lin, stable=True)
    coords, lin = coords[order], lin[order]
    windows = [int(w) for w in args.windows.split(",")]
    return count(coords, lin, grid, frame_settings(args.dense_from_stage),
                 args.dense_from_stage, windows)


if __name__ == "__main__":
    main()
