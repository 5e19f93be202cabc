"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device: the card's name and power limit;
2. kernels: builds the four CUDA sources of ``sparse2dense_tpu_torch/csrc``
   (one nvcc process per source, started together) and holds each sparse
   conv kernel against its plain PyTorch version on the real data of one
   synthetic Waymo frame (150k voxels on the 41x1504x1504 grid):
   - the window pass on the window plans of conv_input 5->16, conv1 16->16,
     the strided conv2_down 16->32 (V_out=320000) and a (3,1,1) z-only
     strided conv, within 1e-4 + 1e-4*|p| (summation order only); then, on
     the frame's first 30,037 rows, a plan with dy groups left to the
     residual pass (GATE), windows clipped at the end of V_in, all-padding
     blocks, the z-only plan and Cin 5; and B1 under autograd
     (``window_kernel.WindowPass``, the training step's window pass): on
     those rows and conv1's subm and conv2_down's strided plans, its d
     features and d weights against autograd through ``window_pass_plain``
     + ``residual_conv`` within 1e-4 + 1e-4*|p| (the gradient of a linear
     map does not depend on the bf16 forward), then its backward and reader
     table timed on the frame's plans (the window backward's ms a step);
   - the plane subm conv on the plane states, masks and plans of conv2
     (32), conv3 (64) and conv4 (128) of the same frame on the plane
     engine, in bfloat16 within one bf16 rounding step,
     2^-7*|p| + 1e-3*max|p| (the output is rounded to bf16 after float32
     sums taken in another order), and in float32 within 1e-4 + 1e-4*|p|;
     then, for each of the four (C, Co) pairs built, in both types, on
     targets set to SENTINEL, fully masked planes (whole groups of 4 and
     8), a T1p whose last plan block is mostly padding, and no residual
     with no ReLU;
   - the tile subm conv on the tile states, masks and plans of conv1 (16,
     tz 8), conv2 (32, tz 4), conv3 (64, tz 2) and conv4 (128, tz 6) of the
     same frame on the tile engine with every stage on tiles, at
     ``utils.config.TILE_FRAME_BUDGETS``, with the same tolerances, and on
     conv1's plan at the reference's default window of 256 tiles, which
     misses targets: the kernel leaves out exactly the taps the plan drops;
     then, for each of the four (C, Co) pairs at tz 8, 4, 2 and 6, in both
     types, on targets set to SENTINEL, masked planes (groups of 4, single
     planes, columns whose only live plane is z = 0 or z = tz - 1), a padded
     last plan block, and no residual with no ReLU;
   and times kernel (L2-warm: back to back, queued behind a sleep kernel;
   L2-cold: a 256 MB buffer written and read back before each call), plain
   version and the layer's bf16 cuDNN ``F.conv3d`` on the densified grid (a
   yardstick the port never calls);
3. gather probes: with the launch counts set to 0, the B4 suites of
   ``tools/microbench.py`` through their functions (``pallas_take``,
   ``pallas_onehot``, ``pallas_dma``, ``pallas_run``) at the reference's
   sizes (V = 2^17 rows of 16 float32): the take (B4a), window-take (B4b,
   (BLK, W) = (256, 512) and (512, 1024)) and run-gather (B4c, R = 1, 8,
   64) kernels of ``ops/gather_probes.py``, each held bit-equal to its plain
   version and to one ``index_select``, then the three timed L2-warm (back
   to back) and L2-cold (a 256 MB buffer written and read back before each
   call, ``microbench.flush_l2``); every kernel must have launched there.
   Bound: the distinct table rows the indices name, the output written and
   the indices read, once each, over 3.35 TB/s. Each case is a record of
   its own in the kernels line. Then the timers' floors (an empty kernel,
   and ``Tensor.copy_`` of the 8.39 MB table) warm and cold, and the edge
   cases of the take and window-take kernels (other widths, ragged
   batches, extreme indices, n < V, w = V, clamped tail blocks), each
   bit-equal to its plain version;
4. main path, window engine: the flagship KD_VoxelNet + S2D_RPN at full
   width, random weights from a seeded generator, through ``build_detector
   -> forward -> predict`` on 3 warm-up and 8 timed frames (median, min and
   max printed): 6 window-pass launches a frame, residual rows within
   budget, finite maps and boxes;
5. main path, plane engine: the same with the reference bench's override
   ``engine="plane"`` at ``utils.config.FRAME_BUDGETS`` (this frame's sets
   outgrow the reference's default plane and chunk budgets;
   ``tests/test_torch_plane_sets.py`` counts them): 6 window-pass and 12
   plane launches a frame, zero ``plane_drop``, ``planek_miss``,
   ``plane_chunk_drop`` and ``down_drop``;
6. main path, tile engine: the same with the reference bench's override
   ``engine="tile", tile_backend="pallas"`` (``dense_from_stage`` 2) at
   ``TILE_FRAME_BUDGETS``: 9 tile launches a frame and none of the other
   kernels, zero ``conv1_tile_drop``, ``tilek_miss`` and ``down_drop``;
7. train: the flagship teacher-student training step at full width
   (``tools/profile_train_step.py``: VoxelNet teacher and KD_VoxelNet +
   S2D_RPN student on the window engine with bf16 dense stages, seeded
   random weights, batch 1 of the bench's frame with its CenterHead targets
   and distillation streams) through ``TS_Trainer.step``, 2 warm-up and 4
   timed steps: the median step and its stages (teacher forward, student
   forward + losses, backward, optimizer; synchronised at the boundaries),
   18 window-pass launches a step (the teacher's two streams and the
   student, 6 each), the peak memory, every loss, ``grad_norm``, and the
   residual rows of the teacher's two backbone streams and the student's
   against their budgets; it fails on a loss that is not finite, a
   ``grad_norm`` <= 0, or a window-engine conv weight (``conv_input``,
   ``conv1_*``, ``conv2_down``) whose gradient is None or all zero;
8. agreement: the tiny distillation model on the card against the same model
   on the CPU (plain versions only), window, plane and tile engines; and one
   teacher-student step of the tiny pair (window engine) on the card against
   the same step on the CPU with its window pass on bf16-rounded inputs (as
   the kernel multiplies): every metric, the student gradient as a whole and
   each window-engine conv weight's gradient within 2e-2 (the tiny step is
   ill-conditioned: ``_ts_step_agreement`` says how much).

TF32 is switched off for cuDNN and matmuls in phases 2 and 8, which compare
against float32 plain versions; phases 3 to 7 run at PyTorch's defaults
(TF32 on in cuDNN convs, off in matmuls). With TF32 off cuDNN picks an FFT
algorithm for the neck's 3x3 convs that costs ~200 ms a frame on an H100
(``sparse2dense_tpu_torch/tools/profile_flagship.py``). The second-to-last
lines are a JSON record of the kernels (the sparse convs per frame, the
probes per call, L2-cold) and the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
TOL_ABS, TOL_REL = 1e-4, 1e-4  # float32: summation order only
BF16_STEP = 2.0 ** -7          # one bf16 rounding step, relative
BF16_FLOOR = 1e-3              # times max|p|: outputs near zero
# launches a frame of (window_pass, plane_subm, tile_subm) per engine
EXPECTED_LAUNCHES = {"window": (6, 0, 0), "plane": (6, 12, 0), "tile": (0, 0, 9)}
WARMUP_FRAMES, TIMED_FRAMES = 3, 8   # a frame's time still falls over its first ~3


@contextlib.contextmanager
def no_tf32():
    """Full float32 in cuDNN convs and matmuls while comparing with float32
    plain versions (cuDNN convs default to TF32)."""
    import torch

    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``, L2-warm: ``reps`` calls back to back,
    queued behind a sleep kernel so that the host's issue is not timed
    (``microbench.timed``)."""
    import torch

    from sparse2dense_tpu_torch.tools.microbench import timed

    return timed(lambda i: fn(), torch.device("cuda"), reps=reps, warmup=warmup, hold=True) * 1e3


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return name, smi


def _flagship(engine="window", budgets=None, dense_from_stage=None):
    """(cfg, batch, model) of the flagship at full width on the card."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import flagship

    cfg = flagship(engine, budgets)
    if dense_from_stage is not None:
        cfg["S_model"]["backbone"]["dense_from_stage"] = dense_from_stage
    # trained-like heatmap density for NMS (random-init heatmaps sit at the
    # score threshold and flood NMS)
    cfg["S_model"]["bbox_head"]["init_bias"] = -6.0
    batch = make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32, device="cuda")
    model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                           voxel_generator=cfg["voxel_generator"], device="cuda",
                           generator=torch.Generator().manual_seed(0))
    return cfg, batch, model


def _hits(plan, ksize):
    """(row, tap) pairs the window pass computes on this data."""
    import torch

    from sparse2dense_tpu_torch.ops.window_conv import GATE
    from sparse2dense_tpu_torch.ops.window_kernel import live_taps

    dy_mask, j_mask = live_taps(ksize)
    n = 0
    for g in range(3):
        if not (dy_mask >> g) & 1:
            continue
        kb = plan.kbase[:, g]
        kb = kb[kb != GATE]
        for j in range(9):
            if (j_mask >> j) & 1:
                t = kb + plan.offsets[g, j]
                pos = torch.searchsorted(plan.lin, t).clamp(max=plan.lin.shape[0] - 1)
                n += int((plan.lin[pos] == t).sum())
    return n


def _window_rows(batch, grid, gen):
    """Window pass against its plain version at the flagship plans."""
    import torch
    import torch.nn.functional as F

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools.bench_window_pass import window_cases
    from sparse2dense_tpu_torch.tools.microbench import timed_cold

    cases, feats5, feats16, coords, lin = window_cases(batch, grid, gen)
    rows = []
    for name, plan, f, cin, cout, ksize, per_frame, stride, pad in cases:
        w = torch.randn((cout, cin) + ksize, device="cuda", generator=gen) * 0.2
        wd = WC.taps_zyx_to_dyx(w).to(torch.bfloat16)
        fb = f.to(torch.bfloat16).contiguous()
        got = WK.window_pass_cuda(fb, plan, wd, ksize)
        want = WC.window_pass_plain(fb.float(), plan, wd.float())
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > TOL_ABS + TOL_REL * want.abs()).sum())
        ms = cuda_ms(lambda: WK.window_pass_cuda(fb, plan, wd, ksize), reps=20)
        cold_ms = timed_cold(lambda i: WK.window_pass_cuda(fb, plan, wd, ksize),
                             torch.device("cuda")) * 1e3
        plain_ms = cuda_ms(lambda: WC.window_pass_plain(fb.float(), plan, wd.float()),
                           reps=3, warmup=1)
        v_in, vo, nb = plan.lin.shape[0], plan.out_lin.shape[0], plan.ws.shape[0]
        nbytes = (v_in * cin * 2 + v_in * 4 + nb * 128 * 3 * 4 + nb * 3 * 4 + 9 * 3 * 4
                  + 27 * cin * cout * 2 + vo * cout * 4)
        hits = _hits(plan, ksize)
        flops = 2.0 * hits * cin * cout
        bound_ms, bound_by = bound(nbytes, flops)
        # the layer as one dense bf16 conv3d on the densified grid (a
        # yardstick the port never calls)
        dense = _densify_rows(fb, coords, grid)
        w5 = w.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: F.conv3d(dense, w5, stride=stride, padding=pad), reps=5)
        del dense
        row = dict(kernel="window_pass", case=name, v_in=v_in, v_out=vo,
                   n_resid=int(plan.n_resid), hits=hits, max_abs_err=float(err.max()),
                   n_bad=bad, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bytes=nbytes, flops=flops, bound_by=bound_by, library_ms=library_ms,
                   per_frame=per_frame)
        print("[kernels] " + json.dumps(row), flush=True)
        if bad:
            raise AssertionError(f"{name}: {bad} outputs beyond {TOL_ABS} + {TOL_REL}*|p|")
        if int(plan.n_resid) > plan.resid_rows.shape[0]:
            raise AssertionError(f"{name}: residual rows over budget")
        rows.append(row)
    torch.cuda.empty_cache()
    rows += _window_edge_rows(feats5, feats16, coords, lin, grid, gen)
    return rows + _window_backward_rows(cases, feats16, coords, lin, grid, gen)


# window-pass backwards of a training step by plan: the student's conv_input
# (no d features: its input is the reader's), conv1 (4 convs) and
# conv2_down, and one reader table for the subm plan and one for the strided
WINDOW_BACKWARDS = {"conv_input 5->16": 1, "conv1 16->16": 4, "conv2_down 16->32": 1}


def _window_backward_rows(cases, feats16, coords, lin, grid, gen):
    """B1 under autograd: the Function's gradients against autograd through
    the plain formula on the first 30,037 rows (conv1's subm plan and
    conv2_down's strided plan), then the backward and the reader table
    timed at the frame's plans."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid

    n = 30037
    f, cc, ll = feats16[:n], coords[:n], lin[:n]
    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g_out = conv_out_grid(grid, *down)
    oc, ol = WC.downsample_active_set_yxz(cc, cc[:, 0] >= 0, grid, g_out, *down, n)
    checks = [("conv1 16->16", WC.make_subm_plan_presorted(ll, cc, grid, window=384), 16),
              ("conv2_down 16->32", WC.make_strided_plan(ll, ol, oc, grid, g_out, *down,
                                                         window=384, resid_budget=16384), 32)]
    rows = []
    for name, plan, cout in checks:
        w = torch.randn((cout, 16, 3, 3, 3), device="cuda", generator=gen) * 0.2
        cot = torch.randn((plan.out_lin.shape[0], cout), device="cuda", generator=gen)
        grads = []
        for function in (True, False):
            x, w5 = f.clone().requires_grad_(True), w.clone().requires_grad_(True)
            wd = WC.taps_zyx_to_dyx(w5)
            main = (WK.WindowPass.apply(x, wd, WC.with_readers(plan), (3, 3, 3)) if function
                    else WC.window_pass_plain(x, plan, wd))
            ((main + WC.residual_conv(x, plan, wd)) * cot).sum().backward()
            grads.append((x.grad, w5.grad))
        torch.cuda.synchronize()
        row = dict(kernel="window_pass", case=f"backward {name} (30,037 rows)",
                   v_out=plan.out_lin.shape[0], n_resid=int(plan.n_resid),
                   hits=int((WC.hit_table(plan) >= 0).sum()), per_frame=0)
        for key, got, want in zip(("d_features", "d_weights"), *grads):
            err = (got - want).abs()
            row[f"{key}_max_abs_err"] = float(err.max())
            row[f"{key}_n_bad"] = int((err > TOL_ABS + TOL_REL * want.abs()).sum())
        row["max_abs_err"] = max(row["d_features_max_abs_err"], row["d_weights_max_abs_err"])
        print("[kernels] " + json.dumps(row), flush=True)
        if row["d_features_n_bad"] or row["d_weights_n_bad"]:
            raise AssertionError(f"window backward {name}: gradients beyond {TOL_ABS} + "
                                 f"{TOL_REL}*|p| of autograd through the plain formula")
        rows.append(row)
    step_ms = 0.0
    for name, plan, f_case, cin, cout, ksize, *_ in cases:
        if name not in WINDOW_BACKWARDS:
            continue
        wd = WC.taps_zyx_to_dyx(torch.randn((cout, cin) + ksize, device="cuda", generator=gen))
        g = torch.randn((plan.out_lin.shape[0], cout), device="cuda", generator=gen)
        readers = WC.reader_table(plan)
        need = name != "conv_input 5->16"
        ms = cuda_ms(lambda: WC.window_pass_grad(f_case, wd, readers, g, need_features=need),
                     reps=5)
        table_ms = cuda_ms(lambda: WC.reader_table(plan), reps=5)
        per_step = WINDOW_BACKWARDS[name]
        step_ms += ms * per_step + (table_ms if name != "conv1 16->16" else 0.0)
        row = dict(kernel="window_pass", case=f"backward time {name}", v_out=plan.out_lin.shape[0],
                   hits=int((readers >= 0).sum()), backward_ms=ms, reader_table_ms=table_ms,
                   per_step=per_step, per_frame=0, max_abs_err=0.0)
        print("[kernels] " + json.dumps(row), flush=True)
        rows.append(row)
    print(f"[kernels] window backward a training step (the student's 6 window convs and 2 "
          f"reader tables): {step_ms:.3f} ms", flush=True)
    rows.append(dict(kernel="window_pass", case="backward a step", window_backward_ms=step_ms,
                     per_frame=0, max_abs_err=0.0))
    torch.cuda.empty_cache()
    return rows


def _densify_rows(feats, coords, grid):
    """(V, C) rows at zyx coords (-1: padding) -> dense (1, C, D, H, W)."""
    import torch

    d, h, w = grid
    z, y, x = coords.long().unbind(-1)
    ok = (z >= 0)[:, None]
    lin = torch.where(ok[:, 0], (z * h + y) * w + x, d * h * w)
    flat = feats.new_zeros((d * h * w + 1, feats.shape[1]))
    flat[lin] = feats * ok
    return flat[:-1].reshape(d, h, w, -1).permute(3, 0, 1, 2)[None].contiguous()


def _window_edge_rows(feats5, feats16, coords, lin, grid, gen):
    """The window pass against its plain version where its unit skipping,
    window staging and search could go wrong, on the first 30,037 sorted
    rows of the frame (V_in not a whole number of plan blocks): a subm plan
    with a window of 128 (dy groups left to the residual pass: GATE rows
    in the kernel's blocks), a subm plan whose last windows are clipped at
    the end of V_in, a strided plan with three times the output budget it
    needs (all-padding blocks), the z-only (3,1,1) plan, and Cin 5 on the
    strided and z-only plans."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid

    n = 30037
    f5, f16, cc, ll = feats5[:n], feats16[:n], coords[:n], lin[:n]
    active = int((ll < WC.MISS).sum())

    def strided(stride, pad, ksize, budget):
        g_out = conv_out_grid(grid, stride, pad, ksize)
        oc, ol = WC.downsample_active_set_yxz(cc, cc[:, 0] >= 0, grid, g_out, stride, pad,
                                              ksize, budget)
        return WC.make_strided_plan(ll, ol, oc, grid, g_out, stride, pad, ksize, window=384,
                                    resid_budget=n)

    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    n_down = int((WC.downsample_active_set_yxz(
        cc, cc[:, 0] >= 0, grid, conv_out_grid(grid, *down), *down, 3 * n)[1] < WC.MISS).sum())
    cases = [  # (name, plan, features, cout, ksize)
        ("residual rows (window 128) 16->16",
         WC.make_subm_plan_presorted(ll, cc, grid, window=128, resid_budget=n), f16, 16,
         (3, 3, 3)),
        ("window clipped at the end of V_in 5->16",
         WC.make_subm_plan_presorted(ll, cc, grid, window=384, resid_budget=n), f5, 16,
         (3, 3, 3)),
        ("all-padding blocks (budget 3x) 16->32", strided(*down, 3 * n_down), f16, 32, (3, 3, 3)),
        ("z-only (3,1,1) 16->16", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), n), f16, 16,
         (3, 1, 1)),
        ("Cin 5 strided 5->32", strided(*down, n_down + 200), f5, 32, (3, 3, 3)),
        ("Cin 5 z-only (3,1,1) 5->16", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), n), f5, 16,
         (3, 1, 1)),
    ]
    rows = []
    for name, plan, f, cout, ksize in cases:
        cin = f.shape[1]
        w = torch.randn((cout, cin) + ksize, device="cuda", generator=gen) * 0.2
        wd = WC.taps_zyx_to_dyx(w).to(torch.bfloat16)
        fb = f.to(torch.bfloat16).contiguous()
        got = WK.window_pass_cuda(fb, plan, wd, ksize)
        want = WC.window_pass_plain(fb.float(), plan, wd.float())
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > TOL_ABS + TOL_REL * want.abs()).sum())
        kb = plan.kbase.view(-1, 128, 3)
        gate = kb == WC.GATE
        v_in, window = plan.lin.shape[0], plan.window
        start = torch.minimum(plan.ws // 128, torch.full_like(plan.ws, (v_in - window) // 128))
        row = dict(kernel="window_pass", case=f"edge {name}", v_in=v_in, active_in=active,
                   v_out=plan.out_lin.shape[0], window=window, n_resid=int(plan.n_resid),
                   gate_groups=int((gate.all(1) & ~gate.all(1).all(1, keepdim=True)).sum()),
                   blocks_all_gate=int(gate.all(1).all(1).sum()),
                   windows_at_the_end=int(((start == (v_in - window) // 128)
                                           & ~gate.all(1)).sum()),
                   max_abs_err=float(err.max()), max_abs_ref=float(want.abs().max()), n_bad=bad,
                   per_frame=0)
        print("[kernels] " + json.dumps(row), flush=True)
        if bad:
            raise AssertionError(f"window {row['case']}: {bad} outputs beyond {TOL_ABS} + "
                                 f"{TOL_REL}*|p|")
        rows.append(row)
    return rows


def _densify_planes(state, ts, grid):
    """(T1p, 16C) plane rows -> dense (1, C, D, H, W) for the library call."""
    import torch

    d, h, w = grid
    c = state.shape[1] // 16
    tp = ts.tile_pos.long()
    ok = (tp[:, 0] >= 0)[:, None]
    cell = torch.arange(16, device=state.device)
    yy = tp[:, 1:2] * 4 + cell // 4
    xx = tp[:, 2:3] * 4 + cell % 4
    lin = torch.where(ok & (yy < h) & (xx < w), (tp[:, 0:1] * h + yy) * w + xx, d * h * w)
    flat = state.new_zeros((d * h * w + 1, c))
    flat[lin.reshape(-1)] = state[:tp.shape[0]].reshape(-1, c)
    return flat[:-1].reshape(d, h, w, c).permute(3, 0, 1, 2)[None].contiguous()


def _compare(got, want):
    """(|got - want|, want, outputs out of tolerance) of a kernel's output
    against its plain version's, both in the state's dtype: one bf16
    rounding step for bfloat16, summation order only for float32."""
    import torch

    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = (BF16_STEP * want.abs() + BF16_FLOOR * want.abs().max() if bf16
           else TOL_ABS + TOL_REL * want.abs())
    return err, want, int((err > tol).sum())


def _plane_rows(stages, state16, gen):
    """Plane subm kernel against its plain version at conv2..conv4, and at
    C = 16 on conv2's plan with state16."""
    import torch
    import torch.nn.functional as F

    from sparse2dense_tpu_torch.ops import plane_conv as PK
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.tools.bench_plane_subm import PLANE_STAGES
    from sparse2dense_tpu_torch.tools.microbench import timed_cold

    rows = []
    cases = [(name, c, st, True) for (name, c), st in zip(PLANE_STAGES, stages)]
    cases.append(("conv2 plan", 16, (state16,) + stages[0][1:], False))
    for name, c, (state, mask, sets, grid, plan), timed in cases:
        t1p = state.shape[0]
        w = torch.randn((27, c, c), device="cuda", generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        mask16 = PK.expand_mask(mask, c).to(state.dtype)
        for dt in (torch.bfloat16, torch.float32):
            st, m16, wt = state.to(dt), mask16.to(dt), w.to(dt)
            args = (st, plan.tgt, wt, scale, shift, m16)
            err, want, bad = _compare(PKK.plane_subm_cuda(*args, residual=st, relu=True),
                                      PK.plane_subm_plain(*args, residual=st, relu=True))
            planes = sum(int(t.valid.sum()) for t in sets)
            row = dict(kernel="plane_subm", case=f"{name} {c}->{c} {str(dt)[6:]}", t1p=t1p,
                       planes=planes, max_abs_err=float(err.max()),
                       max_abs_ref=float(want.abs().max()), n_bad=bad,
                       per_frame=4 if timed and dt == torch.bfloat16 else 0)
            if row["per_frame"]:
                # what the function needs: state, residual and output of the
                # occupied planes, one mask value per cell, a plane's 27
                # neighbour targets, the weights and the folded scale/shift
                s = st.element_size()
                nbytes = (3 * planes * 16 * c * s + planes * 16 * s + planes * 27 * 4
                          + 27 * c * c * s + 2 * c * 4)
                ones = torch.ones((27, 1, 1), device="cuda")
                hits = float(PK.plane_subm_plain(
                    mask.float(), plan.tgt, ones, torch.ones((1, 16), device="cuda"),
                    torch.zeros((1, 16), device="cuda"), mask.float(), relu=False).sum())
                flops = 2.0 * hits * c * c
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
                row.update(hits=hits, bytes=nbytes, flops=flops)
                row["ms"] = cuda_ms(lambda: PKK.plane_subm_cuda(*args, residual=st), reps=10)
                row["cold_ms"] = timed_cold(lambda i: PKK.plane_subm_cuda(*args, residual=st),
                                            torch.device("cuda")) * 1e3
                row["plain_ms"] = cuda_ms(lambda: PK.plane_subm_plain(*args, residual=st),
                                          reps=2, warmup=1)
                dense = _densify_planes(st, sets[0], grid)
                w5 = wt.reshape(3, 3, 3, c, c).permute(4, 3, 0, 1, 2).contiguous()
                row["library_ms"] = cuda_ms(lambda: F.conv3d(dense, w5, padding=1), reps=5)
                row["dense_shape"] = list(dense.shape)
                del dense
            print("[kernels] " + json.dumps(row), flush=True)
            if bad:
                raise AssertionError(f"plane {row['case']}: {bad} outputs out of tolerance")
            rows.append(row)
    return rows


def _plane_edge_rows(stages, state16, gen):
    """The plane subm kernel against its plain version, for every (C, Co)
    pair built and in bfloat16 and float32, on the inputs where skipping
    dead groups and taps could go wrong: targets set to SENTINEL (a seeded
    third of them), fully masked planes (whole groups of 4 and 8 and single
    planes), a T1p of 1,024 rows whose last plan block holds 10 planes, and
    no residual with no ReLU. Base data: the stage of that width (C = 16:
    conv2's plan with a random state)."""
    import torch

    from sparse2dense_tpu_torch.ops import plane_conv as PK
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.tools.bench_plane_subm import PLANE_STAGES

    _, mask2, _, _, plan2 = stages[0]
    bases = [(16, state16, mask2, plan2.tgt)] + [
        (c, st[0], st[1], st[4].tgt) for (_, c), st in zip(PLANE_STAGES, stages)]
    rows = []
    for c, state, mask, tgt in bases:
        t1p = state.shape[0]
        p = torch.arange(t1p, device="cuda")
        sentinel = torch.rand(tgt.shape, device="cuda", generator=gen) < 1 / 3
        dead = ((p // 4) % 3 == 0) | ((p // 8) % 7 == 1) | (
            torch.rand(t1p, device="cuda", generator=gen) < 0.1)
        n_last = 1024 - 118   # the last 128-row block of the cut holds 10 planes
        keep = (p < n_last)[:, None]
        cases = {  # name: (state, tgt, mask, residual?, relu)
            "sentinel targets": (state, torch.where(sentinel, PK.SENTINEL, tgt), mask, True, True),
            "masked planes": (state, tgt, mask * ~dead[:, None], True, True),
            "padded last block": ((state * keep)[:1024], tgt[:8], (mask * keep)[:1024], True,
                                  True),
            "no residual, no relu": (state, tgt, mask, False, False),
        }
        w = torch.randn((27, c, c), device="cuda", generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        for name, (st0, tg, mk, res, relu) in cases.items():
            for dt in (torch.bfloat16, torch.float32):
                st = st0.to(dt)
                args = (st, tg.contiguous(), w.to(dt), scale, shift,
                        PK.expand_mask(mk, c).to(dt))
                kw = dict(residual=st if res else None, relu=relu)
                err, want, bad = _compare(PKK.plane_subm_cuda(*args, **kw),
                                          PK.plane_subm_plain(*args, **kw))
                row = dict(kernel="plane_subm", case=f"edge {name} {c}->{c} {str(dt)[6:]}",
                           t1p=st.shape[0], live_planes=int((mk > 0).any(-1).sum()),
                           max_abs_err=float(err.max()), max_abs_ref=float(want.abs().max()),
                           n_bad=bad, per_frame=0)
                print("[kernels] " + json.dumps(row), flush=True)
                if bad:
                    raise AssertionError(f"plane {row['case']}: {bad} outputs out of tolerance")
                rows.append(row)
    return rows


def _tile_rows(stages, gen):
    """Tile subm kernel against its plain version at conv1..conv4, and on
    conv1's plan at the reference's default window (misses)."""
    import torch
    import torch.nn.functional as F

    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import tile_kernel as TKK
    from sparse2dense_tpu_torch.ops import tile_planes as TP
    from sparse2dense_tpu_torch.tools.bench_tile_subm import TILE_STAGES
    from sparse2dense_tpu_torch.tools.microbench import timed_cold

    rows = []
    state1, mask1, sets1, grid1, _ = stages[0]
    t1p1 = state1.shape[1]
    plan256 = TKK.make_block_plan_batched(sets1, t1p1, 256, 256)
    cases = [(name, c, per_frame, st, True)
             for (name, c, per_frame), st in zip(TILE_STAGES, stages)]
    cases.append(("conv1 plan at window 256", 16, 0,
                  (state1, mask1, sets1, grid1, plan256), False))
    for name, c, per_frame, (state, mask, sets, grid, plan), main in cases:
        tz, t1p = state.shape[:2]
        w = torch.randn((27, c, c), device="cuda", generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        mask16 = TKK.expand_mask(mask, c).to(state.dtype)
        for dt in (torch.bfloat16, torch.float32):
            st, m16, wt = state.to(dt), mask16.to(dt), w.to(dt)
            args = (st, plan.tgt, wt, scale, shift, m16)
            # the main cases add the residual and ReLU; the miss case neither
            kw = dict(residual=st, relu=True) if main else dict(relu=False)
            err, want, bad = _compare(TBK.tile_subm_cuda(*args, **kw),
                                      TKK.tile_subm_plain(*args, **kw))
            planes = int((mask.reshape(-1, 16) > 0).any(-1).sum())
            row = dict(kernel="tile_subm", case=f"{name} {c}->{c} tz {tz} {str(dt)[6:]}",
                       tz=tz, t1p=t1p, planes=planes, n_miss=int(plan.n_miss.sum()),
                       max_abs_err=float(err.max()), max_abs_ref=float(want.abs().max()),
                       n_bad=bad, per_frame=per_frame if main and dt == torch.bfloat16 else 0)
            if main and dt == torch.bfloat16:
                # what the function needs: state and residual of the occupied
                # (z, tile) planes, one mask value per cell, the whole output
                # (the contract defines every row), 26 targets a tile, the
                # weights and the folded scale/shift
                s = st.element_size()
                nbytes = (2 * planes * 16 * c * s + tz * t1p * 16 * s + tz * t1p * 16 * c * s
                          + t1p * 26 * 4 + 27 * c * c * s + 2 * c * 4)
                ones = torch.ones((27, 1, 1), device="cuda")
                hits = float(TKK.tile_subm_plain(
                    mask.float(), plan.tgt, ones, torch.ones((1, 16), device="cuda"),
                    torch.zeros((1, 16), device="cuda"), mask.float(), relu=False).sum())
                flops = 2.0 * hits * c * c
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
                row.update(hits=hits, bytes=nbytes, flops=flops)
                row["ms"] = cuda_ms(lambda: TBK.tile_subm_cuda(*args, **kw), reps=10)
                row["cold_ms"] = timed_cold(lambda i: TBK.tile_subm_cuda(*args, **kw),
                                            torch.device("cuda")) * 1e3
                row["plain_ms"] = cuda_ms(lambda: TKK.tile_subm_plain(*args, **kw),
                                          reps=2, warmup=1)
                b = len(sets)
                p = TKK.state_to_planes_batched(st, b, t1p // b, tz, t1p // b)[0]
                dense = TP.to_dense(p, sets[0], grid, tz).permute(3, 0, 1, 2)[None].contiguous()
                del p
                w5 = wt.reshape(3, 3, 3, c, c).permute(4, 3, 0, 1, 2).contiguous()
                row["library_ms"] = cuda_ms(lambda: F.conv3d(dense, w5, padding=1), reps=5)
                row["dense_shape"] = list(dense.shape)
                del dense
            print("[kernels] " + json.dumps(row), flush=True)
            if bad:
                raise AssertionError(f"tile {row['case']}: {bad} outputs out of tolerance")
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def _tile_edge_rows(stages, gen):
    """The tile subm kernel against its plain version, for every (C, Co)
    pair built at each of the tile stages' depths tz = 8, 4, 2 and 6, in
    bfloat16 and float32, where grouping live planes and skipping taps
    could go wrong. Base data: the first 1,024 tile rows of the plan of the
    stage of that width (targets past them read zero) with a seeded state
    and mask (a plane live with probability 0.35, a live plane's cells with
    0.5); cases: a third of the targets set to SENTINEL; planes masked in
    groups of 4 (z-major) and singly, and columns whose only live plane is
    z = 0 or z = tz - 1; a last plan block holding 10 tiles; no residual
    and no ReLU."""
    import torch

    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import tile_kernel as TKK
    from sparse2dense_tpu_torch.tools.bench_tile_subm import TILE_STAGES

    t1p = 1024
    rows = []
    for (_, c, _), (_, _, _, _, plan) in zip(TILE_STAGES, stages):
        tgt = plan.tgt[:t1p // 128].contiguous()
        w = torch.randn((27, c, c), device="cuda", generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device="cuda", generator=gen)
        for tz in (8, 4, 2, 6):
            live = torch.rand((tz, t1p, 1), device="cuda", generator=gen) < 0.35
            mask = ((torch.rand((tz, t1p, 16), device="cuda", generator=gen) < 0.5) & live).float()
            state = (torch.randn((tz, t1p, 16, c), device="cuda", generator=gen)
                     * mask[..., None]).reshape(tz, t1p, 16 * c)
            q = torch.arange(tz * t1p, device="cuda").view(tz, t1p)
            t = torch.arange(t1p, device="cuda")
            zs = torch.arange(tz, device="cuda")[:, None]
            dead = (((q // 4) % 3 == 0) | (torch.rand((tz, t1p), device="cuda", generator=gen) < 0.1)
                    | ((t % 5 == 1) & (zs != 0)) | ((t % 5 == 2) & (zs != tz - 1)))
            keep = (t < t1p - 118)[None, :, None]
            sentinel = torch.rand(tgt.shape, device="cuda", generator=gen) < 1 / 3
            cases = {  # name: (state, tgt, mask, residual?, relu)
                "sentinel targets": (state, torch.where(sentinel, TKK.SENTINEL, tgt), mask,
                                     True, True),
                "masked planes": (state, tgt, mask * ~dead[..., None], True, True),
                "padded last block": (state * keep, tgt, mask * keep, True, True),
                "no residual, no relu": (state, tgt, mask, False, False),
            }
            for name, (st0, tg, mk, res, relu) in cases.items():
                for dt in (torch.bfloat16, torch.float32):
                    st = st0.to(dt)
                    args = (st, tg.contiguous(), w.to(dt), scale, shift,
                            TKK.expand_mask(mk, c).to(dt))
                    kw = dict(residual=st if res else None, relu=relu)
                    err, want, bad = _compare(TBK.tile_subm_cuda(*args, **kw),
                                              TKK.tile_subm_plain(*args, **kw))
                    row = dict(kernel="tile_subm", case=f"edge {name} {c}->{c} tz {tz} "
                               f"{str(dt)[6:]}", tz=tz, t1p=t1p,
                               live_planes=int((mk > 0).any(-1).sum()),
                               max_abs_err=float(err.max()), max_abs_ref=float(want.abs().max()),
                               n_bad=bad, per_frame=0)
                    print("[kernels] " + json.dumps(row), flush=True)
                    if bad:
                        raise AssertionError(f"tile {row['case']}: {bad} outputs out of tolerance")
                    rows.append(row)
    return rows


def phase_kernels():
    """The sparse-conv kernels against their plain versions at the flagship's
    data (after building all four sources); returns per-case rows."""
    import torch

    from sparse2dense_tpu_torch.models.builder import sparse_shape_from_voxel_cfg
    from sparse2dense_tpu_torch.ops import cuda_build
    from sparse2dense_tpu_torch.ops import gather_probes as GP
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools.bench_plane_subm import plane_stage_data
    from sparse2dense_tpu_torch.tools.bench_tile_subm import tile_stage_data
    from sparse2dense_tpu_torch.utils.config import FRAME_BUDGETS, TILE_FRAME_BUDGETS

    t0 = time.perf_counter()
    logs = cuda_build.build_all([(m.SOURCE, m.LIBRARY) for m in (WK, PKK, TBK, GP)])
    print(f"[kernels] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s\n" + "\n".join(
        "  " + line for log in logs.values() for line in log.splitlines()
        if "registers" in line or "smem" in line or "spill" in line), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg, batch, model = _flagship("plane", FRAME_BUDGETS)
    rows = _window_rows(batch, sparse_shape_from_voxel_cfg(cfg["voxel_generator"]), gen)
    stages = plane_stage_data(batch, model)
    del model
    # C = 16 (built, not on the main path): conv2's plan with a random
    # masked state
    state2, mask2 = stages[0][:2]
    state16 = (torch.randn((state2.shape[0], 16, 16), device="cuda", generator=gen)
               * mask2[..., None]).reshape(-1, 256).to(state2.dtype)
    rows += _plane_rows(stages, state16, gen)
    torch.cuda.empty_cache()
    rows += _plane_edge_rows(stages, state16, gen)
    del stages
    torch.cuda.empty_cache()
    _, _, model = _flagship("tile", TILE_FRAME_BUDGETS, dense_from_stage=99)
    stages = tile_stage_data(batch, model)
    del model
    rows += _tile_rows(stages, gen)
    rows += _tile_edge_rows(stages, gen)
    return rows


# probe kernel -> (record name, TPU kernel it replaces)
PROBES = {"take": ("gather_take", "sparse2dense_tpu/tools/microbench.py:203"),
          "window_take": ("gather_window_take", "sparse2dense_tpu/tools/microbench.py:285"),
          "run_gather": ("gather_run", "sparse2dense_tpu/tools/microbench.py:358")}
PROBE_SUITES = ("pallas_take", "pallas_onehot", "pallas_dma", "pallas_run")


def _probe_edge_cases(dev):
    """(kernel, case, call, plain call) of the redesigned probes' edge cases
    (B4a at other widths, ragged batches and extreme indices; B4b at other
    widths, n < V, n > V with many clamped tail blocks at an unaligned
    V - w, w = V, w < blk, and more blocks than the SMs hold at once)."""
    import numpy as np
    import torch

    from sparse2dense_tpu_torch.ops import gather_probes as GP

    rng = np.random.RandomState(7)

    def table(v, c):
        return torch.from_numpy(rng.randn(v, c).astype(np.float32)).to(dev)

    def ints(hi, n):
        return torch.from_numpy(rng.randint(0, hi, size=(n,)).astype(np.int32)).to(dev)

    out = []
    for c in (4, 20, 64, 128):
        feat, idx = table(4099, c), ints(4099, 5000)
        out.append(("take", f"C={c} V=4099 N=5000", feat, (idx,)))
    feat = table(4099, 16)
    ends = torch.where(ints(2, 3000) > 0, 4098, 0).to(torch.int32)
    for case, idx in (("N=32*37+13", ints(4099, 32 * 37 + 13)), ("N=5", ints(4099, 5)),
                      ("all 0", torch.zeros(3000, dtype=torch.int32, device=dev)),
                      ("all V-1", torch.full((3000,), 4098, dtype=torch.int32, device=dev)),
                      ("0 or V-1", ends)):
        out.append(("take", case, feat, (idx,)))
    for v, c, n, blk, w, case in (
            (1 << 17, 16, 1 << 16, 256, 512, "n=V/2"),
            (1024, 16, 1024, 128, 1024, "w=V"),
            (100003, 16, 128000, 64, 640, "n>V: clamped tail, unaligned V-w"),
            (1 << 20, 4, 1 << 20, 64, 128, "16,384 blocks"),
            (1 << 17, 64, 1 << 17, 256, 512, "C=64"),
            (1 << 17, 4, 1 << 17, 256, 512, "C=4"),
            (1 << 15, 16, 1 << 15, 256, 128, "w<blk")):
        out.append(("window_take", f"{case} V={v} C={c} N={n} BLK={blk} W={w}", table(v, c),
                    (ints(w, n), blk, w)))
    return [(k, case, lambda f=f, a=a, k=k: getattr(GP, k + "_cuda")(f, *a),
             lambda f=f, a=a, k=k: getattr(GP, k + "_plain")(f, *a)) for k, case, f, a in out]


def phase_probes():
    """The microbench's B4 suites at the reference's sizes, with every launch
    count set to 0 just before and read just after: each case holds its
    kernel bit-equal to its plain version and to ``index_select`` (or
    raises), then times the three. Then the timers' floors and the
    redesigned kernels' edge cases, each bit-equal to its plain version.
    Returns the suites' rows (times in ms, each with its bound and
    launches)."""
    import torch

    from sparse2dense_tpu_torch.ops import gather_probes as GP
    from sparse2dense_tpu_torch.tools import microbench as MB

    dev = torch.device("cuda")
    for k in GP.launches:
        GP.launches[k] = 0
    rows = [row for name in PROBE_SUITES for row in MB.SUITES[name](dev)]
    launches = dict(GP.launches)
    for k, n in launches.items():
        if not n:
            raise AssertionError(f"the microbench's B4 suites launched no {k} kernel")
    floors = MB.bench_timer_floor(dev)
    for row in floors:
        row["bound_ms"] = bound(row["nbytes"], 0.0)[0]
        print(f"[probes] {row['case']}: " + json.dumps(row), flush=True)
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(row["nbytes"], 0.0)
        # the floors beside each case: an empty call, and a copy of the table
        row["timer_floor_cold_ms"], row["copy_floor_cold_ms"] = (f["cold_ms"] for f in floors)
        print(f"[probes] {row['case']}: bit-equal to its plain version and index_select; "
              + json.dumps(row), flush=True)
    print(f"[probes] launches in the B4 suites: {launches}", flush=True)
    edges = _probe_edge_cases(dev)
    for kernel, case, run, plain in edges:
        got, want = run(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{kernel} {case}: the kernel's output differs from its plain "
                                 f"version's")
    print(f"[probes] {len(edges)} edge cases bit-equal to their plain versions: "
          + "; ".join(f"{k} {c}" for k, c, _, _ in edges), flush=True)
    return rows


def _probe_record(row):
    """One probe case, per call, L2-cold; named by its kernel and case."""
    name, replaces = PROBES[row["kernel"]]
    case = row["case"].split(" (")[0].split(" ", 1)[1].replace(" ", ",")
    return {"name": f"{name}[{case}]", "route": "cuda",
            "source": "sparse2dense_tpu_torch/csrc/gather_probes.cu", "replaces": replaces,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["cold_ms"], "plain_ms": row["plain_cold_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_cold_ms"]}


def phase_main_path(engine: str, budgets=None):
    """The flagship on one engine: launches per frame of each kernel, with
    every count set to 0 just before the frames and read just after; every
    telemetry count within its budget. The first ``WARMUP_FRAMES`` frames
    (cuDNN autotuning, allocator growth) are not timed."""
    import torch

    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    _, batch, model = _flagship(engine, budgets)
    mods = {"window_pass": WK, "plane_subm": PKK, "tile_subm": TBK}
    expected = dict(zip(mods, EXPECTED_LAUNCHES[engine]))
    torch.cuda.reset_peak_memory_stats()
    times, per_frame = [], {k: [] for k in mods}
    for mod in mods.values():
        mod.launches = 0
    for i in range(WARMUP_FRAMES + TIMED_FRAMES):
        before = {k: m.launches for k, m in mods.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(batch)
            det = model.predict(out)
        torch.cuda.synchronize()
        if i >= WARMUP_FRAMES:
            times.append((time.perf_counter() - t0) * 1e3)
        for k, m in mods.items():
            per_frame[k].append(m.launches - before[k])
    launches = {k: m.launches for k, m in mods.items()}
    for k, n in expected.items():
        if per_frame[k] != [n] * (WARMUP_FRAMES + TIMED_FRAMES):
            raise AssertionError(f"{engine}: {k} launches per frame {per_frame[k]}, expected {n}")
    for name, (count, budget) in out["telemetry"].items():
        if int(count.max()) > budget:
            raise AssertionError(f"{engine}: {name} counts {int(count.max())} > {budget}")
    maps = [v for pd in out["preds"] for v in pd.values()]
    if not all(bool(torch.isfinite(m).all()) for m in maps):
        raise AssertionError(f"{engine}: non-finite head maps")
    if tuple(maps[0].shape[1:3]) != (188, 188):
        raise AssertionError(f"{engine}: head map shape {tuple(maps[0].shape)}")
    valid = det["valid"]
    if not bool(torch.isfinite(det["box3d_lidar"][valid]).all()):
        raise AssertionError(f"{engine}: non-finite boxes")
    res = dict(engine=engine, budgets=budgets, frame_ms_median=sorted(times)[len(times) // 2],
               frame_ms_min=min(times), frame_ms_max=max(times), frame_ms=times,
               launches=launches, launches_per_frame=per_frame, detections=int(valid.sum()),
               max_heatmap=float(torch.sigmoid(out["preds"][0]["hm"]).max()),
               telemetry={k: int(v[0].max()) for k, v in out["telemetry"].items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    print("[main] " + json.dumps(res), flush=True)
    del model, out
    torch.cuda.empty_cache()
    return res


TRAIN_WARMUP, TRAIN_STEPS = 2, 4
TRAIN_LAUNCHES = 18   # window passes a step: the teacher's two streams, the student
# the student's window-engine conv weights: the custom autograd Function's
WINDOW_WEIGHTS = ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                  "backbone.conv1_0.conv2_weight", "backbone.conv1_1.conv1_weight",
                  "backbone.conv1_1.conv2_weight", "backbone.conv2_down.conv_weight")


def phase_train():
    """The flagship teacher-student training step on the card, with the
    window-pass launch count set to 0 just before the steps and read just
    after (``tools/profile_train_step.py``)."""
    import math

    import torch

    from sparse2dense_tpu_torch.tools import profile_train_step as PT

    batch, trainer = PT.train_setup(1, TRAIN_WARMUP + TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    rows, metrics = PT.run_steps(trainer, batch, TRAIN_WARMUP + TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    launches = WK.launches
    per_step = [r["window_pass_launches"] for r in rows]
    if per_step != [TRAIN_LAUNCHES] * len(rows):
        raise AssertionError(f"train: window-pass launches a step {per_step}, expected "
                             f"{TRAIN_LAUNCHES}")
    metrics = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"train: metrics not finite: {bad}")
    if not metrics["grad_norm"] > 0:
        raise AssertionError(f"train: grad_norm {metrics['grad_norm']}")
    params = dict(trainer.model.named_parameters())
    for name in WINDOW_WEIGHTS:
        g = params[name].grad
        if g is None or not bool(g.abs().max() > 0):
            raise AssertionError(f"train: the window-engine weight {name} got no gradient")
    # residual rows of every backbone run of the step against their budgets
    resid = {}
    with torch.inference_mode():
        for tag, model, prefix in (("teacher dense", trainer.teacher, "dense_"),
                                   ("teacher reconstruction", trainer.teacher, "reconstruction_"),
                                   ("student", trainer.model, "")):
            feats = model.reader(batch[prefix + "voxels"], batch[prefix + "num_points"])
            _, _, tele = model.backbone(feats, batch[prefix + "coordinates"])
            for name, (count, budget) in tele.items():
                resid[f"{tag} {name}"] = [int(count.max()), budget]
    over = {k: v for k, v in resid.items() if v[0] > v[1]}
    if over:
        raise AssertionError(f"train: residual rows over budget: {over}")
    res = dict(PT.summary(rows[TRAIN_WARMUP:]), peak_mem_gb=peak, launches=launches,
               launches_per_step=per_step, metrics=metrics, residual_rows_vs_budget=resid,
               steps=rows)
    print("[train] " + json.dumps(res), flush=True)
    del trainer, batch
    torch.cuda.empty_cache()
    return res


# tiny-model engine settings: every key of every stage fits and the plan
# windows cover every neighbour (as in the CPU tests)
TINY_ENGINES = {
    "window": dict(engine="window", dense_from_stage=1),
    "plane": dict(engine="plane", tile_budgets=(96, 96, 24, 4), plane_budgets=(336, 44, 5),
                  plane_window=10 ** 6),
    "tile": dict(engine="tile", tile_backend="pallas", tile_budgets=(384, 96, 24, 4),
                 tilek_window=10 ** 6),
}
# card against CPU, max |diff| / max |ref|: bf16 products in the window pass
# (the window engine's conv1 and the plane engine's), float32 on the tile engine
TINY_TOL = {"window": 2e-2, "plane": 2e-2, "tile": 1e-3}


def phase_agreement():
    """Tiny model on the card (CUDA kernels: bf16 window products, float32
    plane and tile convs) against the same weights on the CPU (plain
    versions, f32), on the window, plane and tile engines."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import ConfigDict

    worst = {}
    for engine, settings in TINY_ENGINES.items():
        cfg = ConfigDict.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                               "configs", "tests", "distill_tiny.py"))
        cfg["S_model"]["backbone"].update(settings)
        outs, dets = {}, {}
        for dev in ("cuda", "cpu"):
            model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                                   voxel_generator=cfg["voxel_generator"], device=dev,
                                   generator=torch.Generator().manual_seed(3))
            batch = make_batch(cfg, 1, max_voxels=512, n_points=3000, n_obj=6, device=dev)
            with torch.inference_mode():
                out = model(batch)
                outs[dev], dets[dev] = out["preds"][0], model.predict(out)
        worst[engine] = max(
            float((outs["cuda"][k].cpu() - ref).abs().max() / ref.abs().max().clamp(min=1e-6))
            for k, ref in outs["cpu"].items())
        n_det = {dev: int(d["valid"].sum()) for dev, d in dets.items()}
        print(f"[agreement] tiny model, {engine} engine, cuda vs cpu: max |diff| / max |ref| "
              f"= {worst[engine]:.3e}; valid detections {n_det}", flush=True)
        if worst[engine] > TINY_TOL[engine]:
            raise AssertionError(f"tiny {engine} model disagrees with its CPU run: {worst}")
        if not n_det["cuda"] or not bool(torch.isfinite(dets["cuda"]["box3d_lidar"]).all()):
            raise AssertionError(f"predict on the card gave no finite detections ({engine})")
    worst["ts_step"] = _ts_step_agreement()
    return worst


@contextlib.contextmanager
def _window_pass_in_bf16():
    """The CPU's window pass on the inputs rounded to bf16, as the kernel
    multiplies them (bf16 products, float32 sums), while the block runs."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    def plain_bf16(features, plan, weights, ksize=(3, 3, 3)):
        if features.device.type != "cpu":
            raise ValueError("the bf16 plain window pass is the CPU side of a comparison")
        return WC.window_pass_plain(features.to(torch.bfloat16).float(), plan,
                                    weights.to(torch.bfloat16).float())

    old, WK.window_pass = WK.window_pass, plain_bf16
    try:
        yield
    finally:
        WK.window_pass = old


def _ts_step_agreement():
    """One teacher-student step of the tiny pair (window engine) on the card
    against the same step on the CPU, whose window pass takes the inputs
    rounded to bf16 as the kernel does. The tiny step is ill-conditioned
    (train-mode BatchNorm over 16 BEV cells and over single cells amplifies
    small changes of the window pass's output, most in single modules'
    gradients, such as a conv bias before BatchNorm whose true gradient is
    zero), so the gates are:
    every metric within ``TINY_TOL`` of its CPU value (relative), the whole
    student gradient within ``TINY_TOL`` of its largest CPU value, and each
    window-engine conv weight's gradient within ``TINY_TOL`` of its own
    largest CPU value."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.training.trainer import TS_Trainer
    from sparse2dense_tpu_torch.utils.config import ConfigDict

    cfg = ConfigDict.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", "tests", "distill_tiny.py"))
    for key in ("model", "S_model"):
        cfg[key]["backbone"].update(TINY_ENGINES["window"])
    metrics, grads = {}, {}
    for dev in ("cuda", "cpu"):
        kw = dict(test_cfg=cfg["test_cfg"], voxel_generator=cfg["voxel_generator"], device=dev)
        teacher = build_detector(cfg["model"], generator=torch.Generator().manual_seed(4), **kw)
        student = build_detector(cfg["S_model"], generator=torch.Generator().manual_seed(5), **kw)
        batch = make_batch(cfg, 1, max_voxels=512, n_points=3000, n_obj=6, device=dev,
                           with_targets=True, distillation=True)
        opt = OneCycleAdam(student.parameters(), cfg["optimizer"], cfg["lr_config"], 10,
                           cfg["optimizer_config"]["grad_clip"])
        with _window_pass_in_bf16() if dev == "cpu" else contextlib.nullcontext():
            step = TS_Trainer(teacher, student, opt, cfg["model"]).step(batch)
        metrics[dev] = {k: float(v) for k, v in step.items()}
        grads[dev] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                      for n, p in student.named_parameters()}
    ref = grads["cpu"]
    diff = {n: float((grads["cuda"][n] - g).abs().max()) for n, g in ref.items()}
    errs = dict(
        metrics=max(abs(v - metrics["cpu"][k]) / max(abs(metrics["cpu"][k]), 1e-6)
                    for k, v in metrics["cuda"].items()),
        gradients=max(diff.values()) / max(float(g.abs().max()) for g in ref.values()),
        window_weights=max(diff[n] / float(ref[n].abs().max()) for n in WINDOW_WEIGHTS))
    worst = max(diff, key=lambda n: diff[n] / max(float(ref[n].abs().max()), 1e-12))
    print(f"[agreement] tiny teacher-student step, window engine, cuda vs cpu (window pass "
          f"on bf16-rounded inputs): max rel diff {json.dumps(errs)}; not gated: the worst "
          f"tensor relative to itself {worst} {diff[worst] / float(ref[worst].abs().max()):.3e}; "
          f"metrics cuda {json.dumps(metrics['cuda'])} cpu {json.dumps(metrics['cpu'])}",
          flush=True)
    if max(errs.values()) > TINY_TOL["window"]:
        raise AssertionError(f"tiny teacher-student step disagrees with its CPU run: {errs} "
                             f"> {TINY_TOL['window']}")
    return max(errs.values())


def _record(name, source, replaces, launches, rows):
    frame = [r for r in rows if r["per_frame"]]
    lib = [r["library_ms"] for r in frame]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per frame: each timed shape times its launches in one frame
        "ms": sum(r["ms"] * r["per_frame"] for r in frame),
        "plain_ms": sum(r["plain_ms"] * r["per_frame"] for r in frame),
        "bound_ms": sum(r["bound_ms"] * r["per_frame"] for r in frame),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in frame)
                     else "operations"),
        "library_ms": (None if any(x is None for x in lib)
                       else sum(x * r["per_frame"] for x, r in zip(lib, frame))),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sparse2dense_tpu_torch  # noqa: F401  (fails outside the repo)

    kind, smi = phase_device()
    with no_tf32():
        rows = phase_kernels()
    probe_rows = phase_probes()
    from sparse2dense_tpu_torch.utils.config import FRAME_BUDGETS, TILE_FRAME_BUDGETS

    window = phase_main_path("window")
    plane = phase_main_path("plane", budgets=FRAME_BUDGETS)
    tile = phase_main_path("tile", budgets=TILE_FRAME_BUDGETS)
    train = phase_train()
    with no_tf32():
        phase_agreement()

    wrows, prows, trows = ([r for r in rows if r["kernel"] == k]
                           for k in ("window_pass", "plane_subm", "tile_subm"))
    b1_paths = {"window": window["launches"]["window_pass"],
                "plane": plane["launches"]["window_pass"], "train": train["launches"]}
    record = {"kernels": [
        dict(_record("window_pass", "sparse2dense_tpu_torch/csrc/window_pass.cu",
                     "sparse2dense_tpu/ops/pallas/window_kernel.py:69",
                     sum(b1_paths.values()), wrows), launches_by_path=b1_paths),
        _record("plane_subm", "sparse2dense_tpu_torch/csrc/plane_subm.cu",
                "sparse2dense_tpu/ops/pallas/plane_block_kernel.py:131",
                plane["launches"]["plane_subm"], prows),
        _record("tile_subm", "sparse2dense_tpu_torch/csrc/tile_subm.cu",
                "sparse2dense_tpu/ops/pallas/tile_block_kernel.py:156",
                tile["launches"]["tile_subm"], trows),
    ] + [_probe_record(row) for row in probe_rows]}
    for name, krows in zip(("window_pass", "plane_subm", "tile_subm"), (wrows, prows, trows)):
        frame = [r for r in krows if r["per_frame"]]
        print(f"[kernels] {name} per frame: L2-warm "
              f"{sum(r['ms'] * r['per_frame'] for r in frame):.4f} ms, L2-cold "
              f"{sum(r['cold_ms'] * r['per_frame'] for r in frame):.4f} ms", flush=True)
    for rec, res in zip(record["kernels"][:3], (window, plane, tile)):
        print(f"[main] {rec['name']} share of the {res['engine']} frame: {rec['ms']:.3f} ms "
              f"of {res['frame_ms_median']:.1f} ms = {rec['ms'] / res['frame_ms_median']:.2%}",
              flush=True)
    for res in (window, plane, tile):
        print(f"[main] {res['engine']} engine frame: median {res['frame_ms_median']:.1f} ms, "
              f"min {res['frame_ms_min']:.1f}, max {res['frame_ms_max']:.1f} over "
              f"{len(res['frame_ms'])} frames", flush=True)
    b1_bwd = [r for r in wrows if "window_backward_ms" in r][0]["window_backward_ms"]
    print(f"[train] teacher-student step: median {train['step_ms']:.1f} ms over {TRAIN_STEPS} "
          f"steps ({', '.join(f'{k} {v:.1f}' for k, v in train['stages_ms'].items())}); "
          f"window backward {b1_bwd:.3f} ms a step ({b1_bwd / train['step_ms']:.2%}); peak "
          f"{train['peak_mem_gb']:.2f} GiB; {TRAIN_LAUNCHES} window passes a step", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
