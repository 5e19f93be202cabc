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
     the plans ``dense_from_stage=2`` adds (the conv2 blocks' subm plan
     32->32 on the 320,000 conv2_down output rows, the strided conv3_down
     32->64) the same way as the frame's, and Cin 32 -> Cout 64 on the
     edge cases above (GATE groups, clipped windows, all-padding blocks,
     z-only);
   - the plane subm conv on the plane states, masks and plans of conv2
     (32), conv3 (64) and conv4 (128) of the same frame on the plane
     engine, in bfloat16 within one bf16 rounding step,
     2^-7*|p| + 1e-3*max|p| (the output is rounded to bf16 after float32
     sums taken in another order), and in float32 within 1e-4 + 1e-4*|p|;
     then, for each of the four (C, Co) pairs built, in both types, on
     targets set to SENTINEL, fully masked planes (whole groups of 4 and
     8), a T1p whose last plan block is mostly padding, and no residual
     with no ReLU; then B2 under autograd (``plane_kernel.PlaneConv``, the
     plane engine's training conv) at conv2..conv4: its d state and d taps
     against autograd through the plain formula within 1e-4 + 1e-4*|p|
     (float32; the d taps, sums over a stage's cells, 1e-4 * max|p| +
     1e-4*|p|), its forward and backward timed in bf16 (the plane backward's
     ms a step, beside its bound);
   - the tile subm conv on the tile states, masks and plans of conv1 (16,
     tz 8), conv2 (32, tz 4), conv3 (64, tz 2) and conv4 (128, tz 6) of the
     same frame on the tile engine with every stage on tiles, at
     ``utils.config.TILE_FRAME_BUDGETS``, with the same tolerances, and on
     conv1's plan at the reference's default window of 256 tiles, which
     misses targets: the kernel leaves out exactly the taps the plan drops;
     then, for each of the four (C, Co) pairs at tz 8, 4, 2 and 6, in both
     types, on targets set to SENTINEL, masked planes (groups of 4, single
     planes, columns whose only live plane is z = 0 or z = tz - 1), a padded
     last plan block, and no residual with no ReLU; then B3 under autograd
     (``tile_kernel.TileConv``, the tile engine's training conv) at conv1
     (16, tz 8), conv2 (32, tz 4), conv3 (64, tz 2) and conv4 (128, tz 6):
     its forward against the plain version and its d state and d taps
     against autograd through the plain formula, with B2's tolerances (in
     float32), its forward and backward timed in bf16 (the tile backward's
     ms a step at ``dense_from_stage`` 2 and 99, beside its bound);
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
   random weights, the bench's frame with its CenterHead targets and
   distillation streams) through ``TS_Trainer.step``, the student's dense
   backbone stages and PCR generators rematerialised as in the reference:
   at batch 1, 1 warm-up and 3 timed steps: the median step and its stages
   (teacher forward, student forward + losses, backward, optimizer;
   synchronised at the boundaries), the peak memory of each stage, 18
   window-pass launches a step (the teacher's two streams and the student,
   6 each), every loss, ``grad_norm``, and the residual rows of the
   teacher's two backbone streams and the student's against their budgets;
   it fails on a loss that is not finite, a ``grad_norm`` <= 0, or a
   window-engine conv weight (``conv_input``, ``conv1_*``, ``conv2_down``)
   whose gradient is None or all zero. Then one step with the dense stages
   rematerialised and one without (``remat_dense=False``) from the same
   weights, optimizer state and batch: every gradient and ``grad_norm``
   within ``REMAT_GRAD_TOL`` of its module's largest (cuDNN's bf16 convs
   recomputed in the backward), BN running statistics and the other metrics
   within ``REMAT_STAT_TOL`` (the forward is the same), both peaks printed;
   3 more steps without. Then the recipe's batch of 3 (1 warm-up, 2 timed
   steps), which must fit in the card's memory: step, stages, peaks and the
   window-pass launches a step, read;
8. cli: the recipe through its command line (``tools/train.py`` in this
   process, in a temporary work directory): the dense-teacher config trains
   1 epoch of 2 synthetic frames and writes ``epoch_1``; the distillation
   config loads it as its teacher (``--load_from``; the teacher must equal
   the checkpoint) and trains 1 epoch of 15 frames at the config's batch of
   3, whose text log must write its line, and repoints ``latest``;
   ``--resume_from latest --epochs 1`` must restore the model, BN buffers,
   optimizer moments and step, epoch and iteration exactly; ``--epochs 2``
   takes the second epoch's steps. Every loss finite, ``grad_norm`` > 0;
9. second: the SECOND recipe (``configs/waymo_second_3x_distill_interval_5.py``:
   SpMiddleFHD on the window engine, dense bf16 from down1, S2D_RPN,
   MultiGroupHead) at full width on the same 150k-voxel frame: the
   student's inference frames (3 warm-up, 8 timed; 3 window-pass launches a
   frame: subm0's two convs and down1), finite maps, 212,064 anchors, finite
   detections, and the host's time of ``AssignTarget``'s assignment (the
   frame's ``make_batch`` with targets less without); the same frame's backbone on the gather engine
   (``gather_conv``, its conv operands rounded to bf16) against the window
   engine with the same weights: subm0's and down1's rows within the bf16
   kernel tolerance, the BEV within ``SECOND_BEV_TOL`` of its largest value;
   the teacher-student step (branch "second") at batch 1 (1 + 3 steps) and
   at the recipe's 4 (1 + 2): 9 window passes a sample, every loss finite,
   ``grad_norm`` > 0, a gradient on subm0's and down1's weights, medians by
   stage and peaks (at batch 4 a step that runs out of memory is reported
   with its stages' peaks); and the CLI chain of phase 8 for SECOND's two
   configs (dense teacher at batch 1, distillation at 4);
10. engines: the flagship's training past the shipped engine, teacher and
   student alike: the window engine at ``dense_from_stage=2`` (plan windows
   ``utils.config.DFS2_FRAME_SETTINGS``: plan windows, residual and stage
   budgets that fit this frame;
   its inference frame as phase 4's, 11 window passes a
   frame) and the plane engine at ``FRAME_BUDGETS`` (its frame is phase
   5's): the student's train-mode BEV against the shipped window engine's
   on the same weights (within ``ENGINE_BEV_TOL`` of its largest value
   where every counter says the reference is exact; else printed, not
   judged), and the teacher-student step at batch 1 (1 + 3 steps) and at
   the recipe's 3 (1 + 2): medians by stage, peaks, the window-pass and
   plane-conv launches a step (dense_from_stage 2: 33 B1 a sample; plane:
   18 B1 a sample and 36 B2 a step), every loss finite, a gradient on the
   engine's convs, every backbone run's counters within their budgets;
   then the tile engine (``tile_backend="pallas"``, which trains as "xla"
   does) at ``TILE_FRAME_BUDGETS`` the same way (its frame is phase 6's),
   at ``dense_from_stage`` 2 (batch 1 and 3; 27 B3 launches a step: the
   student's 9 under autograd, the teacher's two streams' 18) and 99 (batch
   1; 51 B3 launches: B3 at all four widths under autograd, and
   ``TileZConv``); its counters must be 0;
11. agreement: the tiny distillation model on the card against the same model
   on the CPU (plain versions only), window, plane and tile engines; the
   tiny tile backbone's train-mode forward and backward on the card (B3
   under autograd) against the CPU: BEV and every gradient within
   ``TINY_TOL["tile"]`` of the largest; and one
   teacher-student step of the tiny pair (window engine) on the card against
   the same step on the CPU with its window pass on bf16-rounded inputs (as
   the kernel multiplies): every metric, the student gradient as a whole and
   each window-engine conv weight's gradient within 2e-2 (the tiny step is
   ill-conditioned: ``_ts_step_agreement`` says how much).

TF32 is switched off for cuDNN and matmuls in phases 2, 11 and the gather
comparison of 9, which compare against float32 plain versions; the rest of
phases 3 to 10 run at PyTorch's defaults
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
# launches a frame of (window_pass, plane_subm, tile_subm) per engine; the
# window engine at dense_from_stage 2 adds the conv2 blocks' 4 and conv3_down
EXPECTED_LAUNCHES = {"window": (6, 0, 0), "plane": (6, 12, 0), "tile": (0, 0, 9),
                     "window_dfs2": (11, 0, 0)}
WARMUP_FRAMES, TIMED_FRAMES = 3, 8   # a frame's time still falls over its first ~3
# the window engine at dense_from_stage 2, teacher and student alike, at
# ``profile_train_step.engine_settings("window", 2)``: plan windows, residual
# and stage budgets that fit the frame (``utils.config.DFS2_FRAME_SETTINGS``);
# its window passes a frame by case of the kernel phase
DFS2_WINDOW_LAUNCHES = {"conv_input 5->16": 1, "conv1 16->16": 4, "conv2_down 16->32": 1,
                        "conv2 32->32": 4, "conv3_down 32->64": 1}


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


def _flagship(engine="window", budgets=None, overrides=None):
    """(cfg, batch, model) of the flagship at full width on the card;
    ``overrides`` update the student's backbone."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import flagship

    cfg = flagship(engine, budgets)
    cfg["S_model"]["backbone"].update(overrides or {})
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


def _window_case_row(name, plan, f, cin, cout, ksize, per_frame, stride, pad, coords, grid,
                     gen):
    """One window-pass case against its plain version, timed L2-warm and
    cold, with its bound and the layer as one dense bf16 conv3d (a
    yardstick the port never calls) on ``grid``, where ``coords`` are the
    input rows'."""
    import torch
    import torch.nn.functional as F

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools.microbench import timed_cold

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
    dense = _densify_rows(fb, coords, grid)
    w5 = w.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: F.conv3d(dense, w5, stride=stride, padding=pad), reps=5)
    del dense
    row = dict(kernel="window_pass", case=name, v_in=v_in, v_out=vo, window=plan.window,
               n_resid=int(plan.n_resid), hits=hits, max_abs_err=float(err.max()),
               n_bad=bad, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bytes=nbytes, flops=flops, bound_by=bound_by, library_ms=library_ms,
               per_frame=per_frame, per_frame_dfs2=DFS2_WINDOW_LAUNCHES.get(name, 0))
    print("[kernels] " + json.dumps(row), flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad} outputs beyond {TOL_ABS} + {TOL_REL}*|p|")
    if int(plan.n_resid) > plan.resid_rows.shape[0]:
        raise AssertionError(f"{name}: residual rows over budget")
    return row


def _window_rows(batch, grid, gen):
    """Window pass against its plain version at the flagship plans, and at
    the plans ``dense_from_stage=2`` adds (``_window_dfs2_cases``)."""
    import torch

    from sparse2dense_tpu_torch.tools.bench_window_pass import window_cases

    cases, feats5, feats16, coords, lin = window_cases(batch, grid, gen)
    rows = [_window_case_row(*case, coords, grid, gen) for case in cases]
    torch.cuda.empty_cache()
    rows += [_window_case_row(*case, gen) for case in _window_dfs2_cases(coords, lin, grid,
                                                                         gen)]
    torch.cuda.empty_cache()
    rows += _window_edge_rows(feats5, feats16, coords, lin, grid, gen)
    return rows + _window_backward_rows(cases, feats16, coords, lin, grid, gen)


def _window_dfs2_cases(coords, lin, grid, gen):
    """The window plans ``dense_from_stage=2`` adds on the flagship frame:
    the conv2 blocks' subm plan 32->32 on the conv2_down output rows (the
    stage budget's 320,000) and the strided conv3_down 32->64, at the
    windows, stage and residual budgets of ``DFS2_FRAME_SETTINGS``, with a
    seeded 32-channel state. Cases as ``_window_case_row`` takes them, with
    the input rows' coords and grid."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid
    from sparse2dense_tpu_torch.utils.config import DFS2_FRAME_SETTINGS as DFS2

    wins = DFS2["win_window"]
    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g2 = conv_out_grid(grid, *down)
    c2, l2 = WC.downsample_active_set_yxz(coords, coords[:, 0] >= 0, grid, g2, *down, 320000)
    g3 = conv_out_grid(g2, *down)
    c3, l3 = WC.downsample_active_set_yxz(c2, c2[:, 0] >= 0, g2, g3, *down,
                                          DFS2["stage_budgets"][1])
    f32 = torch.randn(l2.shape[0], 32, device="cuda", generator=gen) * (l2 < WC.MISS)[:, None]
    subm = WC.make_subm_plan_presorted(l2, c2, g2, window=wins[1])
    strided = WC.make_strided_plan(l2, l3, c3, g2, g3, *down, window=wins[2],
                                   resid_budget=DFS2["win_resid_budget"])
    return [("conv2 32->32", subm, f32, 32, 32, (3, 3, 3), 0, (1, 1, 1), (1, 1, 1), c2, g2),
            ("conv3_down 32->64", strided, f32, 32, 64, (3, 3, 3), 0, (2, 2, 2), (1, 1, 1),
             c2, g2)]


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
    strided and z-only plans; and Cin 32 -> Cout 64 (conv3_down's width at
    ``dense_from_stage=2``) on a seeded 32-channel state: GATE groups, the
    clipped windows, all-padding blocks and the z-only plan."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid

    n = 30037
    f5, f16, cc, ll = feats5[:n], feats16[:n], coords[:n], lin[:n]
    active = int((ll < WC.MISS).sum())
    f32 = torch.randn(n, 32, device="cuda", generator=gen) * (ll < WC.MISS)[:, None]

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
        ("residual rows (window 128) 32->64",
         WC.make_subm_plan_presorted(ll, cc, grid, window=128, resid_budget=n), f32, 64,
         (3, 3, 3)),
        ("window clipped at the end of V_in 32->64",
         WC.make_subm_plan_presorted(ll, cc, grid, window=384, resid_budget=n), f32, 64,
         (3, 3, 3)),
        ("all-padding blocks (budget 3x) 32->64", strided(*down, 3 * n_down), f32, 64,
         (3, 3, 3)),
        ("z-only (3,1,1) 32->64", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), n), f32, 64,
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


# the student's plane convs a training step: four a stage (two blocks of
# two), each under autograd (``plane_kernel.PlaneConv``)
PLANE_CONVS_A_STAGE = 4


def _plane_backward_rows(stages, gen):
    """B2 under autograd (``plane_kernel.PlaneConv``, the plane engine's
    training conv) at conv2..conv4's planes, masks and plans: its d state
    and d taps against autograd through ``plane_subm_plain`` (identity
    epilogue over the plan's targets) in float32 within 1e-4 + 1e-4*|p|, for
    the d taps 1e-4 * max|p| + 1e-4*|p| (the gradient of a linear map; its
    neighbour table misses nothing here), then
    its forward (the kernel, bf16 as training runs it) and its backward
    (``plane_conv.plane_conv_grad``: bf16 state, float32 gradient and sums)
    timed L2-warm, the backward beside its bound: the state, the gradient,
    d state and the neighbour table of the occupied planes once each, the
    taps and d taps, over 3.35 TB/s, or its two products (d state, d taps)
    at its (output cell, source cell) pairs over 989 TFLOP/s."""
    import torch

    from sparse2dense_tpu_torch.ops import plane_conv as PK
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.tools.bench_plane_subm import PLANE_STAGES

    rows, step_ms, step_bound = [], 0.0, 0.0
    for (name, c), (state, mask, sets, grid, plan) in zip(PLANE_STAGES, stages):
        n = state.shape[0]
        plan = plan._replace(nbr=PK.flat_neighbor_ranks(sets, n // len(sets)))
        w = torch.randn((27, c, c), device="cuda", generator=gen) * (27 * c) ** -0.5
        cot = torch.randn((n, 16 * c), device="cuda", generator=gen)
        m16 = PK.expand_mask(mask, c).float()
        ones = torch.ones((1, 16 * c), device="cuda")
        grads = []
        for function in (True, False):
            x, wt = state.float().clone().requires_grad_(True), w.clone().requires_grad_(True)
            out = (PK.pk_subm_conv_train(x, plan, wt, m16) if function else
                   PK.plane_subm_plain(x, plan.tgt, wt, ones, torch.zeros_like(ones), m16,
                                       relu=False))
            (out * cot).sum().backward()
            grads.append((x.grad, wt.grad))
            del out, x, wt
        torch.cuda.synchronize()
        planes = sum(int(t.valid.sum()) for t in sets)
        row = dict(kernel="plane_subm", case=f"backward {name} {c}->{c}", t1p=n, planes=planes,
                   n_miss=int(plan.n_miss.sum()), per_frame=0)
        for key, got, want in zip(("d_state", "d_weights"), *grads):
            err = (got - want).abs()
            # a tap's d weights sums T1p x 16 products (1.4 million at
            # conv2), in another order on each side: the absolute part of
            # the float32 tolerance scales with the largest value there
            floor = TOL_ABS * (float(want.abs().max()) if key == "d_weights" else 1.0)
            row[f"{key}_max_abs_err"] = float(err.max())
            row[f"{key}_max_abs_ref"] = float(want.abs().max())
            row[f"{key}_n_bad"] = int((err > floor + TOL_REL * want.abs()).sum())
        row["max_abs_err"] = max(row["d_state_max_abs_err"], row["d_weights_max_abs_err"])
        del grads
        sb, mb = state.to(torch.bfloat16), m16.to(torch.bfloat16)
        g = cot.to(torch.bfloat16)
        fwd = cuda_ms(lambda: PKK.PlaneConv.apply(sb, w, mb, plan), reps=10)
        bwd = cuda_ms(lambda: PK.plane_conv_grad(sb, w, plan.nbr, g.float() * mb.float()),
                      reps=3, warmup=1)
        hits = float(PK.plane_subm_plain(
            mask.float(), plan.tgt, torch.ones((27, 1, 1), device="cuda"),
            torch.ones((1, 16), device="cuda"), torch.zeros((1, 16), device="cuda"),
            mask.float(), relu=False).sum())
        nbytes = 3 * planes * 16 * c * 2 + planes * 26 * 4 + 27 * c * c * (2 + 4)
        flops = 2 * 2.0 * hits * c * c
        bound_ms, bound_by = bound(nbytes, flops)
        row.update(forward_ms=fwd, backward_ms=bwd, backward_bound_ms=bound_ms,
                   backward_bound_by=bound_by, hits=hits, bytes=nbytes, flops=flops,
                   per_step=PLANE_CONVS_A_STAGE)
        step_ms += PLANE_CONVS_A_STAGE * bwd
        step_bound += PLANE_CONVS_A_STAGE * bound_ms
        print("[kernels] " + json.dumps(row), flush=True)
        if row["d_state_n_bad"] or row["d_weights_n_bad"]:
            raise AssertionError(f"plane backward {name}: gradients beyond {TOL_ABS} + "
                                 f"{TOL_REL}*|p| of autograd through the plain formula")
        rows.append(row)
        torch.cuda.empty_cache()
    print(f"[kernels] plane backward a training step (the student's 12 plane convs): "
          f"{step_ms:.3f} ms, bound {step_bound:.3f} ms", flush=True)
    rows.append(dict(kernel="plane_subm", case="backward a step", plane_backward_ms=step_ms,
                     plane_backward_bound_ms=step_bound, per_frame=0, max_abs_err=0.0))
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


# the student's tile convs under autograd a training step, by stage: conv_input
# and the conv1 blocks' 4, then each block stage's 4; dense_from_stage 2 runs
# conv1 and conv2 on tiles, 99 all four
TILE_CONVS_A_STEP = {"conv1": 5, "conv2": 4, "conv3": 4, "conv4": 4}
TILE_STEP_STAGES = {2: ("conv1", "conv2"), 99: ("conv1", "conv2", "conv3", "conv4")}


def _tile_backward_rows(stages, gen):
    """B3 under autograd (``tile_kernel.TileConv``, the tile engine's
    training conv) at conv1..conv4's tile states, masks and plans: its
    forward (the kernel, float32) against ``tile_subm_plain`` (identity
    epilogue) and its d state and d taps against autograd through the plain
    version, within 1e-4 + 1e-4*|p|, for the d taps 1e-4 * max|p| +
    1e-4*|p| (the gradient of a linear map; a tap sums every live cell);
    then its forward (bf16, as training runs it) and its backward
    (``tile_kernel.tile_conv_grad``: bf16 state, float32 sums) timed
    L2-warm, the backward beside its bound: the state, the gradient and d
    state of the live (z, tile) planes once each, the targets, the taps and
    d taps, over 3.35 TB/s, or its two products (d state, d taps) at its
    (output cell, source cell) pairs over 989 TFLOP/s."""
    import torch

    from sparse2dense_tpu_torch.ops import tile_kernel as TKK
    from sparse2dense_tpu_torch.tools.bench_tile_subm import TILE_STAGES

    rows, per_stage = [], {}
    for (name, c, _), (state, mask, sets, grid, plan) in zip(TILE_STAGES, stages):
        tz, t1p = state.shape[:2]
        w = torch.randn((27, c, c), device="cuda", generator=gen) * (27 * c) ** -0.5
        cot = torch.randn((tz, t1p, 16 * c), device="cuda", generator=gen)
        m16 = TKK.expand_mask(mask, c).float()
        ones = torch.ones((1, 16 * c), device="cuda")
        grads = []
        for function in (True, False):
            x, wt = state.float().clone().requires_grad_(True), w.clone().requires_grad_(True)
            out = (TKK.tk_subm_conv_train(x, plan, wt, m16) if function else
                   TKK.tile_subm_plain(x, plan.tgt, wt, ones, torch.zeros_like(ones), m16,
                                       relu=False))
            (out * cot).sum().backward()
            grads.append((out.detach(), x.grad, wt.grad))
            del out, x, wt
        torch.cuda.synchronize()
        planes = int((mask.reshape(-1, 16) > 0).any(-1).sum())
        row = dict(kernel="tile_subm", case=f"backward {name} {c}->{c} tz {tz}", tz=tz,
                   t1p=t1p, planes=planes, n_miss=int(plan.n_miss.sum()), per_frame=0)
        for key, got, want in zip(("forward", "d_state", "d_weights"), *grads):
            err = (got - want).abs()
            floor = TOL_ABS * (float(want.abs().max()) if key == "d_weights" else 1.0)
            row[f"{key}_max_abs_err"] = float(err.max())
            row[f"{key}_max_abs_ref"] = float(want.abs().max())
            row[f"{key}_n_bad"] = int((err > floor + TOL_REL * want.abs()).sum())
        row["max_abs_err"] = max(row[f"{k}_max_abs_err"]
                                 for k in ("forward", "d_state", "d_weights"))
        del grads
        sb, mb = state.to(torch.bfloat16), m16.to(torch.bfloat16)
        g = cot.to(torch.bfloat16)
        fwd = cuda_ms(lambda: TKK.TileConv.apply(sb, w, mb, plan), reps=10)
        bwd = cuda_ms(lambda: TKK.tile_conv_grad(sb, w, plan.tgt, g, mb), reps=3, warmup=1)
        hits = float(TKK.tile_subm_plain(
            mask.float(), plan.tgt, torch.ones((27, 1, 1), device="cuda"),
            torch.ones((1, 16), device="cuda"), torch.zeros((1, 16), device="cuda"),
            mask.float(), relu=False).sum())
        nbytes = 3 * planes * 16 * c * 2 + t1p * 26 * 4 + 27 * c * c * (2 + 4)
        flops = 2 * 2.0 * hits * c * c
        bound_ms, bound_by = bound(nbytes, flops)
        row.update(forward_ms=fwd, backward_ms=bwd, backward_bound_ms=bound_ms,
                   backward_bound_by=bound_by, hits=hits, bytes=nbytes, flops=flops,
                   per_step=TILE_CONVS_A_STEP[name])
        per_stage[name] = (bwd, bound_ms)
        print("[kernels] " + json.dumps(row), flush=True)
        if row["forward_n_bad"] or row["d_state_n_bad"] or row["d_weights_n_bad"]:
            raise AssertionError(f"tile under autograd {name}: beyond {TOL_ABS} + "
                                 f"{TOL_REL}*|p| of the plain version")
        rows.append(row)
        torch.cuda.empty_cache()
    step = dict(kernel="tile_subm", case="backward a step", per_frame=0, max_abs_err=0.0)
    for dfs, names in TILE_STEP_STAGES.items():
        step[f"tile_backward_ms_dfs{dfs}"] = sum(TILE_CONVS_A_STEP[n] * per_stage[n][0]
                                                for n in names)
        step[f"tile_backward_bound_ms_dfs{dfs}"] = sum(TILE_CONVS_A_STEP[n] * per_stage[n][1]
                                                      for n in names)
        print(f"[kernels] tile backward a training step at dense_from_stage {dfs} (the "
              f"student's {sum(TILE_CONVS_A_STEP[n] for n in names)} tile convs): "
              f"{step[f'tile_backward_ms_dfs{dfs}']:.3f} ms, bound "
              f"{step[f'tile_backward_bound_ms_dfs{dfs}']:.3f} ms", flush=True)
    rows.append(step)
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
        if "registers" in line or "smem" in line or "spill" in line or "entry function" in line),
        flush=True)
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
    torch.cuda.empty_cache()
    rows += _plane_backward_rows(stages, gen)
    del stages
    torch.cuda.empty_cache()
    _, _, model = _flagship("tile", TILE_FRAME_BUDGETS, dict(dense_from_stage=99))
    stages = tile_stage_data(batch, model)
    del model
    rows += _tile_rows(stages, gen)
    rows += _tile_edge_rows(stages, gen)
    rows += _tile_backward_rows(stages, gen)
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


def phase_main_path(engine: str, budgets=None, overrides=None, tag=None):
    """The flagship on one engine: launches per frame of each kernel, with
    every count set to 0 just before the frames and read just after; every
    telemetry count within its budget. The first ``WARMUP_FRAMES`` frames
    (cuDNN autotuning, allocator growth) are not timed."""
    import torch

    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    _, batch, model = _flagship(engine, budgets, overrides)
    mods = {"window_pass": WK, "plane_subm": PKK, "tile_subm": TBK}
    tag = tag or engine
    expected = dict(zip(mods, EXPECTED_LAUNCHES[tag]))
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
    res = dict(engine=tag, budgets=budgets, frame_ms_median=sorted(times)[len(times) // 2],
               frame_ms_min=min(times), frame_ms_max=max(times), frame_ms=times,
               launches=launches, launches_per_frame=per_frame, detections=int(valid.sum()),
               max_heatmap=float(torch.sigmoid(out["preds"][0]["hm"]).max()),
               telemetry={k: int(v[0].max()) for k, v in out["telemetry"].items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    print("[main] " + json.dumps(res), flush=True)
    del model, out
    torch.cuda.empty_cache()
    return res


TRAIN_WARMUP, TRAIN_STEPS = 1, 3
TRAIN_LAUNCHES = 18   # window passes a step at batch 1: the teacher's two streams, the student
# the student's window-engine conv weights: the custom autograd Function's
WINDOW_WEIGHTS = ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                  "backbone.conv1_0.conv2_weight", "backbone.conv1_1.conv1_weight",
                  "backbone.conv1_1.conv2_weight", "backbone.conv2_down.conv_weight")
# the recipe's samples_per_gpu, timed over BIG_STEPS steps after one
BIG_BATCH, BIG_WARMUP, BIG_STEPS = 3, 1, 2
# one step with the dense stages rematerialised and one without, from the
# same weights, optimizer state and batch: the forward is the same, so the
# metrics but grad_norm and the BN running statistics agree within 1e-5;
# the backward recomputes the dense stages' bf16 convs, where cuDNN may
# pick another algorithm and its weight-gradient sums have no fixed order,
# so each gradient and grad_norm agree within 1e-2 of the largest gradient
# of the module that holds it
REMAT_GRAD_TOL, REMAT_STAT_TOL = 1e-2, 1e-5


def _check_metrics(tag, metrics):
    """Every metric finite (floats, or lists of floats a step), grad_norm > 0."""
    import math

    values = {k: v if isinstance(v, list) else [v] for k, v in metrics.items()}
    bad = [k for k, vs in values.items() if not all(math.isfinite(v) for v in vs)]
    if bad:
        raise AssertionError(f"{tag}: metrics not finite: {bad}")
    if not min(values["grad_norm"]) > 0:
        raise AssertionError(f"{tag}: grad_norm {values['grad_norm']}")


def _residual_rows(tag, trainer, batch):
    """Residual rows of every backbone run of the step (the teacher's two
    streams, the student) against their budgets."""
    import torch

    resid = {}
    with torch.inference_mode():
        for stream, model, prefix in (("teacher dense", trainer.teacher, "dense_"),
                                      ("teacher reconstruction", trainer.teacher,
                                       "reconstruction_"),
                                      ("student", trainer.model, "")):
            feats = model.reader(batch[prefix + "voxels"], batch[prefix + "num_points"])
            _, _, tele = model.backbone(feats, batch[prefix + "coordinates"])
            for name, (count, budget) in tele.items():
                resid[f"{stream} {name}"] = [int(count.max()), budget]
    over = {k: v for k, v in resid.items() if v[0] > v[1]}
    if over:
        raise AssertionError(f"{tag}: residual rows over budget: {over}")
    return resid


def _module_scaled_diff(got, want):
    """max over tensors of max|got - want| / the largest |want| of the module
    that holds the tensor."""
    scale = {}
    for name, w in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(w.abs().max()))
    return max(float((got[n] - w).abs().max()) / max(scale[n.rsplit(".", 1)[0]], 1e-30)
               for n, w in want.items())


def _remat_agreement(trainer, batch):
    """One step with the student's dense stages rematerialised and one
    without (``remat_dense``), from the same weights, optimizer state and
    batch: gradients, BN running statistics and metrics against each other,
    and each step's peak."""
    import copy

    import torch

    from sparse2dense_tpu_torch.tools import profile_train_step as PT

    student, opt = trainer.model, trainer.optimizer
    weights = {k: v.clone() for k, v in student.state_dict().items()}
    opt_state = copy.deepcopy(opt.state_dict())
    out = {}
    for remat in (True, False):
        student.load_state_dict(weights)
        opt.load_state_dict(opt_state)
        student.backbone.remat_dense = remat
        rows, metrics = PT.run_steps(trainer, batch, 1)
        out[remat] = dict(
            row=rows[0], metrics={k: float(v) for k, v in metrics.items()},
            grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                   for n, p in student.named_parameters()},
            stats={k: v.clone() for k, v in student.state_dict().items() if "running" in k})
    on, off = out[True], out[False]
    err = dict(
        gradients=_module_scaled_diff(on["grads"], off["grads"]),
        bn_running_stats=max(float((on["stats"][k] - v).abs().max())
                             for k, v in off["stats"].items()),
        metrics=max(abs(v - off["metrics"][k]) / max(abs(off["metrics"][k]), 1e-6)
                    for k, v in on["metrics"].items() if k != "grad_norm"),
        grad_norm=abs(on["metrics"]["grad_norm"] - off["metrics"]["grad_norm"])
        / off["metrics"]["grad_norm"])
    res = dict(max_err=err, peak_gb={"remat": on["row"]["step_peak_gb"],
                                     "no_remat": off["row"]["step_peak_gb"]},
               stages_peak_gb={"remat": on["row"]["peak_gb"], "no_remat": off["row"]["peak_gb"]},
               step_ms={"remat": on["row"]["step_ms"], "no_remat": off["row"]["step_ms"]})
    print("[train] remat on vs off, one step from the same weights and batch: "
          + json.dumps(res), flush=True)
    if max(err["gradients"], err["grad_norm"]) > REMAT_GRAD_TOL:
        raise AssertionError(f"train: gradients with and without remat differ: {err}")
    if max(err["bn_running_stats"], err["metrics"]) > REMAT_STAT_TOL:
        raise AssertionError(f"train: forward with and without remat differs: {err}")
    _check_metrics("train (no remat)", off["metrics"])
    return res


def phase_train():
    """The flagship teacher-student training step on the card
    (``tools/profile_train_step.py``), with the window-pass launch count set
    to 0 just before each run of steps and read just after: at batch 1 with
    the dense stages rematerialised (the default), then one step with and
    one without from the same weights (``_remat_agreement``), then
    ``TRAIN_STEPS`` steps without; then at the recipe's batch of 3."""
    import gc

    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import profile_train_step as PT

    batch, trainer = PT.train_setup(1, 2 * (TRAIN_WARMUP + TRAIN_STEPS) + 2)
    rows, metrics = PT.run_steps(trainer, batch, TRAIN_WARMUP + TRAIN_STEPS)
    launches = WK.launches
    per_step = [r["window_pass_launches"] for r in rows]
    if per_step != [TRAIN_LAUNCHES] * len(rows):
        raise AssertionError(f"train: window-pass launches a step {per_step}, expected "
                             f"{TRAIN_LAUNCHES}")
    metrics = {k: float(v) for k, v in metrics.items()}
    _check_metrics("train", metrics)
    params = dict(trainer.model.named_parameters())
    for name in WINDOW_WEIGHTS:
        g = params[name].grad
        if g is None or not bool(g.abs().max() > 0):
            raise AssertionError(f"train: the window-engine weight {name} got no gradient")
    resid = _residual_rows("train", trainer, batch)
    agreement = _remat_agreement(trainer, batch)
    off_rows, _ = PT.run_steps(trainer, batch, TRAIN_STEPS)   # remat off since the agreement
    res = dict(PT.summary(rows[TRAIN_WARMUP:]), launches=launches, launches_per_step=per_step,
               metrics=metrics, residual_rows_vs_budget=resid, steps=rows,
               remat_agreement=agreement, no_remat=PT.summary(off_rows))
    print("[train] " + json.dumps(res), flush=True)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()

    batch, trainer = PT.train_setup(BIG_BATCH, BIG_WARMUP + BIG_STEPS)
    rows, metrics = PT.run_steps(trainer, batch, BIG_WARMUP + BIG_STEPS)
    big = dict(PT.summary(rows[BIG_WARMUP:]), batch=BIG_BATCH, launches=WK.launches,
               launches_per_step=[r["window_pass_launches"] for r in rows],
               metrics={k: float(v) for k, v in metrics.items()}, steps=rows,
               card_gb=torch.cuda.get_device_properties(0).total_memory / 2 ** 30)
    _check_metrics(f"train batch {BIG_BATCH}", big["metrics"])
    if not (big["launches"] and len(set(big["launches_per_step"])) == 1):
        raise AssertionError(f"train batch {BIG_BATCH}: window-pass launches a step "
                             f"{big['launches_per_step']}")
    big["residual_rows_vs_budget"] = _residual_rows(f"train batch {BIG_BATCH}", trainer, batch)
    if not max(r["step_peak_gb"] for r in rows) < big["card_gb"]:
        raise AssertionError(f"train batch {BIG_BATCH}: peak {big['peak_mem_gb']} GiB")
    print("[train] batch " + json.dumps(big), flush=True)
    res["big"] = big
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# steps an epoch of the CLI phase's distillation runs, at the recipe's batch,
# so the config's text log (every 5 steps) writes a line
CLI_STEPS = 5


class _LogLines:
    """Collects the messages of one logger while the block runs."""

    def __init__(self, name):
        import logging

        self.logger, self.lines = logging.getLogger(name), []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _check_run(tag, trainer, epoch, steps):
    history = trainer.log_buffer.val_history
    if trainer.epoch != epoch or len(history.get("loss", [])) != steps:
        raise AssertionError(f"cli {tag}: epoch {trainer.epoch}, "
                             f"{len(history.get('loss', []))} steps; expected {epoch}, {steps}")
    _check_metrics(f"cli {tag}", {k: v for k, v in history.items()
                                  if k not in ("time", "data_time")})
    times = sorted(history["time"])
    return dict(steps=steps, step_s_median=times[len(times) // 2], step_s=history["time"])


def _same_state(tag, model_state, opt_state, state):
    import torch

    bad = [k for k, v in state["model"].items() if not torch.equal(model_state[k].cpu(), v)]
    moments = [(i, k) for i, m in state["optimizer"]["state"].items() for k, v in m.items()
               if not torch.equal(opt_state["state"][i][k].cpu(), v)]
    if bad or moments or opt_state["count"] != state["optimizer"]["count"]:
        raise AssertionError(f"cli {tag}: differs from the checkpoint: {bad[:5]} {moments[:5]} "
                             f"count {opt_state['count']} vs {state['optimizer']['count']}")


def phase_cli(recipe="flagship"):
    """A recipe through its command line (``tools/train.py``, in this
    process, on the card) in a temporary work directory, with the
    window-pass launch count set to 0 just before and read just after: the
    dense teacher (its config, 1 epoch of 2 synthetic frames at batch 1)
    writes ``epoch_1``; the distillation config loads it as its teacher
    (``--load_from``) and trains 1 epoch of 5 steps at the config's batch
    (the flagship's 3, SECOND's 4); a run with ``--resume_from latest
    --epochs 1`` restores the model, BN buffers and optimizer exactly and
    takes no step; ``--epochs 2`` takes the second epoch's steps."""
    import gc
    import tempfile

    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import train as cli
    from sparse2dense_tpu_torch.training.checkpoint import load_checkpoint
    from sparse2dense_tpu_torch.utils.config import (DENSE_TEACHER, FLAGSHIP, SECOND,
                                                     SECOND_DENSE, ConfigDict)

    dense_cfg, distil_cfg = ((DENSE_TEACHER, FLAGSHIP) if recipe == "flagship" else
                             (SECOND_DENSE, SECOND))
    batch = ConfigDict.fromfile(distil_cfg).data["samples_per_gpu"]
    frames = CLI_STEPS * batch

    def done(trainer):
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    res, t0 = {}, time.perf_counter()
    WK.launches = 0
    with tempfile.TemporaryDirectory() as tmp, _LogLines("sparse2dense_tpu_torch") as log:
        dense, distil = os.path.join(tmp, "dense"), os.path.join(tmp, "distill")
        trainer = cli.main([dense_cfg, "--work_dir", dense, "--synthetic", "2",
                            "--batch_size", "1", "--epochs", "1"])
        res["dense_teacher"] = _check_run("dense teacher", trainer, 1, 2)
        done(trainer)
        ckpt = os.path.join(dense, "epoch_1")
        saved = load_checkpoint(ckpt)[0]["model"]
        common = [distil_cfg, "--work_dir", distil, "--load_from", ckpt,
                  "--synthetic", str(frames)]
        latest = os.path.join(distil, "latest")
        torch.cuda.reset_peak_memory_stats()
        trainer = cli.main(common + ["--epochs", "1"])
        res["distill"] = _check_run("distill", trainer, 1, CLI_STEPS)
        res["distill"]["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        teacher = trainer.teacher.state_dict()
        bad = [k for k, v in saved.items() if not torch.equal(teacher[k].cpu(), v)]
        if bad or sorted(teacher) != sorted(saved):
            raise AssertionError(f"cli: the teacher is not the dense run's checkpoint: {bad[:5]}")
        if os.readlink(latest) != "epoch_1":
            raise AssertionError(f"cli: latest -> {os.readlink(latest)}")
        done(trainer)
        state, meta = load_checkpoint(latest)
        trainer = cli.main(common + ["--resume_from", latest, "--epochs", "1"])
        _same_state("resume", trainer.model.state_dict(), trainer.optimizer.state_dict(), state)
        if (trainer.epoch, trainer.global_iter) != (meta["epoch"], meta["iter"]) or \
                meta["iter"] != CLI_STEPS:
            raise AssertionError(f"cli: resumed at {trainer.epoch}, {trainer.global_iter}; "
                                 f"meta {meta['epoch']}, {meta['iter']}")
        done(trainer)
        trainer = cli.main(common + ["--resume_from", latest, "--epochs", "2"])
        res["resumed"] = _check_run("resumed", trainer, 2, CLI_STEPS)
        if (trainer.global_iter, trainer.optimizer.count) != (2 * CLI_STEPS,) * 2 or \
                os.readlink(latest) != "epoch_2":
            raise AssertionError(f"cli: after the second epoch iter {trainer.global_iter}, "
                                 f"optimizer step {trainer.optimizer.count}, latest -> "
                                 f"{os.readlink(latest)}")
        done(trainer)
    steps = CLI_STEPS
    for want in (f"epoch [1][{steps}/{steps}]", f"epoch [2][{steps}/{steps}]",
                 "loaded teacher checkpoint", "resumed from"):
        if not any(want in line for line in log):
            raise AssertionError(f"cli: no log line with {want!r}")
    res.update(recipe=recipe, batch=batch, launches=WK.launches,
               seconds=time.perf_counter() - t0,
               text_log_lines=[line for line in log if line.startswith("epoch [")])
    print(f"[cli] {recipe} " + json.dumps(res), flush=True)
    return res


# SECOND's window passes: a frame (subm0's two convs, down1) and a sample of
# a teacher-student step (the teacher's two streams and the student)
SECOND_FRAME_LAUNCHES, SECOND_STEP_LAUNCHES = 3, 9
SECOND_WINDOW_WEIGHTS = ("backbone.subm0.conv_0_weight", "backbone.subm0.conv_1_weight",
                         "backbone.down1.conv_weight")
# gather against window on one frame, the BEV: the window engine stores the
# dense stages' activations in bf16 and the gather engine in float32, so the
# nine dense convs after down1 (subm1 2, down2, subm2 3, down3, subm3 3 ...)
# see up to one bf16 rounding (2^-8 relative) of their input each more on
# the window side; bounded by their sum, relative to the map's largest value
SECOND_BEV_TOL = 9 * 2.0 ** -8
SECOND_BATCHES = (1, 4)   # the TS step at batch 1 and at the recipe's samples_per_gpu


def _second_model(engine):
    """(cfg, student) of the SECOND recipe at full width on the card, its
    backbone on ``engine`` (the config's dense stages from down1 kept)."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.utils.config import SECOND, flagship

    cfg = flagship(engine, path=SECOND)
    return cfg, build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                               voxel_generator=cfg["voxel_generator"], device="cuda",
                               generator=torch.Generator().manual_seed(0))


@contextlib.contextmanager
def _gather_conv_in_bf16():
    """The gather engine's convs on their operands rounded to bf16, as the
    window pass multiplies them (bf16 products, float32 sums), while the
    block runs."""
    import torch

    from sparse2dense_tpu_torch.models.backbones import scn as SCN

    old = SCN._gather_conv

    def gather_bf16(feats, nbr, w, b=None):
        return old(feats.to(torch.bfloat16).float(), nbr, w.to(torch.bfloat16).float(), b)

    SCN._gather_conv = gather_bf16
    try:
        yield
    finally:
        SCN._gather_conv = old


def _rows_by_cell(feats, coords, valid, grid):
    """A sample's valid rows sorted by their grid-linear cell."""
    from sparse2dense_tpu_torch.ops.sparse_conv import ravel_coords

    f, c = feats[0][valid[0]], coords[0][valid[0]]
    order = ravel_coords(c, grid).long().argsort()
    return f[order].float(), c[order]


def _second_agreement(batch, window_model):
    """The SECOND student's backbone on one frame, window engine (B1) against
    gather engine (``gather_conv``, an independent formulation) with the same
    weights, in inference: subm0's and down1's rows within the bf16 kernel
    tolerance (the gather side's conv operands rounded to bf16), the BEV
    within ``SECOND_BEV_TOL`` of its largest value."""
    import torch

    _, gather = _second_model("gather")
    gather.load_state_dict(window_model.state_dict())
    gather.eval()
    grid = window_model.backbone.sparse_shape
    got = {}
    for tag, model in (("window", window_model), ("gather", gather)):
        def hook(mod, args, out, tag=tag):
            # down1's input is subm0's output; its output holds its grid
            # (window: out, coords, keys, valid, grid, plans; gather: out,
            # coords, valid, grid)
            g_out = out[4] if len(out) == 6 else out[3]
            got[tag] = dict(subm0=_rows_by_cell(args[0], args[1], (args[1] >= 0).all(-1), grid),
                            down1=_rows_by_cell(out[0], out[1], (out[1] >= 0).all(-1), g_out))
        h = model.backbone.down1.register_forward_hook(hook)
        try:
            with torch.inference_mode(), (_gather_conv_in_bf16() if tag == "gather"
                                          else contextlib.nullcontext()):
                feats = model.reader(batch["voxels"], batch["num_points"])
                got[tag]["bev"] = model.backbone(feats, batch["coordinates"])[0].float()
        finally:
            h.remove()
    res = {}
    for key in ("subm0", "down1"):
        (fw, cw), (fg, cg) = got["window"][key], got["gather"][key]
        if not torch.equal(cw, cg):
            raise AssertionError(f"second: {key}'s active rows differ between the engines")
        err = (fw - fg).abs()
        tol = BF16_STEP * fg.abs() + BF16_FLOOR * fg.abs().max()
        res[key] = dict(rows=int(fw.shape[0]), max_abs_err=float(err.max()),
                        worst_over_tol=float((err / tol).max()))
        if not bool((err <= tol).all()):
            raise AssertionError(f"second: {key} window against gather beyond the bf16 "
                                 f"tolerance: {res[key]}")
    bw, bg = got["window"]["bev"], got["gather"]["bev"]
    res["bev"] = dict(shape=list(bw.shape), max_abs_err=float((bw - bg).abs().max()),
                      rel_to_max=float((bw - bg).abs().max() / bg.abs().max()),
                      tol=SECOND_BEV_TOL)
    if not res["bev"]["rel_to_max"] <= SECOND_BEV_TOL:
        raise AssertionError(f"second: BEV window against gather: {res['bev']}")
    del gather
    return res


def _second_steps(batch_size):
    """SECOND teacher-student steps at ``batch_size`` (1 warm-up, 2 timed;
    batch 1: 2 and 4): medians, stages, peaks, B1 launches a step, metrics,
    the window-engine weights' gradients, residual rows. At the recipe's
    batch a step that runs out of memory is reported with the stages it got
    through (the fault the slice records), not raised."""
    import gc

    import torch

    from sparse2dense_tpu_torch.tools import profile_train_step as PT
    from sparse2dense_tpu_torch.utils.config import SECOND

    warmup, steps = (TRAIN_WARMUP, TRAIN_STEPS) if batch_size == 1 else (BIG_WARMUP, BIG_STEPS)
    batch, trainer = PT.train_setup(batch_size, warmup + steps, config=SECOND)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    try:
        rows, metrics = PT.run_steps(trainer, batch, warmup + steps)
    except torch.cuda.OutOfMemoryError as e:
        if batch_size == 1:
            raise
        res = dict(batch=batch_size, out_of_memory=True, card_gb=card_gb,
                   stages_ms=getattr(e, "stages_ms", None),
                   stages_peak_gb=getattr(e, "stages_peak_gb", None),
                   failed_stage_peak_gb=getattr(e, "failed_peak_gb", None),
                   error=str(e).splitlines()[0])
        print("[second] train batch " + json.dumps(res), flush=True)
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        return res
    per_step = [r["window_pass_launches"] for r in rows]
    if per_step != [SECOND_STEP_LAUNCHES * batch_size] * len(rows):
        raise AssertionError(f"second batch {batch_size}: window-pass launches a step "
                             f"{per_step}, expected {SECOND_STEP_LAUNCHES * batch_size}")
    metrics = {k: float(v) for k, v in metrics.items()}
    _check_metrics(f"second batch {batch_size}", metrics)
    params = dict(trainer.model.named_parameters())
    for name in SECOND_WINDOW_WEIGHTS:
        g = params[name].grad
        if g is None or not bool(g.abs().max() > 0):
            raise AssertionError(f"second: the window-engine weight {name} got no gradient")
    res = dict(PT.summary(rows[warmup:]), batch=batch_size, out_of_memory=False,
               launches=sum(per_step), launches_per_step=per_step, metrics=metrics,
               card_gb=card_gb, steps=rows,
               residual_rows_vs_budget=_residual_rows(f"second batch {batch_size}", trainer,
                                                      batch))
    print(f"[second] train batch {batch_size} " + json.dumps(res), flush=True)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_second():
    """The SECOND recipe on the card: the student's inference frames (window
    engine, ``WARMUP_FRAMES`` + ``TIMED_FRAMES``, 3 window passes a frame,
    the count set to 0 just before and read just after), the same frame on
    the gather engine against the window engine (``_second_agreement``), the
    teacher-student step at batch 1 and 4 (``_second_steps``) and the CLI
    chain (``phase_cli("second")``)."""
    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.training.synthetic import make_batch

    cfg, model = _second_model("window")
    frame_args = dict(max_voxels=150000, n_points=170000, n_obj=32, device="cuda")
    tb = [time.perf_counter()]
    batch = make_batch(cfg, 1, **frame_args)             # the anchors alone
    tb.append(time.perf_counter())
    make_batch(cfg, 1, with_targets=True, **frame_args)  # and AssignTarget's assignment
    tb.append(time.perf_counter())
    # the host's time to assign 212,064 anchors against the frame's boxes, set-up
    # outside every timed frame and step
    make_batch_s, assign_s = tb[1] - tb[0], (tb[2] - tb[1]) - (tb[1] - tb[0])
    torch.cuda.reset_peak_memory_stats()
    times, per_frame = [], []
    WK.launches = 0
    for i in range(WARMUP_FRAMES + TIMED_FRAMES):
        before = WK.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(batch)
            det = model.predict(out, example=batch)
        torch.cuda.synchronize()
        if i >= WARMUP_FRAMES:
            times.append((time.perf_counter() - t0) * 1e3)
        per_frame.append(WK.launches - before)
    launches = WK.launches
    if per_frame != [SECOND_FRAME_LAUNCHES] * len(per_frame):
        raise AssertionError(f"second: window-pass launches per frame {per_frame}")
    for name, (count, budget) in out["telemetry"].items():
        if int(count.max()) > budget:
            raise AssertionError(f"second: {name} counts {int(count.max())} > {budget}")
    maps = [v for pd in out["preds"] for v in pd.values()]
    if not all(bool(torch.isfinite(m).all()) for m in maps):
        raise AssertionError("second: non-finite head maps")
    if tuple(maps[0].shape[1:3]) != (188, 188) or \
            batch["anchors"][0].shape[1] != 188 * 188 * 6:
        raise AssertionError(f"second: head map {tuple(maps[0].shape)}, anchors "
                             f"{tuple(batch['anchors'][0].shape)}")
    valid = det["valid"]
    if not int(valid.sum()) or not bool(torch.isfinite(det["box3d_lidar"][valid]).all()):
        raise AssertionError("second: no finite detections")
    frame = dict(frame_ms_median=sorted(times)[len(times) // 2], frame_ms_min=min(times),
                 frame_ms_max=max(times), frame_ms=times, launches=launches,
                 launches_per_frame=per_frame, detections=int(valid.sum()),
                 telemetry={k: int(v[0].max()) for k, v in out["telemetry"].items()},
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 make_batch_s=make_batch_s, assign_target_s=assign_s)
    print("[second] frame " + json.dumps(frame), flush=True)
    with no_tf32():
        agreement = _second_agreement(batch, model)
    print("[second] gather against window, one frame: " + json.dumps(agreement), flush=True)
    del model, out, batch
    torch.cuda.empty_cache()
    steps = {b: _second_steps(b) for b in SECOND_BATCHES}
    cli = phase_cli("second")
    return dict(frame=frame, agreement=agreement, steps=steps, cli=cli,
                train_launches=sum(r.get("launches", 0) for r in steps.values()))


# phase 10: teacher-student steps a run at batch 1 (the recipe's batch 3:
# BIG_WARMUP, BIG_STEPS); the weights each engine's step must reach (its
# windowed or plane convs); the train-mode BEV against the shipped engine's:
# the window engine at dense_from_stage 1 stores the conv2 stage's
# activations in bf16 on the dense grid, the others in float32 rows or bf16
# plane state, so each of the nine convs from conv2 on sees up to one more
# bf16 rounding (2^-8 relative) of its input on one side (as SECOND_BEV_TOL)
ENGINE_WARMUP, ENGINE_STEPS = 1, 3
_TILE_WEIGHTS = ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                 "backbone.conv2_down.conv_weight", "backbone.conv2_1.conv2_weight")
ENGINE_WEIGHTS = {
    "window_dfs2": ("backbone.conv2_down.conv_weight", "backbone.conv2_0.conv1_weight",
                    "backbone.conv2_1.conv2_weight", "backbone.conv3_down.conv_weight"),
    "plane": ("backbone.conv2_down.conv_weight", "backbone.conv2_0.conv1_weight",
              "backbone.conv3_down.conv_weight", "backbone.conv4_1.conv2_weight",
              "backbone.extra_conv.conv_weight"),
    "tile": _TILE_WEIGHTS,
    "tile_dfs99": _TILE_WEIGHTS + ("backbone.conv3_down.conv_weight",
                                   "backbone.conv4_1.conv2_weight",
                                   "backbone.extra_conv.conv_weight")}
# (B1 a sample, B2 a step, B3 a step) of a teacher-student step: the
# teacher's two streams and the student each run the frame's kernels once
# (B2 and B3 take the batch flattened)
ENGINE_LAUNCHES = {"window_dfs2": (3 * 11, 0, 0), "plane": (3 * 6, 3 * 12, 0),
                   "tile": (0, 0, 3 * 9), "tile_dfs99": (0, 0, 3 * 17)}
ENGINE_BEV_TOL = 9 * 2.0 ** -8


def _engine_agreement(batch, settings):
    """The flagship student's backbone in train mode (batch statistics, no
    gradient) on the frame, on the window engine as shipped and on the
    engine ``settings`` names, with the same weights: the BEV against the
    shipped engine's, relative to its largest value. Judged against
    ``ENGINE_BEV_TOL`` only where every counter of both runs says the
    reference is exact (residual rows within their budgets, no drop or
    miss); else the error is printed with the counters and not judged."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.models.backbones.scn import WinDownsample
    from sparse2dense_tpu_torch.utils.config import FLAGSHIP, ConfigDict

    bevs, tele, weights = {}, {}, None
    for tag, override in (("shipped", {}), ("engine", settings)):
        cfg = ConfigDict.fromfile(FLAGSHIP)
        cfg.S_model.backbone.update(override)
        model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                               voxel_generator=cfg.voxel_generator, device="cuda",
                               generator=torch.Generator().manual_seed(1))
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        model.train()
        rows, hooks = {}, []
        down = model.backbone.conv3_down
        if isinstance(down, WinDownsample):
            # a strided window conv's output set is cut at its stage budget:
            # it dropped nothing while its valid rows stay below the budget
            hooks.append(down.register_forward_hook(
                lambda mod, args, out: rows.update(n=int(out[3].sum(-1).max()),
                                                   budget=out[3].shape[1])))
        try:
            with torch.no_grad():
                feats = model.reader(batch["voxels"], batch["num_points"])
                bev, _, t = model.backbone(feats, batch["coordinates"])
        finally:
            for h in hooks:
                h.remove()
        bevs[tag] = bev.float()
        tele[tag] = {k: [int(v[0].max()), v[1]] for k, v in t.items()}
        if rows:
            tele[tag]["conv3_down rows (budget less one)"] = [rows["n"], rows["budget"] - 1]
        del model
    exact = all(c <= b for t in tele.values() for c, b in t.values())
    diff = float((bevs["engine"] - bevs["shipped"]).abs().max())
    res = dict(counters=tele, exact=exact, max_abs_err=diff,
               rel_to_max=diff / float(bevs["shipped"].abs().max()), tol=ENGINE_BEV_TOL)
    if exact and not res["rel_to_max"] <= ENGINE_BEV_TOL:
        raise AssertionError(f"engines: train-mode BEV against the shipped engine: {res}")
    if not exact:
        print("[engines] not judged: a counter says the reference is not exact: "
              + json.dumps(res), flush=True)
    del bevs
    torch.cuda.empty_cache()
    return res


def _engine_steps(tag, settings, batch_size):
    """Teacher-student steps on the engine ``settings`` names, teacher and
    student alike: batch 1 ``ENGINE_WARMUP`` + ``ENGINE_STEPS``, batch 3
    ``BIG_WARMUP`` + ``BIG_STEPS``; medians by stage, peaks, the B1, B2 and
    B3 launches a step (``ENGINE_LAUNCHES[tag]``: a sample for B1, a batch
    for B2 and B3), every loss finite, a gradient on ``ENGINE_WEIGHTS[tag]``,
    and every backbone run's counters (the teacher's two streams, the
    student) within their budgets."""
    import gc

    import torch

    from sparse2dense_tpu_torch.tools import profile_train_step as PT

    warmup, steps = (ENGINE_WARMUP, ENGINE_STEPS) if batch_size == 1 else (BIG_WARMUP,
                                                                           BIG_STEPS)
    batch, trainer = PT.train_setup(batch_size, warmup + steps, backbone=settings)
    rows, metrics = PT.run_steps(trainer, batch, warmup + steps)
    got = [(r["window_pass_launches"], r["plane_subm_launches"], r["tile_subm_launches"])
           for r in rows]
    b1, b2, b3 = ENGINE_LAUNCHES[tag]
    want = (b1 * batch_size, b2, b3)
    if got != [want] * len(rows):
        raise AssertionError(f"{tag} batch {batch_size}: (B1, B2, B3) launches a step {got}, "
                             f"expected {want}")
    metrics = {k: float(v) for k, v in metrics.items()}
    _check_metrics(f"{tag} batch {batch_size}", metrics)
    params = dict(trainer.model.named_parameters())
    for name in ENGINE_WEIGHTS[tag]:
        g = params[name].grad
        if g is None or not bool(g.abs().max() > 0):
            raise AssertionError(f"{tag}: the weight {name} got no gradient")
    res = dict(PT.summary(rows[warmup:]), batch=batch_size, launches_per_step=got,
               launches=[sum(x) for x in zip(*got)], metrics=metrics, steps=rows,
               counters=_residual_rows(f"{tag} batch {batch_size}", trainer, batch))
    print(f"[engines] {tag} train batch {batch_size} " + json.dumps(res), flush=True)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_engines(plane_frame, tile_frame):
    """The flagship's training on the engines past the shipped one: the
    window engine at ``dense_from_stage=2`` (``DFS2_FRAME_SETTINGS``), the
    plane engine at ``FRAME_BUDGETS`` and the tile engine at
    ``TILE_FRAME_BUDGETS`` (``dense_from_stage`` 2 and 99), teacher and
    student alike: the inference frame (phase 4's way; the plane and tile
    engines' are phases 5 and 6), the teacher-student step at batch 1 and at
    the recipe's 3 (the tile engine at ``dense_from_stage`` 99 at batch 1
    only; ``_engine_steps``), and the student's train-mode BEV against the
    shipped window engine on the same weights (``_engine_agreement``)."""
    from sparse2dense_tpu_torch.tools import profile_train_step as PT
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import flagship

    res = {}
    for tag, settings, frame, batches in (
            ("window_dfs2", PT.engine_settings("window", 2), None, (1, BIG_BATCH)),
            ("plane", PT.engine_settings("plane"), plane_frame, (1, BIG_BATCH)),
            ("tile", PT.engine_settings("tile"), tile_frame, (1, BIG_BATCH)),
            ("tile_dfs99", PT.engine_settings("tile", 99), None, (1,))):
        if tag == "window_dfs2":
            frame = phase_main_path("window", overrides=settings, tag=tag)
        batch = make_batch(flagship(), 1, max_voxels=150000, n_points=170000, n_obj=32,
                           device="cuda")
        r = dict(settings=settings, frame=frame, agreement=_engine_agreement(batch, settings))
        print(f"[engines] {tag} student in train mode against the shipped engine: "
              + json.dumps(r["agreement"]), flush=True)
        if tag.startswith("tile") and not r["agreement"]["exact"]:
            raise AssertionError(f"{tag}: a tile counter is above 0: {r['agreement']}")
        del batch
        r["steps"] = {b: _engine_steps(tag, settings, b) for b in batches}
        res[tag] = r
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
    worst["tile_train"] = _tiny_tile_train_agreement()
    worst["ts_step"] = _ts_step_agreement()
    return worst


def _tiny_tile_train_agreement():
    """The tiny tile student's backbone in train mode (B3 under autograd,
    ``TileConv``) on the card against the same weights and batch on the
    CPU: its BEV and the gradient of sum(BEV^2) on every backbone weight,
    each within ``TINY_TOL["tile"]`` of the largest CPU value (float32 tile
    convs on both sides)."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import ConfigDict

    cfg = ConfigDict.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", "tests", "distill_tiny.py"))
    cfg["S_model"]["backbone"].update(TINY_ENGINES["tile"])
    bevs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                               voxel_generator=cfg["voxel_generator"], device=dev,
                               generator=torch.Generator().manual_seed(3))
        model.train()
        batch = make_batch(cfg, 1, max_voxels=512, n_points=3000, n_obj=6, device=dev)
        TBK.launches = 0
        feats = model.reader(batch["voxels"], batch["num_points"])
        bev, _, tele = model.backbone(feats, batch["coordinates"])
        bev.float().square().sum().backward()
        if dev == "cuda" and TBK.launches != 9:
            raise AssertionError(f"tiny tile train: {TBK.launches} B3 launches, expected 9")
        if any(int(v[0].max()) for v in tele.values()):
            raise AssertionError(f"tiny tile train: counters above 0: {tele}")
        bevs[dev] = bev.detach().float().cpu()
        grads[dev] = {n: p.grad.cpu() for n, p in model.backbone.named_parameters()
                      if p.grad is not None}
    ref = grads["cpu"]
    errs = dict(bev=float((bevs["cuda"] - bevs["cpu"]).abs().max()
                          / bevs["cpu"].abs().max()),
                gradients=max(float((grads["cuda"][n] - g).abs().max()) for n, g in ref.items())
                / max(float(g.abs().max()) for g in ref.values()))
    print(f"[agreement] tiny tile backbone in train mode, cuda vs cpu: max |diff| / max "
          f"|ref| {json.dumps(errs)}; {len(ref)} gradients", flush=True)
    if sorted(grads["cuda"]) != sorted(ref) or max(errs.values()) > TINY_TOL["tile"]:
        raise AssertionError(f"tiny tile backbone in train mode disagrees with its CPU run: "
                             f"{errs} > {TINY_TOL['tile']}")
    return max(errs.values())


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


def _record(name, source, replaces, launches, rows, per="per_frame"):
    frame = [r for r in rows if r.get(per)]
    lib = [r["library_ms"] for r in frame]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per frame: each timed shape times its launches in one frame
        "ms": sum(r["ms"] * r[per] for r in frame),
        "cold_ms": sum(r["cold_ms"] * r[per] for r in frame),
        "plain_ms": sum(r["plain_ms"] * r[per] for r in frame),
        "bound_ms": sum(r["bound_ms"] * r[per] for r in frame),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in frame)
                     else "operations"),
        "library_ms": (None if any(x is None for x in lib)
                       else sum(x * r[per] for x, r in zip(lib, frame))),
    }


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    cli = phase_cli()
    second = phase_second()
    engines = phase_engines(plane, tile)
    with no_tf32():
        phase_agreement()

    wrows, prows, trows = ([r for r in rows if r["kernel"] == k]
                           for k in ("window_pass", "plane_subm", "tile_subm"))
    b1_paths = {"window": window["launches"]["window_pass"],
                "plane": plane["launches"]["window_pass"], "train": train["launches"],
                f"train_batch{BIG_BATCH}": train["big"]["launches"], "cli": cli["launches"],
                "second": second["frame"]["launches"], "second_train": second["train_launches"],
                "second_cli": second["cli"]["launches"]}
    b2_paths = {"plane": plane["launches"]["plane_subm"]}
    b3_paths = {"tile": tile["launches"]["tile_subm"]}
    for tag, r in engines.items():
        if tag == "window_dfs2":
            b1_paths[tag] = r["frame"]["launches"]["window_pass"]
        for b, st in r["steps"].items():
            key = f"{tag}_train" + ("" if b == 1 else f"_batch{b}")
            for paths, n in zip((b1_paths, b2_paths, b3_paths), st["launches"]):
                if n:
                    paths[key] = n
    b2_bwd = [r for r in prows if "plane_backward_ms" in r][0]
    b3_bwd = [r for r in trows if "tile_backward_ms_dfs2" in r][0]
    record = {"kernels": [
        dict(_record("window_pass", "sparse2dense_tpu_torch/csrc/window_pass.cu",
                     "sparse2dense_tpu/ops/pallas/window_kernel.py:69",
                     sum(b1_paths.values()), wrows), launches_by_path=b1_paths,
             dfs2_frame=_record("window_pass", "", "", 0, wrows, "per_frame_dfs2")),
        dict(_record("plane_subm", "sparse2dense_tpu_torch/csrc/plane_subm.cu",
                     "sparse2dense_tpu/ops/pallas/plane_block_kernel.py:131",
                     sum(b2_paths.values()), prows), launches_by_path=b2_paths,
             backward_ms_per_step=b2_bwd["plane_backward_ms"],
             backward_bound_ms_per_step=b2_bwd["plane_backward_bound_ms"]),
        dict(_record("tile_subm", "sparse2dense_tpu_torch/csrc/tile_subm.cu",
                     "sparse2dense_tpu/ops/pallas/tile_block_kernel.py:156",
                     sum(b3_paths.values()), trows), launches_by_path=b3_paths,
             **{k: v for k, v in b3_bwd.items() if k.startswith("tile_backward")}),
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
    for tag, t in (("batch 1, remat", train), ("batch 1, no remat", train["no_remat"]),
                   (f"batch {BIG_BATCH}, remat", train["big"])):
        print(f"[train] teacher-student step, {tag}: median {t['step_ms']:.1f} ms "
              f"({', '.join(f'{k} {v:.1f}' for k, v in t['stages_ms'].items())}); peak "
              f"{t['peak_mem_gb']:.2f} GiB (by stage: "
              f"{', '.join(f'{k} {v:.2f}' for k, v in t['stages_peak_gb'].items())})", flush=True)
    print(f"[train] window backward {b1_bwd:.3f} ms a step at batch 1 "
          f"({b1_bwd / train['step_ms']:.2%}); window passes a step: {TRAIN_LAUNCHES} at batch 1, "
          f"{train['big']['launches_per_step'][0]} at batch {BIG_BATCH}", flush=True)
    print(f"[kernels] window_pass a dense_from_stage=2 frame: L2-warm "
          f"{record['kernels'][0]['dfs2_frame']['ms']:.4f} ms, L2-cold "
          f"{record['kernels'][0]['dfs2_frame']['cold_ms']:.4f} ms; plane backward a training "
          f"step {b2_bwd['plane_backward_ms']:.3f} ms (bound "
          f"{b2_bwd['plane_backward_bound_ms']:.3f}); tile backward a training step "
          f"{b3_bwd['tile_backward_ms_dfs2']:.3f} ms at dense_from_stage 2 (bound "
          f"{b3_bwd['tile_backward_bound_ms_dfs2']:.3f}), {b3_bwd['tile_backward_ms_dfs99']:.3f} "
          f"ms at 99 (bound {b3_bwd['tile_backward_bound_ms_dfs99']:.3f})", flush=True)
    for tag, r in engines.items():
        frame = (f"frame median {r['frame']['frame_ms_median']:.1f} ms" if r["frame"] else
                 "no frame")
        print(f"[engines] {tag}: {frame}; student train-mode BEV against the shipped engine "
              f"{r['agreement']['rel_to_max']:.3e} of its largest value "
              f"({'judged' if r['agreement']['exact'] else 'not judged'})", flush=True)
        for b, t in r["steps"].items():
            print(f"[engines] {tag} teacher-student step, batch {b}: median {t['step_ms']:.1f} "
                  f"ms ({', '.join(f'{k} {v:.1f}' for k, v in t['stages_ms'].items())}); peak "
                  f"{t['peak_mem_gb']:.2f} GiB; (B1, B2, B3) launches a step "
                  f"{t['launches_per_step'][0]}", flush=True)
    print(f"[cli] dense teacher -> load_from -> distil at batch {BIG_BATCH} -> resume: "
          f"{cli['seconds']:.1f} s; distillation steps (time hook) median "
          f"{cli['distill']['step_s_median']:.3f} s, peak {cli['distill']['peak_gb']:.2f} GiB",
          flush=True)
    sf, sa = second["frame"], second["agreement"]
    print(f"[second] frame: median {sf['frame_ms_median']:.1f} ms, min "
          f"{sf['frame_ms_min']:.1f}, max {sf['frame_ms_max']:.1f} (set-up on the host: "
          f"make_batch {sf['make_batch_s']:.2f} s, AssignTarget's assignment "
          f"{sf['assign_target_s']:.2f} s a sample); gather against window: "
          f"subm0 {sa['subm0']['max_abs_err']:.3e}, down1 {sa['down1']['max_abs_err']:.3e}, "
          f"BEV {sa['bev']['rel_to_max']:.3e} of its largest value", flush=True)
    for b, t in second["steps"].items():
        if t["out_of_memory"]:
            print(f"[second] teacher-student step, batch {b}: out of memory "
                  f"({t['card_gb']:.1f} GiB card); stages done {t['stages_peak_gb']}, failed "
                  f"stage's peak {t['failed_stage_peak_gb']:.2f} GiB", flush=True)
        else:
            print(f"[second] teacher-student step, batch {b}: median {t['step_ms']:.1f} ms "
                  f"({', '.join(f'{k} {v:.1f}' for k, v in t['stages_ms'].items())}); peak "
                  f"{t['peak_mem_gb']:.2f} GiB (by stage: "
                  f"{', '.join(f'{k} {v:.2f}' for k, v in t['stages_peak_gb'].items())})",
                  flush=True)
    print(f"[second] cli: dense teacher -> load_from -> distil at batch {second['cli']['batch']} "
          f"-> resume: {second['cli']['seconds']:.1f} s, peak "
          f"{second['cli']['distill']['peak_gb']:.2f} GiB", flush=True)
    print(f"[main] chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' build "
          f"included", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
