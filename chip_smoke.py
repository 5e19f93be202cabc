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
     z-only); the plans ``dense_from_stage`` 3 and 99 add
     (``_window_deep_cases``: the conv3 blocks' subm plan 64->64, the
     strided conv4_down 64->128, the conv4 blocks' subm plan 128->128 and
     the z-only extra_conv 128->128, and SECOND's z-only extra_conv 64->64,
     at ``DFS99_FRAME_SETTINGS``), the streamed widths on the edge cases
     (one window buffer and two), and the window backward a step at
     ``dense_from_stage`` 3 and 99;
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
   with its stages' peaks); the student at ``dense_from_stage`` 3 and 99
   (the flagship's frame settings; 1 + 3 frames each, 10 and 14 window
   passes a frame, every counter and stage within its budget); and the CLI
   chain of phase 8 for SECOND's two configs (dense teacher at batch 1,
   distillation at 4);
10. engines: the flagship's training past the shipped engine, teacher and
   student alike: the window engine at ``dense_from_stage=2`` (plan windows
   ``utils.config.DFS2_FRAME_SETTINGS``: plan windows, residual and stage
   budgets that fit this frame;
   its inference frame as phase 4's, 11 window passes a
   frame) and the plane engine at ``FRAME_BUDGETS`` (its frame is phase
   5's): the student's train-mode BEV against the shipped window engine's
   on the same weights (within ``ENGINE_BEV_TOL`` of its largest value
   where every counter says the reference is exact; else printed, not
   judged), and the teacher-student step at batch 1 (1 + 2 steps) and at
   the recipe's 3 (1 + 2): medians by stage, peaks, the window-pass and
   plane-conv launches a step (dense_from_stage 2: 33 B1 a sample; plane:
   18 B1 a sample and 36 B2 a step), every loss finite, a gradient on the
   engine's convs, every backbone run's counters within their budgets;
   then the window engine at ``dense_from_stage`` 3 and 99
   (``DFS3_FRAME_SETTINGS``, ``DFS99_FRAME_SETTINGS``; 16 and 21 window
   passes a frame, 48 and 63 a step at batch 1): the frame, every
   residual and stage counter within its budget (else the phase fails),
   the train-mode BEV against the shipped engine (judged), the step at
   batch 1 with a gradient on every window conv past conv2_down;
   then the tile engine (``tile_backend="pallas"``, which trains as "xla"
   does) at ``TILE_FRAME_BUDGETS`` the same way (its frame is phase 6's),
   at ``dense_from_stage`` 2 (batch 1 and 3; 27 B3 launches a step: the
   student's 9 under autograd, the teacher's two streams' 18) and 99 (batch
   1; 51 B3 launches: B3 at all four widths under autograd, and
   ``TileZConv``); its counters must be 0;
11. pp: the pillar recipe (``configs/waymo_centerpoint_pp_two_pfn_stride1_3x_*``:
   PointPillars teacher, KD_PointPillars student with the S2D scatter, the
   "pp" distillation branch) at full width (468x468 grid, PFN [64, 64], RPN
   [3, 5, 5] x [64, 128, 256]) on the bench's cloud voxelized by the
   recipe's pillar generator: the frame's pillars kept and dropped at the
   train (32,000) and test (60,000) budgets; the teacher's and the
   student's inference frames at the test budget (3 warm-up, 8 timed;
   finite maps and detections); the teacher-student step at batch 1 (1 + 3)
   and the recipe's 3 (1 + 2) at the train budget: medians by stage, peaks,
   every loss finite, ``grad_norm`` > 0, a gradient on the pillar net, the
   S2D scatter's encoder and PCR generator, the neck and the head; the tiny
   pp step on the card against the CPU (``PP_TINY_TOL``); the CLI chain of
   phase 8 for the two pillar configs (distillation at batch 3). No B1, B2
   or B3 launch on any of these paths;
12. data: the flagship recipe from records (``phase_data``): Waymo-layout
   records of the bench's scene (170k points, 32 objects a frame; 6 scenes
   filling 30 training infos at the recipe's interval of 5, 5 val frames;
   a dense object set for every object) in a temporary directory, the
   recipe's text with its data paths pointed there; the host pipeline's ms
   a sample in this process (train: the dense-set synthesis, 5 voxel
   streams, the targets; val), the native voxelizer bit-equal to its NumPy
   version on a frame (ms of each); ``tools/train.py`` on it, 1 epoch of 2
   teacher-student steps at the recipe's batch of 3 with its 4 spawned
   input workers (finite losses, ``grad_norm`` > 0, a checkpoint, 54 window
   passes a step; each step's ms, the loader's wait and the peak memory);
   ``tools/test.py --checkpoint <it> --speed_test`` on the val split (the
   detections' file, the evaluation's mAP dict, 6 window passes a frame,
   ms a frame), then on an untrained student at score threshold 0, whose
   candidates reach the NMS and the evaluator's matching (more than 0
   detections, a finite mAP, ms a frame); the val boxes scored as
   detections evaluate to 1; every line with the card's name and power limit;
13. dp: data parallelism on the one card (``phase_dp``; NCCL refuses two
   ranks on one device): ``tools/train.py --launcher pytorch`` at world
   size 1 through NCCL on phase 12's records (batch 3, 2 steps, 108 window
   passes, a checkpoint, one NCCL all-reduce); the flagship teacher-student
   step at two spawned ranks of one sample through gloo on the card against
   this process at batch 2 on the same samples, in four precisions
   (``DP_CASES``: float32, bf16 dense stages alone, TF32 alone, 1 step each;
   as shipped, 2 steps; the first step's metrics and gradients within
   ``DP_F32_TOL`` in float32 and ``DP_TOL`` as shipped, both also read
   against the one process run again): the ranks' parameters equal to the bit
   after each step, each rank's step ms, gradient all-reduce ms, peak GiB
   and window passes; ``tools/test.py --launcher pytorch`` at world size 2
   on the val records: rank 0's merged detections against phase 12's one
   process within ``DP_DET_TOL``, rank 1 None. The ranks find the kernels
   phase 2 built;
14. two_stage: the flagship two-stage recipe
   (``configs/waymo_centerpoint_voxelnet_two_stage_distill_interval_5.py``:
   the KD_VoxelNet student frozen under the RoI head; 500 RoIs, 5 points a
   box, BEV at stride 8 from 512 channels) at full width on the bench's
   frame, seeded weights, the first stage's heatmap bias set so that
   ``TS_CANDIDATES`` cells a sample pass the score threshold
   (``phase_two_stage``): inference frames (``TS_WARMUP`` + ``TS_TIMED``,
   then ``TS_TIMED`` with the stages synchronised: the first stage's maps
   and its predict (decode, NMS), BEV, RoI head, predict; 6 B1 launches a
   frame, finite boxes, scores in [0, 1]); model-level training steps at
   batch 1 and at the recipe's 6 through ``make_train_step`` (the frozen
   first stage, the proposal targets with the 3D IoU, the RoI head forward
   and backward, ``OneCycleAdam``; medians of its stages and peaks, then
   train-mode forwards and losses split by stage; the 3D IoU's host ms, event span
   and profiled device operations; every metric finite, both RoI losses
   above 0, a gradient on every RoI head parameter, none on the first
   stage, which does not move; 6 B1 a sample a step and a forward); the pillar two-stage recipe's frame (no B1, B2 or B3 launch);
   the tiny two-stage model on the card against the CPU (``TS_TINY_TOL``);
   the det3d converter at full width (the dense teacher's weights through a
   det3d ``.pth``, ``tools/convert_checkpoint.py`` and ``--load_from``'s
   loader: every entry equal, head maps within ``TS_CONVERT_TOL``); and
   ``tools/test.py --checkpoint`` on the recipe over phase 12's val
   records (the detections' file, the mAP dict, 6 B1 a frame).
   ``python3 chip_smoke.py two_stage`` runs this phase alone (on records
   of its own; it prints no kernels line and no last line);
15. nusc: the nuScenes families (``phase_nusc``): nuScenes-layout records
   of ``NUSC_FRAMES`` 10-sweep scenes (~30k points a sweep after the
   close-point removal; ~137k voxels a view at 0.075 x 0.075 x 0.2 m, under
   the test budget of 160,000); B1 against its plain version on the served
   frame's own plans (conv_input, conv1, conv2_down on the 41x1440x1440
   grid) and conv2_down's active cells against the stage budget;
   ``nusc_centerpoint_voxelnet_0075voxel_dcn_flip`` at full width from the
   val records (seeded weights, its heatmap bias set so that
   ``NUSC_CANDIDATES`` cells a frame pass the score threshold): frames of 4
   views (DCN heads, the double-flip merge; ``NUSC_WARMUP`` +
   ``NUSC_TIMED``, then as many split by stage: reader and backbone, neck,
   DCN heads, merge, decode and NMS, with the host pipeline and the copy to
   the card apart), 24 B1 launches a frame, the backbone's counters and the
   peak; ``tools/test.py --batch_size 2 --checkpoint`` over the records
   (each frame its own token, the results json, 48 B1 a batch; at 1 frame
   if 8 views do not fit, with the peak); ``make_train_step`` on
   ``0075voxel_dcn`` from the train records at batch 1 and the recipe's 4
   (medians, peaks, finite metrics, a gradient on every DCN conv, 6 B1 a
   sample; out of memory reported with its peak); the ``circular_nms``
   pillar recipe's frame (no B1, B2 or B3); the tiny nuScenes model on the
   card against the CPU (``NUSC_TINY_TOL``). ``python3 chip_smoke.py nusc``
   runs this phase alone (it prints no kernels line and no last line);
16. agreement: the tiny distillation model on the card against the same model
   on the CPU (plain versions only), window, plane and tile engines; the
   tiny tile backbone's train-mode forward and backward on the card (B3
   under autograd) against the CPU: BEV and every gradient within
   ``TINY_TOL["tile"]`` of the largest; and one
   teacher-student step of the tiny pair (window engine) on the card against
   the same step on the CPU with its window pass on bf16-rounded inputs (as
   the kernel multiplies): every metric, the student gradient as a whole and
   each window-engine conv weight's gradient within 2e-2 (the tiny step is
   ill-conditioned: ``_ts_step_agreement`` says how much).

TF32 is switched off for cuDNN and matmuls in phases 2, 16, the gather
comparison of 9 and the tiny runs of 11, 14 and 15, which compare against
float32 plain versions or the CPU; the rest of phases 3 to 15 run at PyTorch's
defaults (TF32 on in cuDNN convs, off in matmuls). With TF32 off cuDNN picks an FFT
algorithm for the neck's 3x3 convs that costs ~200 ms a frame on an H100
(``sparse2dense_tpu_torch/tools/profile_flagship.py``). The second-to-last
lines are a JSON record of the kernels (the sparse convs per frame, the
probes per call, L2-cold) and the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
TOL_ABS, TOL_REL = 1e-4, 1e-4  # float32: summation order only
BF16_STEP = 2.0 ** -7          # one bf16 rounding step, relative
BF16_FLOOR = 1e-3              # times max|p|: outputs near zero
# launches a frame of (window_pass, plane_subm, tile_subm) per engine; the
# window engine at dense_from_stage 2 adds the conv2 blocks' 4 and conv3_down
EXPECTED_LAUNCHES = {"window": (6, 0, 0), "plane": (6, 12, 0), "tile": (0, 0, 9),
                     "window_dfs2": (11, 0, 0), "window_dfs3": (16, 0, 0),
                     "window_dfs99": (21, 0, 0)}
WARMUP_FRAMES, TIMED_FRAMES = 3, 8   # a frame's time still falls over its first ~3
# the window engine at dense_from_stage 2, teacher and student alike, at
# ``profile_train_step.engine_settings("window", 2)``: plan windows, residual
# and stage budgets that fit the frame (``utils.config.DFS2_FRAME_SETTINGS``);
# its window passes a frame by case of the kernel phase
DFS2_WINDOW_LAUNCHES = {"conv_input 5->16": 1, "conv1 16->16": 4, "conv2_down 16->32": 1,
                        "conv2 32->32": 4, "conv3_down 32->64": 1}
# dense_from_stage 3 adds the conv3 blocks and conv4_down, 99 the conv4 blocks
# and the z-only extra_conv (``utils.config.DFS3_FRAME_SETTINGS``,
# ``DFS99_FRAME_SETTINGS``)
DFS3_WINDOW_LAUNCHES = dict(DFS2_WINDOW_LAUNCHES, **{"conv3 64->64": 4,
                                                     "conv4_down 64->128": 1})
DFS99_WINDOW_LAUNCHES = dict(DFS3_WINDOW_LAUNCHES, **{"conv4 128->128": 4,
                                                      "extra_conv (3,1,1) 128->128": 1})


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
    n_taps = ksize[0] * ksize[1] * ksize[2]   # the live taps' weights: 3 on a z-only plan
    nbytes = (v_in * cin * 2 + v_in * 4 + nb * 128 * 3 * 4 + nb * 3 * 4 + 9 * 3 * 4
              + n_taps * cin * cout * 2 + vo * cout * 4)
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
               per_frame=per_frame, per_frame_dfs2=DFS2_WINDOW_LAUNCHES.get(name, 0),
               per_frame_dfs3=DFS3_WINDOW_LAUNCHES.get(name, 0),
               per_frame_dfs99=DFS99_WINDOW_LAUNCHES.get(name, 0))
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
    deep = _window_dfs2_cases(coords, lin, grid, gen) + _window_deep_cases(coords, grid, gen)
    rows += [_window_case_row(*case, gen) for case in deep]
    torch.cuda.empty_cache()
    rows += _window_edge_rows(feats5, feats16, coords, lin, grid, gen)
    rows += _window_backward_rows(cases, feats16, coords, lin, grid, gen)
    return rows + _window_deep_backward_rows(deep, rows[-1]["window_backward_ms"], gen)


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


def _window_deep_cases(coords, grid, gen):
    """The window plans ``dense_from_stage`` 3 and 99 add on the flagship
    frame, at the windows, stage and residual budgets of
    ``DFS99_FRAME_SETTINGS`` (the same dict as ``DFS3_FRAME_SETTINGS``): the conv3 blocks' subm plan 64->64 and the strided
    conv4_down 64->128 on a seeded 64-channel state of the conv3_down output
    rows; the conv4 blocks' subm plan 128->128 and the z-only extra_conv
    (3,1,1) 128->128 on a seeded 128-channel state of the conv4_down output
    rows; and SECOND's z-only extra_conv at 64->64 on the same plan. Cases
    as ``_window_case_row`` takes them."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid
    from sparse2dense_tpu_torch.utils.config import DFS99_FRAME_SETTINGS as DFS99

    wins, budgets, resid = DFS99["win_window"], DFS99["stage_budgets"], DFS99["win_resid_budget"]
    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    down4 = ((2, 2, 2), (0, 1, 1), (3, 3, 3))
    zonly = ((2, 1, 1), (0, 0, 0), (3, 1, 1))
    chain, c, g = [], coords, grid
    for k, conv in enumerate((down, down, down4, zonly)):
        g_out = conv_out_grid(g, *conv)
        oc, ol = WC.downsample_active_set_yxz(c, c[:, 0] >= 0, g, g_out, *conv, budgets[k])
        chain.append((c, g, oc, ol, g_out))
        c, g = oc, g_out
    (_, _, c3, l3, g3), (_, _, c4, l4, g4), (_, _, c5, l5, g5) = chain[1:]
    f64 = torch.randn(l3.shape[0], 64, device="cuda", generator=gen) * (l3 < WC.MISS)[:, None]
    f128 = torch.randn(l4.shape[0], 128, device="cuda", generator=gen) * (l4 < WC.MISS)[:, None]
    subm3 = WC.make_subm_plan_presorted(l3, c3, g3, window=wins[2])
    strided4 = WC.make_strided_plan(l3, l4, c4, g3, g4, *down4, window=wins[3],
                                    resid_budget=resid)
    subm4 = WC.make_subm_plan_presorted(l4, c4, g4, window=wins[3])
    extra = WC.make_strided_plan(l4, l5, c5, g4, g5, *zonly, window=wins[3], resid_budget=resid)
    return [("conv3 64->64", subm3, f64, 64, 64, (3, 3, 3), 0, (1, 1, 1), (1, 1, 1), c3, g3),
            ("conv4_down 64->128", strided4, f64, 64, 128, (3, 3, 3), 0, (2, 2, 2), (0, 1, 1),
             c3, g3),
            ("conv4 128->128", subm4, f128, 128, 128, (3, 3, 3), 0, (1, 1, 1), (1, 1, 1), c4,
             g4),
            ("extra_conv (3,1,1) 128->128", extra, f128, 128, 128, (3, 1, 1), 0, (2, 1, 1),
             (0, 0, 0), c4, g4),
            ("SECOND extra_conv (3,1,1) 64->64", extra, f128[:, :64].contiguous(), 64, 64,
             (3, 1, 1), 0, (2, 1, 1), (0, 0, 0), c4, g4)]


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


# the student's window-pass backwards a step past the shipped ones, by plan,
# at dense_from_stage 3 and 99 (the conv2 blocks, conv3_down, the conv3
# blocks, conv4_down; at 99 also the conv4 blocks and extra_conv), each plan
# with its reader table
DEEP_BACKWARDS = {3: {"conv2 32->32": 4, "conv3_down 32->64": 1, "conv3 64->64": 4,
                      "conv4_down 64->128": 1}}
DEEP_BACKWARDS[99] = dict(DEEP_BACKWARDS[3], **{"conv4 128->128": 4,
                                                "extra_conv (3,1,1) 128->128": 1})


def _window_deep_backward_rows(cases, shipped_ms, gen):
    """The window backward (``window_pass_grad`` and the reader table) timed
    at the plans ``dense_from_stage`` 2, 3 and 99 add, and the student's
    window backward a step at 3 and 99: the shipped step's ``shipped_ms``
    plus ``DEEP_BACKWARDS``."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC

    per_plan = {}
    for name, plan, f, cin, cout, ksize, *_ in cases:
        if name not in DEEP_BACKWARDS[99]:
            continue
        wd = WC.taps_zyx_to_dyx(torch.randn((cout, cin) + ksize, device="cuda", generator=gen))
        g = torch.randn((plan.out_lin.shape[0], cout), device="cuda", generator=gen)
        readers = WC.reader_table(plan)
        ms = cuda_ms(lambda: WC.window_pass_grad(f, wd, readers, g), reps=3, warmup=1)
        table_ms = cuda_ms(lambda: WC.reader_table(plan), reps=3, warmup=1)
        per_plan[name] = (ms, table_ms)
        print("[kernels] " + json.dumps(dict(kernel="window_pass", case=f"backward time {name}",
                                             v_out=plan.out_lin.shape[0], backward_ms=ms,
                                             reader_table_ms=table_ms)), flush=True)
        del readers, g
        torch.cuda.empty_cache()
    row = dict(kernel="window_pass", case="deep backward a step", per_frame=0, max_abs_err=0.0)
    for dfs, counts in DEEP_BACKWARDS.items():
        # one reader table a plan: the conv2 and conv3 (and conv4) blocks share theirs
        row[f"window_backward_ms_dfs{dfs}"] = shipped_ms + sum(
            per_plan[name][0] * n + per_plan[name][1] for name, n in counts.items())
    print("[kernels] window backward a training step: " + json.dumps(row), flush=True)
    return [row]


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
    clipped windows, all-padding blocks and the z-only plan; and the
    streamed widths (64->64, 64->128, 128->128) on seeded 64- and
    128-channel states: GATE groups, clipped windows with two window
    buffers and with one, a window of 1,024 rows (one buffer), all-padding
    blocks and the z-only plan."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid

    n = 30037
    f5, f16, cc, ll = feats5[:n], feats16[:n], coords[:n], lin[:n]
    active = int((ll < WC.MISS).sum())
    f32, f64, f128 = (torch.randn(n, c, device="cuda", generator=gen) * (ll < WC.MISS)[:, None]
                      for c in (32, 64, 128))

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
        # the streamed widths, with two window buffers and with one
        ("residual rows (window 128) 64->64",
         WC.make_subm_plan_presorted(ll, cc, grid, window=128, resid_budget=n), f64, 64,
         (3, 3, 3)),
        ("residual rows (window 128) 128->128",
         WC.make_subm_plan_presorted(ll, cc, grid, window=128, resid_budget=n), f128, 128,
         (3, 3, 3)),
        ("window clipped at the end of V_in 64->128",
         WC.make_subm_plan_presorted(ll, cc, grid, window=384, resid_budget=n), f64, 128,
         (3, 3, 3)),
        ("window clipped at the end of V_in, one buffer 128->128",
         WC.make_subm_plan_presorted(ll, cc, grid, window=384, resid_budget=n), f128, 128,
         (3, 3, 3)),
        ("window 1024, one buffer 64->64",
         WC.make_subm_plan_presorted(ll, cc, grid, window=1024, resid_budget=n), f64, 64,
         (3, 3, 3)),
        ("all-padding blocks (budget 3x) 64->128", strided(*down, 3 * n_down), f64, 128,
         (3, 3, 3)),
        ("z-only (3,1,1) 64->64", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), n), f64, 64,
         (3, 1, 1)),
        ("z-only (3,1,1) 128->128", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), n), f128, 128,
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
                   buffers=WK.window_buffers(cin, cout, window),
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


@contextlib.contextmanager
def _stage_rows(backbone, rows):
    """Forward hooks that put, for each strided window conv of
    ``backbone``, its valid output rows (the most of a sample) and its stage
    budget less one into ``rows`` under "<module> rows (budget less one)": a
    strided window conv's output set is cut at its budget, so it dropped
    nothing while its valid rows stay below the budget."""
    from sparse2dense_tpu_torch.models.backbones.scn import WinDownsample

    def hook(mod, args, out, name):
        rows[f"{name} rows (budget less one)"] = [int(out[3].sum(-1).max()),
                                                   out[3].shape[1] - 1]

    hooks = [mod.register_forward_hook(partial(hook, name=name))
             for name, mod in backbone.named_modules() if isinstance(mod, WinDownsample)]
    try:
        yield rows
    finally:
        for h in hooks:
            h.remove()


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
    stage_rows = {}
    if engine == "window":   # one more frame, outside the timed ones
        with _stage_rows(model.backbone, stage_rows), torch.inference_mode():
            model(batch)
        over = {k: v for k, v in stage_rows.items() if v[0] > v[1]}
        if over:
            raise AssertionError(f"{tag}: a strided window conv filled its stage budget: {over}")
    res = dict(engine=tag, budgets=budgets, frame_ms_median=sorted(times)[len(times) // 2],
               frame_ms_min=min(times), frame_ms_max=max(times), frame_ms=times,
               launches=launches, launches_per_frame=per_frame, detections=int(valid.sum()),
               max_heatmap=float(torch.sigmoid(out["preds"][0]["hm"]).max()),
               telemetry={k: int(v[0].max()) for k, v in out["telemetry"].items()},
               stage_rows=stage_rows, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
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
    takes no step; ``--epochs 2`` takes the second epoch's steps. The
    pillar recipe ("pp", batch 3) must launch none of B1, B2, B3."""
    import gc
    import tempfile

    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import train as cli
    from sparse2dense_tpu_torch.training.checkpoint import load_checkpoint
    from sparse2dense_tpu_torch.utils.config import (DENSE_TEACHER, FLAGSHIP, PP, PP_DENSE,
                                                     SECOND, SECOND_DENSE, ConfigDict)

    dense_cfg, distil_cfg = {"flagship": (DENSE_TEACHER, FLAGSHIP),
                             "second": (SECOND_DENSE, SECOND), "pp": (PP_DENSE, PP)}[recipe]
    batch = ConfigDict.fromfile(distil_cfg).data["samples_per_gpu"]
    frames = CLI_STEPS * batch

    def done(trainer):
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    res, t0 = {}, time.perf_counter()
    _zero_sparse_launches()
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
    if recipe == "pp" and any(_sparse_launches()):
        raise AssertionError(f"cli pp: (B1, B2, B3) launches {_sparse_launches()}")
    res.update(recipe=recipe, batch=batch, launches=WK.launches,
               sparse_launches=list(_sparse_launches()), seconds=time.perf_counter() - t0,
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
    del model, out
    torch.cuda.empty_cache()
    deep = {dfs: _second_deep_frames(batch, dfs) for dfs in SECOND_DEEP_LAUNCHES}
    del batch
    steps = {b: _second_steps(b) for b in SECOND_BATCHES}
    cli = phase_cli("second")
    return dict(frame=frame, agreement=agreement, deep=deep, steps=steps, cli=cli,
                train_launches=sum(r.get("launches", 0) for r in steps.values()))


SECOND_DEEP_FRAMES = 3   # timed, after one warm-up
# window passes a SECOND frame by dense_from_stage: subm0 2, down1 1, subm1 2,
# down2 1, then subm2 3 and down3 1, then subm3 3 and extra_conv 1
SECOND_DEEP_LAUNCHES = {3: 10, 99: 14}


def _second_deep_frames(batch, dfs):
    """SECOND's student with the window engine at ``dense_from_stage``
    ``dfs`` (3 or 99; ``profile_train_step.engine_settings("window", dfs)``,
    the flagship's frame settings: the two backbones' strided convs make the
    same active sets), seeded weights, on the phase's frame: 1 warm-up and
    ``SECOND_DEEP_FRAMES`` timed frames, ``SECOND_DEEP_LAUNCHES[dfs]`` window
    passes each (the count set to 0 just before and read just after), every
    counter and stage within its budget, finite maps and detections."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import profile_train_step as PT
    from sparse2dense_tpu_torch.utils.config import SECOND, flagship

    cfg = flagship("window", path=SECOND)
    cfg["S_model"]["backbone"].update(PT.engine_settings("window", dfs))
    model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                           voxel_generator=cfg["voxel_generator"], device="cuda",
                           generator=torch.Generator().manual_seed(0))
    times, per_frame = [], []
    WK.launches = 0
    for i in range(1 + SECOND_DEEP_FRAMES):
        before = WK.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(batch)
            det = model.predict(out, example=batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        per_frame.append(WK.launches - before)
    launches = WK.launches
    stage_rows = {}
    with _stage_rows(model.backbone, stage_rows), torch.inference_mode():
        model(batch)
    tag = f"second dense_from_stage {dfs}"
    if per_frame != [SECOND_DEEP_LAUNCHES[dfs]] * len(per_frame):
        raise AssertionError(f"{tag}: window-pass launches per frame {per_frame}")
    counters = dict({k: [int(v[0].max()), v[1]] for k, v in out["telemetry"].items()},
                    **stage_rows)
    over = {k: v for k, v in counters.items() if v[0] > v[1]}
    if over:
        raise AssertionError(f"{tag}: counters over their budgets: {over}")
    maps = [v for pd in out["preds"] for v in pd.values()]
    valid = det["valid"]
    if not all(bool(torch.isfinite(m).all()) for m in maps) or not int(valid.sum()) or \
            not bool(torch.isfinite(det["box3d_lidar"][valid]).all()):
        raise AssertionError(f"{tag}: non-finite maps or no finite detections")
    res = dict(dense_from_stage=dfs, frame_ms_median=sorted(times)[len(times) // 2],
               frame_ms=times, launches=launches, launches_per_frame=per_frame,
               counters=counters, detections=int(valid.sum()))
    print("[second] " + json.dumps(res), flush=True)
    del model, out
    torch.cuda.empty_cache()
    return res


# the pillar recipe (phase "pp"): the bench's cloud (170k points, 32
# objects, seed 0) voxelized by the recipe's pillar generator; its eval
# frames at the test budget of 60,000 pillars, its steps at the train budget
# of 32,000 (``utils.config.frame_voxels``); the TS step at batch 1 and the
# recipe's 3; the weights whose gradients must be nonzero: the pillar net,
# the S2D scatter's encoder and PCR generator, the neck and the head
PP_FRAME = dict(n_points=170000, n_obj=32)
PP_BATCHES = (1, 3)
PP_WEIGHTS = ("reader.pfn_0.linear.weight", "backbone.encoder_1a.conv.weight",
              "backbone.generator_a.conv.weight", "neck.block_0.down.conv.weight",
              "bbox_head.task_0.hm_out.weight")
# the tiny pp pair on the card against the CPU (float32, TF32 off): every
# metric relative to its CPU value and the whole student gradient relative to
# its largest CPU value, as the window engine's tiny step (``TINY_TOL``).
# The tiny pp step is ill-conditioned (ReLUs, the max over points and the
# max-pools put kinks within float32 rounding of its data; which kinks a run
# meets depends on each build's rounding): one float32 rounding step on the
# student's weights moved one CPU build's gradient by ~1e-3 of its largest
# value with one point a pillar and by ~0.4 with pp_tiny's 8 point slots
# (``python -m tests.test_torch_pp`` prints the reference's own spread), so
# the comparison is judged with one point a pillar and printed with 8; each
# run also prints each device's own spread beside it
PP_TINY_TOL = 2e-2


def _sparse_launches():
    """(B1, B2, B3) launch counts."""
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    return WK.launches, PKK.launches, TBK.launches


def _zero_sparse_launches():
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    WK.launches = PKK.launches = TBK.launches = 0


def _pp_frames(cfg, key, batch):
    """Inference frames of the pp recipe's ``key`` model (teacher "model",
    student "S_model"), heatmap bias -6 as the flagship's: medians of
    ``TIMED_FRAMES`` after ``WARMUP_FRAMES``, finite maps and boxes, no
    sparse-engine launch."""
    import copy

    import torch

    from sparse2dense_tpu_torch.models import build_detector

    mcfg = copy.deepcopy(cfg[key])
    mcfg["bbox_head"]["init_bias"] = -6.0
    model = build_detector(mcfg, test_cfg=cfg["test_cfg"], voxel_generator=cfg["voxel_generator"],
                           device="cuda", generator=torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    times = []
    _zero_sparse_launches()
    for i in range(WARMUP_FRAMES + TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(batch)
            det = model.predict(out)
        torch.cuda.synchronize()
        if i >= WARMUP_FRAMES:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = _sparse_launches()
    if any(launches):
        raise AssertionError(f"pp {key}: (B1, B2, B3) launches {launches} on the pillar path")
    maps = [v for pd in out["preds"] for v in pd.values()]
    if not all(bool(torch.isfinite(m).all()) for m in maps):
        raise AssertionError(f"pp {key}: non-finite head maps")
    if tuple(maps[0].shape[1:3]) != model.backbone.grid_shape:
        raise AssertionError(f"pp {key}: head map shape {tuple(maps[0].shape)}")
    valid = det["valid"]
    if not bool(torch.isfinite(det["box3d_lidar"][valid]).all()):
        raise AssertionError(f"pp {key}: non-finite boxes")
    res = dict(model=type(model).__name__, frame_ms_median=sorted(times)[len(times) // 2],
               frame_ms_min=min(times), frame_ms_max=max(times), frame_ms=times,
               sparse_launches=list(launches), detections=int(valid.sum()),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, out
    torch.cuda.empty_cache()
    return res


def _pp_steps(batch_size):
    """pp teacher-student steps at ``batch_size`` (batch 1: 1 + 3 steps, the
    recipe's 3: 1 + 2): medians by stage (synchronised) and peaks, every
    loss finite, grad_norm > 0, a nonzero gradient on ``PP_WEIGHTS``, no
    sparse-engine launch."""
    import gc

    import torch

    from sparse2dense_tpu_torch.tools import profile_train_step as PT
    from sparse2dense_tpu_torch.utils.config import PP

    warmup, steps = (TRAIN_WARMUP, TRAIN_STEPS) if batch_size == 1 else (BIG_WARMUP, BIG_STEPS)
    batch, trainer = PT.train_setup(batch_size, warmup + steps, config=PP)
    if trainer.branch != "pp":
        raise AssertionError(f"pp: the trainer's branch is {trainer.branch!r}")
    rows, metrics = PT.run_steps(trainer, batch, warmup + steps)
    launches = [(r["window_pass_launches"], r["plane_subm_launches"], r["tile_subm_launches"])
                for r in rows]
    if any(any(n) for n in launches):
        raise AssertionError(f"pp batch {batch_size}: (B1, B2, B3) launches a step {launches}")
    metrics = {k: float(v) for k, v in metrics.items()}
    _check_metrics(f"pp batch {batch_size}", metrics)
    params = dict(trainer.model.named_parameters())
    for name in PP_WEIGHTS:
        g = params[name].grad
        if g is None or not bool(g.abs().max() > 0):
            raise AssertionError(f"pp batch {batch_size}: {name} got no gradient")
    card_gb = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    res = dict(PT.summary(rows[warmup:]), batch=batch_size, launches_per_step=launches,
               metrics=metrics, card_gb=card_gb, steps=rows,
               pillars=int((batch["num_points"] > 0).sum()))
    print(f"[pp] train batch {batch_size} " + json.dumps(res), flush=True)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _pp_tiny_cfg(points):
    """The tiny pp distillation pair from ``configs/tests/pp_tiny.py``:
    teacher pp_tiny, student KD_PointPillars with the S2D scatter, both
    pillar nets ending at 64 channels (the S2D scatter's width), ``points``
    points a pillar."""
    import copy

    from sparse2dense_tpu_torch.utils.config import ConfigDict

    cfg = ConfigDict.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", "tests", "pp_tiny.py"))
    teacher = cfg["S_model"]
    teacher["reader"]["num_filters"] = [32, 64]
    teacher["backbone"]["num_input_features"] = 64
    teacher["neck"]["num_input_features"] = 64
    student = copy.deepcopy(teacher)
    student["type"], student["backbone"]["type"] = "KD_PointPillars", "PointPillarsScatter_S2D"
    cfg["model"], cfg["S_model"], cfg["distillation"] = teacher, student, True
    cfg["voxel_generator"]["max_points_in_voxel"] = points
    return cfg


def _pp_tiny_step(cfg, dev, perturb=False):
    """(metrics, student gradients) of one tiny pp teacher-student step on
    ``dev``; with ``perturb``, the student's weights times (1 + 2^-23 N(0, 1))."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.training.trainer import TS_Trainer

    kw = dict(test_cfg=cfg["test_cfg"], voxel_generator=cfg["voxel_generator"], device=dev)
    teacher = build_detector(cfg["model"], generator=torch.Generator().manual_seed(4), **kw)
    student = build_detector(cfg["S_model"], generator=torch.Generator().manual_seed(5), **kw)
    if perturb:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in student.parameters():
                p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, generator=gen).to(p.device))
    batch = make_batch(cfg, 1, max_voxels=256, n_points=3000, n_obj=6, device=dev,
                       with_targets=True, distillation=True)
    opt = OneCycleAdam(student.parameters(), cfg["optimizer"], cfg["lr_config"], 10,
                       cfg["optimizer_config"]["grad_clip"])
    step = TS_Trainer(teacher, student, opt, cfg["model"]).step(batch)
    return ({k: float(v) for k, v in step.items()},
            {n: p.grad.cpu() for n, p in student.named_parameters() if p.grad is not None})


def _pp_tiny_agreement():
    """One tiny pp teacher-student step on the card against the same step
    on the CPU (float32 both, TF32 off), and each device's own spread on
    ulp-perturbed weights: judged within ``PP_TINY_TOL`` with one point a
    pillar, printed with 8 (see ``PP_TINY_TOL``)."""

    def errs(got, want):
        (gm, gg), (wm, wg) = got, want
        top = max(float(g.abs().max()) for g in wg.values())
        return dict(metrics=max(abs(v - wm[k]) / max(abs(wm[k]), 1e-6) for k, v in gm.items()),
                    gradients=max(float((gg[n] - g).abs().max()) for n, g in wg.items()) / top,
                    worst_module=_module_scaled_diff(gg, wg))

    res = {}
    for points in (1, 8):
        cfg = _pp_tiny_cfg(points)
        cuda, cpu = _pp_tiny_step(cfg, "cuda"), _pp_tiny_step(cfg, "cpu")
        got = errs(cuda, cpu)
        spread = {dev: errs(_pp_tiny_step(cfg, dev, perturb=True), ref)
                  for dev, ref in (("cpu", cpu), ("cuda", cuda))}
        res[f"points_{points}"] = dict(cuda_vs_cpu=got, ulp_spread=spread)
        judged = points == 1
        print(f"[pp] tiny teacher-student step, {points} point(s) a pillar, cuda vs cpu: "
              f"{json.dumps(got)} ({'judged' if judged else 'not judged'}: metrics and "
              f"gradients within {PP_TINY_TOL}); each device on ulp-perturbed weights "
              f"against itself: {json.dumps(spread)}", flush=True)
        if sorted(cuda[1]) != sorted(cpu[1]) or \
                (judged and max(got["metrics"], got["gradients"]) > PP_TINY_TOL):
            raise AssertionError(f"tiny pp step disagrees with its CPU run: {got} > "
                                 f"{PP_TINY_TOL}")
    return res


def phase_pp():
    """The pillar recipe on the card at full width (468x468, PFN [64, 64],
    RPN [3, 5, 5] x [64, 128, 256]): the frame's pillars kept and dropped at
    the train and test budgets; the teacher's (PointPillars) and the
    student's (KD_PointPillars) inference frames; the "pp" teacher-student
    step at batch 1 and 3 (``_pp_steps``); the tiny pair on the card against
    the CPU (``_pp_tiny_agreement``); and the CLI chain
    (``phase_cli("pp")``). No sparse-engine kernel (B1, B2, B3) may launch
    on any of these paths: each count is set to 0 just before and read just
    after."""
    import math

    import torch

    from sparse2dense_tpu_torch.models.builder import pillar_grid_from_reader_cfg
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import PP, ConfigDict, frame_voxels

    t0 = time.perf_counter()
    cfg = ConfigDict.fromfile(PP)
    grid = math.prod(pillar_grid_from_reader_cfg(cfg["S_model"]["reader"]))
    every = make_batch(cfg, 1, max_voxels=grid, device="cpu", **PP_FRAME)
    n_pillars = int((every["num_points"] > 0).sum())
    del every
    budgets = {str(b): dict(kept=min(n_pillars, b), dropped=max(n_pillars - b, 0))
               for b in cfg["voxel_generator"]["max_voxel_num"]}
    print(f"[pp] the frame's pillars: {n_pillars} occupied of {grid} cells; by budget "
          f"{json.dumps(budgets)}", flush=True)
    batch = make_batch(cfg, 1, max_voxels=frame_voxels(cfg, train=False), device="cuda",
                       **PP_FRAME)
    frames = {role: _pp_frames(cfg, key, batch)
              for role, key in (("teacher", "model"), ("student", "S_model"))}
    print("[pp] frames " + json.dumps(frames), flush=True)
    del batch
    torch.cuda.empty_cache()
    steps = {b: _pp_steps(b) for b in PP_BATCHES}
    with no_tf32():
        tiny = _pp_tiny_agreement()
    cli = phase_cli("pp")
    return dict(pillars=n_pillars, budgets=budgets, frames=frames, steps=steps, tiny=tiny,
                cli=cli, seconds=time.perf_counter() - t0)


# phase 10: teacher-student steps a run at batch 1 (the recipe's batch 3:
# BIG_WARMUP, BIG_STEPS); the weights each engine's step must reach (its
# windowed or plane convs); the train-mode BEV against the shipped engine's:
# the window engine at dense_from_stage 1 stores the conv2 stage's
# activations in bf16 on the dense grid, the others in float32 rows or bf16
# plane state, so each of the nine convs from conv2 on sees up to one more
# bf16 rounding (2^-8 relative) of its input on one side (as SECOND_BEV_TOL)
ENGINE_WARMUP, ENGINE_STEPS = 1, 2
_TILE_WEIGHTS = ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                 "backbone.conv2_down.conv_weight", "backbone.conv2_1.conv2_weight")
_DFS2_WEIGHTS = ("backbone.conv2_down.conv_weight", "backbone.conv2_0.conv1_weight",
                 "backbone.conv2_1.conv2_weight", "backbone.conv3_down.conv_weight")
_DFS3_WEIGHTS = _DFS2_WEIGHTS + ("backbone.conv3_0.conv1_weight", "backbone.conv3_1.conv2_weight",
                                 "backbone.conv4_down.conv_weight")
ENGINE_WEIGHTS = {
    "window_dfs2": _DFS2_WEIGHTS,
    "window_dfs3": _DFS3_WEIGHTS,
    "window_dfs99": _DFS3_WEIGHTS + ("backbone.conv4_0.conv1_weight",
                                     "backbone.conv4_1.conv2_weight",
                                     "backbone.extra_conv.conv_weight"),
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
ENGINE_LAUNCHES = {"window_dfs2": (3 * 11, 0, 0), "window_dfs3": (3 * 16, 0, 0),
                   "window_dfs99": (3 * 21, 0, 0), "plane": (3 * 6, 3 * 12, 0),
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
        rows = {}
        with _stage_rows(model.backbone, rows), torch.no_grad():
            feats = model.reader(batch["voxels"], batch["num_points"])
            bev, _, t = model.backbone(feats, batch["coordinates"])
        bevs[tag] = bev.float()
        tele[tag] = dict({k: [int(v[0].max()), v[1]] for k, v in t.items()}, **rows)
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
            ("window_dfs3", PT.engine_settings("window", 3), None, (1,)),
            ("window_dfs99", PT.engine_settings("window", 99), None, (1,)),
            ("plane", PT.engine_settings("plane"), plane_frame, (1, BIG_BATCH)),
            ("tile", PT.engine_settings("tile"), tile_frame, (1, BIG_BATCH)),
            ("tile_dfs99", PT.engine_settings("tile", 99), None, (1,))):
        if tag.startswith("window_dfs"):
            frame = phase_main_path("window", overrides=settings, tag=tag)
        batch = make_batch(flagship(), 1, max_voxels=150000, n_points=170000, n_obj=32,
                           device="cuda")
        r = dict(settings=settings, frame=frame, agreement=_engine_agreement(batch, settings))
        print(f"[engines] {tag} student in train mode against the shipped engine: "
              + json.dumps(r["agreement"]), flush=True)
        if tag.startswith(("tile", "window_dfs")) and not r["agreement"]["exact"]:
            raise AssertionError(f"{tag}: a counter is over its budget: {r['agreement']}")
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


# the data phase: frames written as records (the bench's scene, seeds 0..5
# for training, 10..14 for validation), the recipe's interval of 5 over the
# training infos, its batch of 3: 2 teacher-student steps
DATA_TRAIN_SCENES, DATA_VAL_FRAMES, DATA_INTERVAL, DATA_STEPS = 6, 5, 5, 2
DATA_APPEND = """
data["train"].update(root_path={root!r}, info_path={train!r}, ann_file={train!r})
data["val"].update(root_path={root!r}, info_path={val!r}, ann_file={val!r})
"""
# Two training steps move the weights while the eval-mode BatchNorm's running
# statistics (momentum 0.01) stay near their init, so the 2-step student's
# eval-mode maps explode (heights of 1e5 m, heatmap logits of -4e5 on the
# H100) and no candidate passes the range check. An untrained student at
# score threshold 0 sends its candidates through the NMS and the matching.
EVAL_APPEND = """
test_cfg.update(score_threshold=0.0)
"""


def _write_records(root):
    """Waymo-layout records of the bench's scene (170k points, 32 objects on
    the 41x1504x1504 grid): ``lidar/<frame>.pkl`` (``lidars.points_xyz``,
    ``points_feature``), ``infos_{train,val}.pkl`` (token, path, gt_boxes,
    gt_names, gt_signs) and a dense object set ``{train,val}/gt/<obj>.pkl``
    (key "gt": 2,000 points in the object's canonical frame) for each
    object. The training infos repeat the scenes to fill the recipe's
    interval: info ``i`` reads scene ``i // DATA_INTERVAL``."""
    import pickle

    import numpy as np

    from sparse2dense_tpu_torch.training.synthetic import make_gt, make_points

    pc_range = np.asarray([-75.2, -75.2, -2, 75.2, 75.2, 4], np.float32)
    os.makedirs(os.path.join(root, "lidar"))

    def scene(seed, split):
        rng = np.random.RandomState(seed)
        boxes, _, names = make_gt(rng, 32, pc_range)
        pts = make_points(rng, 170000, pc_range, boxes, 5)
        path = os.path.join(root, "lidar", f"{split}_{seed}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"lidars": {"points_xyz": pts[:, :3], "points_feature": pts[:, 3:]}}, f)
        gt_dir = os.path.join(root, split, "gt")
        os.makedirs(gt_dir, exist_ok=True)
        signs = [f"{split}_{seed}_{j}" for j in range(len(boxes))]
        for sign, box in zip(signs, boxes):
            half = np.array([box[4], box[3], box[5]], np.float32) / 2   # l, w, h: canonical x, y, z
            dense = np.concatenate([rng.uniform(-half, half, (2000, 3)),
                                    rng.uniform(0, 1, (2000, 2))], 1).astype(np.float32)
            with open(os.path.join(gt_dir, f"{sign}.pkl"), "wb") as f:
                pickle.dump({"gt": dense}, f)
        return dict(path=path, gt_boxes=boxes, gt_names=names, gt_signs=signs)

    train = [scene(s, "train") for s in range(DATA_TRAIN_SCENES)]
    val = [scene(10 + s, "val") for s in range(DATA_VAL_FRAMES)]
    paths = {}
    for split, infos in (("train", [dict(train[i // DATA_INTERVAL], token=f"train_{i}")
                                    for i in range(DATA_TRAIN_SCENES * DATA_INTERVAL)]),
                         ("val", [dict(v, token=f"val_{i}") for i, v in enumerate(val)])):
        paths[split] = os.path.join(root, f"infos_{split}.pkl")
        with open(paths[split], "wb") as f:
            pickle.dump(infos, f)
    return paths


def _host_ms(dataset, n):
    """ms a sample of the dataset's pipeline in this process (first ``n``)."""
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i]
    return 1000 * (time.perf_counter() - t0) / n


STREAMS = ("voxels", "dense_voxels", "reconstruction_voxels", "reconstruction_voxels_2",
           "reconstruction_voxels_4")


def _data_host(cfg):
    """The host side of the data phase (no card needed): the pipeline's ms
    a sample in this process (train, val), a training example's 5 voxel
    streams and targets, the native voxelizer against its NumPy version on
    the example's points at the train budget (bit for bit, ms of each)."""
    import numpy as np

    from sparse2dense_tpu_torch.data.loader import build_dataset
    from sparse2dense_tpu_torch.ops import voxelize as V

    res = {}
    train_ds, val_ds = build_dataset(cfg.data["train"]), build_dataset(cfg.data["val"])
    if len(train_ds) != DATA_STEPS * cfg.data["samples_per_gpu"]:
        raise AssertionError(f"data: {len(train_ds)} training frames after the interval")
    res["host_ms_train"] = _host_ms(train_ds, 3)
    res["host_ms_val"] = _host_ms(val_ds, 3)
    ex = train_ds[0]
    streams = [k for k in ex if k in STREAMS]
    if len(streams) != len(STREAMS) or "hm" not in ex:
        raise AssertionError(f"data: a training example holds {sorted(ex)}")
    # one stream, native against NumPy: the frame's points at the train budget
    pts = ex["points"]
    vg = cfg.voxel_generator
    budget = vg["max_voxel_num"]
    args = (pts, vg["voxel_size"], vg["range"], vg["max_points_in_voxel"],
            budget[0] if isinstance(budget, (list, tuple)) else budget)
    outs = {}
    for name, fn in (("native", V.points_to_voxel_native), ("numpy", V.points_to_voxel)):
        fn(*args)
        t = time.perf_counter()
        outs[name] = [fn(*args) for _ in range(3)][-1]
        res[f"voxelize_ms_{name}"] = 1000 * (time.perf_counter() - t) / 3
    for a, b in zip(outs["native"], outs["numpy"]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("data: the native voxelizer differs from its NumPy version")
    res["voxelize_points"], res["voxelize_voxels"] = len(pts), len(outs["native"][0])
    return res


def phase_data(smi, tmp):
    """The flagship recipe from records: ``_write_records`` under ``tmp``
    (a temporary directory that phase "dp" reads too), the recipe's text
    with its data paths pointed at them; the host pipeline's ms a sample (train: 5 voxel streams and the
    targets; val), the native voxelizer against its NumPy version on one
    frame (bit for bit, and their ms); ``tools/train.py`` on it (1 epoch of
    ``DATA_STEPS`` teacher-student steps at the recipe's batch of 3, its 4
    input workers): finite losses, ``grad_norm`` > 0, a checkpoint, 54
    window passes a step; then ``tools/test.py --checkpoint <it>
    --speed_test`` on the val split: the detections' file, the evaluation's
    mAP dict, 6 window passes a frame; an untrained student at score
    threshold 0 (``EVAL_APPEND``): more than 0 detections, a finite mAP, 6
    window passes a frame; the val boxes themselves, scored as detections,
    evaluate to a mAP of 1. Launch counts set to 0 just before
    each run and read just after. Returns the results, and for phase "dp"
    the configs' paths and the untrained student's detections."""
    import gc

    import numpy as np
    import torch

    from sparse2dense_tpu_torch.data.loader import build_dataset
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import test as test_cli
    from sparse2dense_tpu_torch.tools import train as train_cli
    from sparse2dense_tpu_torch.utils.config import FLAGSHIP, ConfigDict

    t0, res = time.perf_counter(), {}
    paths = _write_records(tmp)
    cfg_path = os.path.join(tmp, "flagship_records.py")
    with open(FLAGSHIP) as f, open(cfg_path, "w") as out:
        out.write(f.read() + DATA_APPEND.format(root=tmp, **paths))
    eval_path = os.path.join(tmp, "flagship_records_eval.py")
    with open(cfg_path) as f, open(eval_path, "w") as out:
        out.write(f.read() + EVAL_APPEND)
    cfg = ConfigDict.fromfile(cfg_path)
    res["records_s"] = time.perf_counter() - t0
    res.update(_data_host(cfg))

    work, evald = os.path.join(tmp, "work"), os.path.join(tmp, "eval")
    WK.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer = train_cli.main([cfg_path, "--work_dir", work, "--epochs", "1"])
    res["train_launches"] = WK.launches
    res["train_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trainer.log_buffer.val_history
    _check_metrics("data train", {k: v for k, v in history.items()
                                  if k not in ("time", "data_time")})
    if trainer.global_iter != DATA_STEPS or not os.path.exists(
            os.path.join(work, "epoch_1")):
        raise AssertionError(f"data: {trainer.global_iter} steps, {os.listdir(work)}")
    want = TRAIN_LAUNCHES * cfg.data["samples_per_gpu"] * DATA_STEPS
    if res["train_launches"] != want:
        raise AssertionError(f"data: {res['train_launches']} window passes in training, "
                             f"expected {want}")
    res["step_s"], res["data_wait_s"] = history["time"], history["data_time"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    WK.launches = 0
    detections, (result, _), times = test_cli.main(
        [cfg_path, "--checkpoint", os.path.join(work, "latest"), "--work_dir", evald,
         "--speed_test"])
    res["val_launches"] = WK.launches
    if res["val_launches"] != EXPECTED_LAUNCHES["window"][0] * DATA_VAL_FRAMES:
        raise AssertionError(f"data: {res['val_launches']} window passes over "
                             f"{DATA_VAL_FRAMES} val frames")
    if sorted(detections) != [f"val_{i}" for i in range(DATA_VAL_FRAMES)] or \
            not os.path.exists(os.path.join(evald, "detection_pred.pkl")) or \
            not isinstance(result, dict) or "local_bev_mAP" not in result:
        raise AssertionError(f"data: evaluation {result}, detections {sorted(detections)}")
    res["test_ms_frame"] = [1000 * t for t in times]
    res["detections"] = sum(len(d["scores"]) for d in detections.values())
    res["local_bev_mAP"] = result["local_bev_mAP"]

    WK.launches = 0
    detections, (result, _), times = test_cli.main(
        [eval_path, "--work_dir", os.path.join(tmp, "eval_untrained"), "--speed_test"])
    untrained = detections
    res["untrained_val_launches"] = WK.launches
    res["untrained_test_ms_frame"] = [1000 * t for t in times]
    res["untrained_detections"] = sum(len(d["scores"]) for d in detections.values())
    res["untrained_bev_mAP"] = result["local_bev_mAP"]
    if res["untrained_val_launches"] != res["val_launches"] or \
            res["untrained_detections"] == 0 or not math.isfinite(res["untrained_bev_mAP"]):
        raise AssertionError(
            f"data: the untrained student at score threshold 0: "
            f"{res['untrained_detections']} detections, local BEV mAP "
            f"{res['untrained_bev_mAP']}, {res['untrained_val_launches']} window passes")
    # the evaluator's matching: the val frames' own boxes, scored 1, score 1
    val_set = build_dataset(cfg.data["val"])
    names = list(val_set._class_names)
    truth = {}
    for info in val_set.infos:
        keep = [i for i, n in enumerate(info["gt_names"]) if n in names]
        truth[info["token"]] = {
            "box3d_lidar": np.asarray(info["gt_boxes"])[keep],
            "scores": np.ones(len(keep), np.float32),
            "label_preds": np.asarray([names.index(info["gt_names"][i]) for i in keep])}
    os.makedirs(os.path.join(tmp, "truth"))
    ideal, _ = val_set.evaluation(truth, output_dir=os.path.join(tmp, "truth"))
    res["truth_bev_mAP"] = ideal["local_bev_mAP"]
    if abs(res["truth_bev_mAP"] - 1.0) > 1e-6:
        raise AssertionError(f"data: the val boxes scored as detections give a local BEV "
                             f"mAP of {res['truth_bev_mAP']}, not 1")
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[data] host pipeline a sample (main process): train {res['host_ms_train']:.1f} ms "
          f"(5 voxel streams + targets), val {res['host_ms_val']:.1f} ms; voxelizer on one "
          f"stream ({res['voxelize_points']} points -> {res['voxelize_voxels']} voxels): native "
          f"{res['voxelize_ms_native']:.2f} ms, NumPy {res['voxelize_ms_numpy']:.2f} ms, bit-equal"
          f" | {smi}", flush=True)
    steps, waits = (", ".join(f"{1000 * t:.1f}" for t in res[k]) for k in ("step_s", "data_wait_s"))
    print(f"[data] tools/train.py from records, batch {cfg.data['samples_per_gpu']}, "
          f"{cfg.data['workers_per_gpu']} workers: steps {steps} ms, loader wait {waits} ms; "
          f"peak {res['train_peak_gb']:.2f} GiB; B1 {res['train_launches']} | {smi}", flush=True)
    print(f"[data] tools/test.py: {', '.join(f'{t:.1f}' for t in res['test_ms_frame'])} ms a "
          f"frame (after 2), {res['detections']} detections, local BEV mAP "
          f"{res['local_bev_mAP']}; untrained at score threshold 0: "
          f"{', '.join(f'{t:.1f}' for t in res['untrained_test_ms_frame'])} ms a frame, "
          f"{res['untrained_detections']} detections, local BEV mAP "
          f"{res['untrained_bev_mAP']}, B1 {res['untrained_val_launches']}; the val boxes "
          f"as detections: {res['truth_bev_mAP']}; B1 {res['val_launches']}; phase {res['seconds']:.1f} s "
          f"(records {res['records_s']:.1f} s) | {smi}", flush=True)
    print("[data] " + json.dumps(res), flush=True)
    return res, dict(cfg_path=cfg_path, eval_path=eval_path, untrained=untrained,
                     records=dict(root=tmp, **paths))


# phase "dp": the flagship teacher-student step at two ranks of one sample on
# the one card (gloo) against this process at batch 2 on the same samples, in
# four precisions: float32 (dense stages in float32, TF32 off), bf16 (the
# shipped bf16 dense stages, TF32 off), tf32 (dense stages in float32, TF32 in
# cuDNN, as shipped) and as shipped (both). The batch of 2 and the batch of 1
# round differently where the sums are in reduced precision (cuDNN's
# algorithms by batch size, the order of the sums); the shipped one process
# is bit-equal to itself, so its gap is that rounding, the same in every run:
# step 0 read 7.52e-3 (metrics, relative) and 0.772 (gradients, of their
# module's largest) in five runs; bf16 alone 1.72e-2 / 0.695, TF32 alone
# 5.77e-3 / 0.313, float32 1.51e-4 / 2.80e-2 (2.80e-2-3.35e-2 in seven
# runs), where the float32 one process
# against itself (CUDA's atomic sums) reads up to 7.6e-4 / 0.269 (PERF.md
# §6). DP_TOL and DP_F32_TOL bound the first step from those readings;
# later steps are printed (Adam's first steps move by their learning rate
# either way a parameter whose gradient is a rounding residue).
DP_STEPS = 2
DP_TOL = {"metrics": 1e-2, "grads": 1.0}
DP_F32_TOL = {"metrics": 1e-3, "grads": 1e-1}
F32 = dict(dense_compute_dtype=None)
DP_CASES = (   # (tag, steps, job fields, tolerance of the first step)
    ("float32", 1, dict(backbone=F32, tf32=False), DP_F32_TOL),
    ("bf16", 1, dict(tf32=False), None),
    ("tf32", 1, dict(backbone=F32), None),
    ("shipped", DP_STEPS, {}, DP_TOL),
)
DP_DET_TOL = 1e-3   # merged detections against one process (boxes, scores)


def _scaled_grad_gaps(got, want):
    """max |got - want| / the module's largest |want|, over each module."""
    scale, gap = {}, {}
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(g.abs().max()))
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        gap[module] = max(gap.get(module, 0.0),
                          float((got[name] - g).abs().max()) / max(scale[module], 1e-30))
    return gap


def _metric_gaps(got, want):
    return {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}


def _dp_steps(tmp, job, tol, again=False):
    """The job's steps at two spawned ranks (``steps_worker``), then in this
    process on the joined batch (``one_process_steps``): the ranks' state
    and metrics equal after every step, their parameter gaps 0, the same
    window passes in each; the first step's metrics and gradients against
    the one process within ``tol`` (None: the gaps are
    read, not held). Returns the times, peaks, launches and gaps (printed
    before any check fails). With ``again`` the one process runs twice: its
    gap to itself (CUDA's atomic sums differ from run to run)."""
    import gc

    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.parallel.launch import one_process_steps, spawn, steps_worker

    path, res = os.path.join(tmp, "job.pt"), {}
    torch.save(job, path)
    gc.collect()
    torch.cuda.empty_cache()   # the ranks share the card with this process
    t0 = time.perf_counter()
    spawn(steps_worker, 2, ([path], tmp), timeout=600)
    res["ranks_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"steps_rank{r}_0.pt"), weights_only=False)
             for r in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    WK.launches = 0
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        one = one_process_steps(job, "cuda")["rows"]
        if again:
            twice = one_process_steps(job, "cuda")["rows"]
            res["self_metric_gaps"] = [max(_metric_gaps(b["metrics"], a["metrics"]).values())
                                       for a, b in zip(one, twice)]
            res["self_grad_gaps"] = [max(_scaled_grad_gaps(b["grads"], a["grads"]).values())
                                     for a, b in zip(one, twice)]
            del twice
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    res["one_launches"] = WK.launches
    for r, rank in enumerate(ranks):
        rows = rank["rows"]
        res[f"rank{r}_step_ms"] = [row["step_ms"] for row in rows]
        res[f"rank{r}_allreduce_ms"] = [row["stages"]["allreduce"] for row in rows]
        res[f"rank{r}_peak_gb"] = max(row["peak_gb"] for row in rows)
        res[f"rank{r}_launches"] = sum(row["window_pass_launches"] for row in rows)
        res[f"rank{r}_param_gaps"] = rank["param_gaps"]
    res["one_step_ms"] = [row["step_ms"] for row in one]
    res["one_peak_gb"] = max(row["peak_gb"] for row in one)
    res["metric_gaps"], res["grad_gaps"], res["worst"], res["ranks_equal"] = [], [], [], []
    for step in range(job["steps"]):
        r0, r1 = (rank["rows"][step] for rank in ranks)
        res["ranks_equal"].append(r0["metrics"] == r1["metrics"] and all(
            torch.equal(r0["model"][k], r1["model"][k]) for k in r0["model"]))
        mg = _metric_gaps(r0["metrics"], one[step]["metrics"])
        gg = _scaled_grad_gaps(r0["grads"], one[step]["grads"])
        res["metric_gaps"].append(max(mg.values()))
        res["grad_gaps"].append(max(gg.values()))
        res["worst"].append([max(mg, key=mg.get)] + sorted(gg, key=gg.get)[-3:])
    print(f"[dp] {json.dumps({k: v for k, v in res.items()})}", flush=True)
    if not all(res["ranks_equal"]):
        raise AssertionError(f"dp: the ranks differ after a step: {res['ranks_equal']}")
    if tol is not None and (res["metric_gaps"][0] > tol["metrics"] or
                            res["grad_gaps"][0] > tol["grads"]):
        raise AssertionError(f"dp: the first step against one process: metrics "
                             f"{res['worst'][0][0]} {res['metric_gaps'][0]:.3e}, gradients "
                             f"{res['worst'][0][1:]} {res['grad_gaps'][0]:.3e} (tolerance {tol})")
    _check_metrics("dp gloo", {k: [r["metrics"][k] for r in ranks[0]["rows"]]
                               for k in ranks[0]["rows"][0]["metrics"]})
    if any(g != 0.0 for r in range(2) for g in res[f"rank{r}_param_gaps"]) or \
            res["rank0_launches"] != res["rank1_launches"] or \
            res["rank0_launches"] != TRAIN_LAUNCHES * job["steps"]:
        raise AssertionError(f"dp: parameter gaps {res['rank0_param_gaps']}, "
                             f"{res['rank1_param_gaps']}; window passes "
                             f"{res['rank0_launches']}, {res['rank1_launches']}")
    return res


def phase_dp(smi, data):
    """Data parallelism on the one card (NCCL refuses two ranks on one
    device, so world size 1 runs NCCL and world size 2 gloo, which stages
    the CUDA tensors of its all-reduces and broadcasts through the host):
    (a) ``tools/train.py --launcher pytorch`` at world size 1 through NCCL
    (torchrun's variables set in this process) on phase 12's records at the
    recipe's batch of 3: ``DATA_STEPS`` steps, finite losses, a checkpoint,
    54 window passes a step; (b) the flagship teacher-student step at two
    spawned ranks of one sample (``parallel.launch.steps_worker``, gloo on
    ``cuda:0``), then this process at batch 2 on the same two samples
    (``one_process_steps``; ``_dp_steps``), in the precisions of
    ``DP_CASES`` (float32, the bf16 dense stages alone and TF32 alone for one
    step, as shipped for ``DP_STEPS`` steps; the first step's metrics and
    gradients within ``DP_F32_TOL`` in float32 and ``DP_TOL`` as shipped,
    later steps printed): the ranks' parameters
    equal to the bit after every step; each rank's and the
    one process's step ms, the gradient all-reduce's ms a step, the ranks'
    peak GiB and window passes (18 a step each); (c) ``tools/test.py --launcher
    pytorch`` at world size 2 (gloo, ``cuda:0``) on the val records with
    the untrained student at score threshold 0: rank 0's merged detections
    (5 frames, the wrapped shards' duplicate dropped) against phase 12's one
    process within ``DP_DET_TOL``, rank 1 None, 18 window passes a rank."""
    import gc
    import pickle

    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.parallel import dist
    from sparse2dense_tpu_torch.parallel.launch import cli_worker, spawn
    from sparse2dense_tpu_torch.tools import train as train_cli
    from sparse2dense_tpu_torch.tools.profile_train_step import FRAME
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import FLAGSHIP, ConfigDict, frame_voxels

    t0, res = time.perf_counter(), {}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) world size 1 through NCCL, as torchrun starts a rank
        env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(dist.free_port()))
        os.environ.update(env)
        work = os.path.join(tmp, "nccl")
        try:
            WK.launches = 0
            trainer = train_cli.main([data["cfg_path"], "--work_dir", work, "--epochs", "1",
                                      "--launcher", "pytorch"])
            res["nccl_launches"] = WK.launches
            res["nccl_backend"] = torch.distributed.get_backend()
            res["nccl_world"] = dist.world_size()
            probe = torch.ones(1, device="cuda")   # one NCCL collective on the card
            torch.distributed.all_reduce(probe)
            res["nccl_all_reduce"] = float(probe)
        finally:
            dist.close_distributed()
            for key in env:
                os.environ.pop(key)
        history = trainer.log_buffer.val_history
        _check_metrics("dp nccl", {k: v for k, v in history.items()
                                   if k not in ("time", "data_time")})
        res["nccl_step_s"] = history["time"]
        want = TRAIN_LAUNCHES * 3 * DATA_STEPS
        if (res["nccl_backend"], res["nccl_world"], res["nccl_all_reduce"]) != ("nccl", 1, 1.0) or \
                trainer.global_iter != DATA_STEPS or res["nccl_launches"] != want or \
                not os.path.exists(os.path.join(work, "epoch_1")):
            raise AssertionError(f"dp nccl: {res['nccl_backend']} world {res['nccl_world']}, "
                                 f"{trainer.global_iter} steps, {res['nccl_launches']} window "
                                 f"passes (expected {want}), {os.listdir(work)}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (b) two ranks of one sample on the one card (gloo), then this
        # process at batch 2 on the same samples: as shipped, then in float32
        cfg = ConfigDict.fromfile(FLAGSHIP)
        batch = make_batch(cfg, 2, max_voxels=frame_voxels(cfg, train=True), device="cpu",
                           with_targets=True, distillation=True, **FRAME)
        for tag, steps, extra, tol in DP_CASES:
            res[tag] = _dp_steps(tmp, dict(config=FLAGSHIP, kind="ts", per_rank=1, steps=steps,
                                           device="cuda:0", batch=batch, **extra), tol,
                                 again=tol is not None)
        del batch
        gc.collect()
        torch.cuda.empty_cache()

        # (c) tools/test.py at world size 2 (gloo) on the val records
        evald = os.path.join(tmp, "eval")
        spawn(cli_worker, 2, ("test", [data["eval_path"], "--work_dir", evald, "--device",
                                       "cuda:0", "--launcher", "pytorch"], tmp),
              timeout=600)
        test = []
        for r in range(2):
            with open(os.path.join(tmp, f"test_rank{r}.pkl"), "rb") as f:
                test.append(pickle.load(f))
        res["test_launches"] = [t["window_pass_launches"] for t in test]
        want, got = data["untrained"], test[0]["detections"]
        if test[1]["detections"] is not None or got is None or sorted(got) != sorted(want):
            raise AssertionError(f"dp test: rank 0 {None if got is None else sorted(got)}, "
                                 f"rank 1 {test[1]['detections'] is None}")
        gap = 0.0
        for token, det in want.items():
            if len(det["scores"]) != len(got[token]["scores"]) or \
                    (det["label_preds"] != got[token]["label_preds"]).any():
                raise AssertionError(f"dp test: {token}: {len(got[token]['scores'])} "
                                     f"detections, one process {len(det['scores'])}")
            for k in ("box3d_lidar", "scores"):
                gap = max(gap, float(abs(got[token][k] - det[k]).max(initial=0.0)))
        res["detection_gap"] = gap
        if gap > DP_DET_TOL or res["test_launches"] != [
                EXPECTED_LAUNCHES["window"][0] * 3] * 2:
            raise AssertionError(f"dp test: detections {gap:.3e} from one process, window "
                                 f"passes {res['test_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[dp] world size 1 through NCCL: tools/train.py --launcher pytorch at batch 3, steps "
          f"{', '.join(f'{1000 * t:.1f}' for t in res['nccl_step_s'])} ms, B1 "
          f"{res['nccl_launches']} | {smi}", flush=True)
    for tag, *_ in DP_CASES:
        r = res[tag]
        ms = {k: ", ".join(f"{t:.1f}" for t in v) for k, v in r.items() if k.endswith("_ms")}
        print(f"[dp] two ranks on one card through gloo, flagship teacher-student step ({tag}) "
              f"at batch 1 a rank: step ms rank 0 {ms['rank0_step_ms']}, rank 1 "
              f"{ms['rank1_step_ms']}; one process at batch 2 {ms['one_step_ms']}; gradient "
              f"all-reduce {ms['rank0_allreduce_ms']} ms a step; peak GiB "
              f"{r['rank0_peak_gb']:.2f} / {r['rank1_peak_gb']:.2f} (one process "
              f"{r['one_peak_gb']:.2f}); B1 {r['rank0_launches']} / {r['rank1_launches']}; "
              f"parameters equal across ranks after every step; against one process: metrics "
              f"{', '.join(f'{g:.2e}' for g in r['metric_gaps'])}, gradients "
              f"{', '.join(f'{g:.2e}' for g in r['grad_gaps'])} of the module's largest "
              f"(worst {r['worst']}) | {smi}", flush=True)
    print(f"[dp] tools/test.py --launcher pytorch, two ranks (gloo): merged detections within "
          f"{res['detection_gap']:.3e} of one process; B1 {res['test_launches']}; phase "
          f"{res['seconds']:.1f} s | {smi}", flush=True)
    print("[dp] " + json.dumps(res), flush=True)
    return res


# phase 14 "two_stage": the flagship two-stage recipe (the KD_VoxelNet
# student, frozen, under the RoI head) at full width on the bench's frame.
# Inference frames: TS_WARMUP + TS_TIMED, then TS_TIMED more with the stages
# synchronised. Steps (``make_train_step``): TS_STEP_WARMUP + TS_STEPS at
# batch 1 and at the recipe's samples_per_gpu of 6, then as many train-mode
# forwards and losses with their stages synchronised. A random first stage's boxes never meet the
# synthetic objects, so each step's batch also holds, as gt boxes after the
# synthetic objects, TS_GT_FROM_DETECTIONS of the first stage's own boxes a
# sample, moved by TS_GT_SHIFTS (m, in turn): the sampled RoIs then hold
# foreground, hard and easy background and both RoI losses move
TS_WARMUP, TS_TIMED = 3, 5
TS_BATCHES = (1, 6)
TS_STEP_WARMUP, TS_STEPS = 1, 2
TS_GT_FROM_DETECTIONS = 16
TS_GT_SHIFTS = (0.005, 0.1, 0.3, 2.0)
TS_STEP_STAGES = ("forward", "backward", "optimizer")
TS_FORWARD_STAGES = ("first_stage_maps", "first_stage_predict", "bev", "targets", "roi_head",
                     "loss")
# heatmap cells a sample above the score threshold (``_ts_heatmap_bias``)
TS_CANDIDATES = 300
# the tiny two-stage model (configs/tests/two_stage_tiny.py: a pillar first
# stage, no sparse kernel; DP_RATIO 0) on the card against the CPU, float32
# with TF32 off: the RoI head's eval maps and the train-mode loss terms with
# the same draws, relative to the CPU's largest value (summation order only;
# the RoIs, their labels and the sampled rows must be the same)
TS_TINY_TOL = 1e-4
# the converter at full width: the dense teacher's head maps after the det3d
# round trip against the source model's, relative to their largest value
TS_CONVERT_TOL = 1e-4


def _ts_model(cfg, seed=0):
    """The recipe's two-stage model on the card, seeded weights."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector

    return build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                          voxel_generator=cfg["voxel_generator"], device="cuda",
                          generator=torch.Generator().manual_seed(seed))


def _ts_heatmap_bias(model, batch, cfg):
    """Sets the first stage's heatmap output bias so that ``TS_CANDIDATES``
    heatmap cells a sample pass the score threshold (random weights give a
    heatmap of small spread: at the initial bias, -2.19, nearly every cell
    passes and floods the NMS; at the flagship frame's -6 none does, and the
    RoI head gets no RoI). -> (the bias, the first stage's valid RoIs)."""
    import math

    import torch

    from sparse2dense_tpu_torch.models.heads.center_head import SepHead

    heads = [m for m in model.single_det.modules() if isinstance(m, SepHead)]
    with torch.no_grad():
        for h in heads:
            h.hm_out.bias.zero_()
    with torch.inference_mode():
        preds = model.single_det.forward_two_stage(batch)[2]
        logits = torch.cat([p["hm"].flatten(1) for p in preds], 1)
        kth = float(logits.topk(TS_CANDIDATES, 1).values[:, -1].min())
    thr = cfg["test_cfg"]["score_threshold"]
    bias = math.log(thr / (1 - thr)) - kth
    with torch.no_grad():
        for h in heads:
            h.hm_out.bias.fill_(bias)
    with torch.inference_mode():
        valid = int(model.single_det.forward_two_stage(batch)[0]["valid"].sum())
    return bias, valid


class _StageClock:
    """``mark(name)``: the device synchronised, the ms since the last mark
    and the peak GiB since then (the peak counter reset at each mark)."""

    def __init__(self):
        import torch

        self.ms, self.peak = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t = time.perf_counter()

    def __call__(self, name):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = (now - self.t) * 1e3
        self.peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        self.t = now


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _ts_frames(model, batch, tag, want_b1):
    """Inference frames of a two-stage model: medians of whole frames and of
    its stages (first stage, BEV, RoI head, predict), B1 launches a frame,
    finite boxes and scores in [0, 1]."""
    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK

    times, split, per_frame, peak = [], [], [], 0.0
    _zero_sparse_launches()
    for i in range(TS_WARMUP + 2 * TS_TIMED):
        before = WK.launches
        staged = i >= TS_WARMUP + TS_TIMED
        clock = _StageClock()
        with torch.inference_mode():
            out = model(batch, mark=clock if staged else None)
            det = model.predict(out)
        clock("predict")
        peak = max(peak, *clock.peak.values())
        per_frame.append(WK.launches - before)
        if staged:
            split.append(clock.ms)
        elif i >= TS_WARMUP:
            times.append(sum(clock.ms.values()))
    launches = _sparse_launches()
    if per_frame != [want_b1] * len(per_frame) or launches[1:] != (0, 0):
        raise AssertionError(f"{tag}: (B1, B2, B3) launches {launches}, B1 a frame "
                             f"{per_frame}, expected {want_b1}")
    valid, scores = det["valid"], det["scores"]
    if not bool(torch.isfinite(det["box3d_lidar"][valid]).all()) or \
            not bool(((scores >= 0) & (scores <= 1)).all()) or not bool(valid.any()):
        raise AssertionError(f"{tag}: boxes or scores out of range, {int(valid.sum())} valid")
    return dict(frame_ms_median=_median(times), frame_ms=times,
                stages_ms={k: _median([s[k] for s in split]) for k in split[0]},
                launches=launches[0], detections=int(valid.sum()),
                rois=tuple(out["batch"]["roi_features"].shape), peak_mem_gb=peak)


def _gt_from_first_stage(model, batch, n=TS_GT_FROM_DETECTIONS):
    """``batch`` with ``n`` of the frozen first stage's own boxes a sample,
    moved by TS_GT_SHIFTS in turn along (0.6, 0.8), as gt boxes after the
    synthetic objects (x, y, z, w, l, h, yaw and the 1-based class)."""
    import torch

    with torch.inference_mode():
        boxes = model.single_det.forward_two_stage(batch)[0]
    gt = batch["gt_boxes_and_cls"].clone()
    shifts = torch.tensor(TS_GT_SHIFTS, device=gt.device)
    for b in range(gt.shape[0]):
        rows = torch.nonzero(boxes["valid"][b])[:n, 0]
        moved = boxes["box3d_lidar"][b, rows].clone()
        step = shifts[torch.arange(len(rows), device=gt.device) % len(shifts)][:, None]
        moved[:, :2] += step * torch.tensor([0.6, 0.8], device=gt.device)
        filled = int((gt[b, :, 3:6] > 0).any(-1).sum())
        gt[b, filled:filled + len(rows), :7] = moved
        gt[b, filled:filled + len(rows), -1] = boxes["label_preds"][b, rows].float() + 1
    return dict(batch, gt_boxes_and_cls=gt)


def _ts_iou_ms(model, batch):
    """``boxes_iou3d`` of the first stage's (B, 500) boxes against the
    batch's (B, 500) gt slots, one batched call: the host's ms of a call
    ending in a synchronise; the span of CUDA events over calls back to back
    behind a sleep kernel (``cuda_ms``: once the launch queue is full, the
    host's issue shows in it); and, from one call under ``torch.profiler``,
    the device operations it runs (kernels, copies, fills) and the sum of
    their device times (None when the profiler sees no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparse2dense_tpu_torch.ops.iou3d import boxes_iou3d

    with torch.inference_mode():
        rois = model.single_det.forward_two_stage(batch)[0]["box3d_lidar"]
    gts = batch["gt_boxes_and_cls"][..., :7]
    span_ms = cuda_ms(lambda: boxes_iou3d(rois, gts), reps=5)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        boxes_iou3d(rois, gts)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        boxes_iou3d(rois, gts)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(pairs=rois.shape[0] * rois.shape[1] * gts.shape[1], host_ms=_median(host),
                span_ms=span_ms, device_ops=len(ops) or None,
                device_busy_ms=sum(e.time_range.elapsed_us() for e in ops) / 1e3 if ops
                else None)


def _ts_steps(cfg, model, batch_size):
    """Model-level steps of the two-stage recipe at ``batch_size`` through
    the port's training entry point (``make_train_step``, ``OneCycleAdam``
    over the parameters that need a gradient): medians of the step's stages
    (forward with the loss, backward, optimizer) and peaks; then as many
    train-mode forwards and losses with a stage timer, for the forward's
    split (the first stage's maps and its predict, BEV, targets, RoI head,
    loss). Every
    metric finite, both RoI losses nonzero, a nonzero gradient on every RoI
    head parameter, none on the first stage, whose parameters and
    statistics do not move; 6 B1 launches a sample a step and a forward."""
    import gc

    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
    from sparse2dense_tpu_torch.tools.profile_train_step import FRAME
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.training.train_state import make_train_step
    from sparse2dense_tpu_torch.utils.config import frame_voxels

    batch = make_batch(cfg, batch_size, max_voxels=frame_voxels(cfg, train=True), device="cuda",
                       with_targets=True, **FRAME)
    batch = _gt_from_first_stage(model, batch)
    iou = _ts_iou_ms(model, batch)
    first = {k: v.clone() for k, v in model.single_det.state_dict().items()}
    opt = OneCycleAdam([p for p in model.parameters() if p.requires_grad], cfg["optimizer"],
                       cfg["lr_config"], 10, cfg["optimizer_config"]["grad_clip"])
    train_step = make_train_step(model, opt)
    rows, split = [], []
    for _ in range(TS_STEP_WARMUP + TS_STEPS):
        WK.launches = 0
        clock = _StageClock()
        metrics = train_step(batch, mark=clock)
        rows.append(dict(step_ms=sum(clock.ms.values()), stages=dict(clock.ms),
                         peaks=dict(clock.peak), launches=WK.launches,
                         metrics={k: float(v) for k, v in metrics.items()}))
    tag = f"two_stage batch {batch_size}"
    _check_metrics(tag, rows[-1]["metrics"])
    if not all(r["metrics"][k] > 0 for r in rows for k in ("rcnn_loss_cls", "rcnn_loss_reg")):
        raise AssertionError(f"{tag}: an RoI loss is 0: {[r['metrics'] for r in rows]}")
    for name, p in model.named_parameters():
        g = p.grad
        if name.startswith("single_det.") and g is not None:
            raise AssertionError(f"{tag}: the frozen {name} got a gradient")
        if name.startswith("roi_head.") and (g is None or not bool(g.abs().max() > 0)):
            raise AssertionError(f"{tag}: {name} got no gradient")
    for _ in range(TS_STEP_WARMUP + TS_STEPS):
        WK.launches = 0
        clock = _StageClock()
        out = model(batch, mark=clock)
        model.loss(out, batch)
        clock("loss")
        split.append(dict(stages=dict(clock.ms), peaks=dict(clock.peak), launches=WK.launches,
                          fg=int(out["targets"]["reg_valid_mask"].sum())))
        del out
    moved = [k for k, v in model.single_det.state_dict().items() if not torch.equal(v, first[k])]
    if moved:
        raise AssertionError(f"{tag}: the frozen first stage moved: {moved[:5]}")
    if any(r["launches"] != EXPECTED_LAUNCHES["window"][0] * batch_size for r in rows + split):
        raise AssertionError(f"{tag}: B1 launches a step {[r['launches'] for r in rows]}, "
                             f"a forward {[r['launches'] for r in split]}")
    timed, timed_split = rows[TS_STEP_WARMUP:], split[TS_STEP_WARMUP:]
    res = dict(batch=batch_size, step_ms=_median([r["step_ms"] for r in timed]),
               stages_ms={s: _median([r["stages"][s] for r in timed]) for s in TS_STEP_STAGES},
               stages_peak_gb={s: max(r["peaks"][s] for r in timed) for s in TS_STEP_STAGES},
               peak_mem_gb=max(max(r["peaks"].values()) for r in timed),
               forward_stages_ms={s: _median([r["stages"][s] for r in timed_split])
                                  for s in TS_FORWARD_STAGES},
               forward_stages_peak_gb={s: max(r["peaks"][s] for r in timed_split)
                                       for s in TS_FORWARD_STAGES},
               launches_per_step=[r["launches"] for r in rows],
               launches_per_forward=[r["launches"] for r in split],
               fg_rois=[r["fg"] for r in split], iou=iou,
               metrics=rows[-1]["metrics"], steps=rows, forwards=split)
    del batch, opt, train_step
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _ts_tiny_run(dev):
    """The tiny two-stage model (DP_RATIO 0, seeded weights) on ``dev``:
    its eval outputs, and one train-mode forward's loss terms with draws
    from a seeded generator on a batch whose gt boxes hold its own first
    stage's boxes (``_gt_from_first_stage``)."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import ConfigDict

    cfg = ConfigDict.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", "tests", "two_stage_tiny.py"))
    cfg["S_model"]["roi_head"]["model_cfg"]["DP_RATIO"] = 0.0
    model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                           voxel_generator=cfg["voxel_generator"], device=dev,
                           generator=torch.Generator().manual_seed(3))
    batch = make_batch(cfg, 2, max_voxels=256, n_points=500, n_obj=3, device=dev,
                       with_targets=True)
    with torch.inference_mode():
        out = model(batch)
    boxes = out["first_boxes"]
    batch = _gt_from_first_stage(model, batch, len(TS_GT_SHIFTS))
    model.train()
    rand = torch.rand((2, 16), generator=torch.Generator().manual_seed(7))
    tout = model(batch, rand=rand)
    loss, logs = model.loss(tout, batch)
    cpu = {k: v.detach().cpu() for k, v in out.items() if k.startswith("rcnn")}
    cpu.update(valid=boxes["valid"].cpu(), labels=boxes["label_preds"].cpu(),
               index=tout["targets"]["index"].cpu())
    return cpu, {k: float(v.detach()) for k, v in dict(logs, loss=loss).items()}


def _ts_tiny_agreement():
    """``_ts_tiny_run`` on the card against the CPU: the RoIs, their labels
    and the sampled rows equal; the RoI head's maps and the loss terms within
    ``TS_TINY_TOL`` of the CPU's largest value."""
    (cu, cu_m), (cp, cp_m) = _ts_tiny_run("cuda"), _ts_tiny_run("cpu")
    for k in ("valid", "labels", "index"):
        if not bool((cu[k] == cp[k]).all()):
            raise AssertionError(f"tiny two-stage: {k} differs between the card and the CPU")
    maps = max(float((cu[k] - cp[k]).abs().max() / cp[k].abs().max().clamp(min=1e-6))
               for k in ("rcnn_cls", "rcnn_reg"))
    loss = max(abs(v - cp_m[k]) / max(abs(cp_m[k]), 1e-6) for k, v in cu_m.items())
    res = dict(maps=maps, loss_terms=loss, cpu_metrics=cp_m)
    print(f"[two_stage] tiny model, cuda vs cpu: RoI head maps {maps:.3e}, loss terms "
          f"{loss:.3e} (within {TS_TINY_TOL})", flush=True)
    if max(maps, loss) > TS_TINY_TOL:
        raise AssertionError(f"tiny two-stage disagrees with its CPU run: {res}")
    return res


def _det3d_layout(flax_path, port, module, tf_name):
    """The det3d tensor that the converter's rule (``tf_name``) maps onto
    the port tensor ``port``: the port's layout back to Flax's, then the
    rule's transform inverted."""
    import numpy as np
    import torch

    a = port.detach().cpu().numpy()
    leaf = flax_path[-1]
    if leaf.endswith("_kernel"):            # (Co, Ci, kz, ky, kx) -> det3d (kz, ky, kx, Ci, Co)
        return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (2, 3, 4, 1, 0))))
    if leaf == "kernel":
        n = a.ndim - 2
        if isinstance(module, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)):
            flax = np.flip(np.transpose(a, tuple(range(2, 2 + n)) + (0, 1)), tuple(range(n)))
        else:
            flax = np.transpose(a, tuple(range(2, 2 + n)) + (1, 0))
        inv = {"t_conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
               "t_convt2d": lambda w: np.transpose(w[::-1, ::-1], (2, 3, 0, 1)),
               "t_linear": lambda w: np.transpose(w, (1, 0))}[tf_name]
        return torch.from_numpy(np.ascontiguousarray(inv(flax)))
    return torch.from_numpy(a.copy())


def _ts_converter(tmp):
    """The converter at full width: a det3d-layout state dict built from the
    flagship dense teacher's own weights by inverting the converter's rules,
    saved as a det3d ``.pth``, converted by ``tools/convert_checkpoint.py``
    (``--model_key model``), loaded into a teacher of other weights by
    ``--load_from``'s loader (``load_checkpoint`` + ``merge_params``): every
    entry equal to the source's, and the head maps on the frame within
    ``TS_CONVERT_TOL`` of the source model's."""
    import logging

    import torch

    from sparse2dense_tpu_torch.convert import port_key
    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.tools import convert_checkpoint as CC
    from sparse2dense_tpu_torch.tools.profile_train_step import FRAME
    from sparse2dense_tpu_torch.training.checkpoint import load_checkpoint, merge_params
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import FLAGSHIP, ConfigDict

    t0 = time.perf_counter()
    cfg = ConfigDict.fromfile(FLAGSHIP)
    kw = dict(test_cfg=cfg["test_cfg"], voxel_generator=cfg["voxel_generator"], device="cuda")
    src = build_detector(cfg["model"], generator=torch.Generator().manual_seed(21), **kw)
    state, modules = src.state_dict(), dict(src.named_modules())
    det3d = {}
    for pat, path_tpl, tf in CC.rules_for_model(dict(cfg["model"])):
        text = pat.pattern.strip("^$").replace("\\", "")
        for g in range(8):
            key = text.replace(r"(d+)", str(g))
            path = tuple(seg.format(g) if "{" in seg else seg for seg in path_tpl)
            name = port_key(path[0], path[1:])
            if name in state and key not in det3d:
                det3d[key] = _det3d_layout(path[1:], state[name],
                                           modules.get(".".join(path[1:-1])), tf.__name__)
    pth = os.path.join(tmp, "teacher_epoch_30.pth")
    torch.save({"state_dict": det3d, "meta": {"epoch": 30}}, pth)
    out = CC.main([FLAGSHIP, pth, os.path.join(tmp, "converted"), "--model_key", "model"])
    restored, meta = load_checkpoint(out)
    dst = build_detector(cfg["model"], generator=torch.Generator().manual_seed(22), **kw)
    dst.load_state_dict(merge_params(dst.state_dict(), restored["model"],
                                     logging.getLogger("chip_smoke")))
    differ = [k for k, v in dst.state_dict().items() if not torch.equal(v, state[k])]
    batch = make_batch(cfg, 1, max_voxels=150000, device="cuda", **FRAME)
    with torch.inference_mode():
        want, got = src(batch)["preds"], dst(batch)["preds"]
    gap = max(float((got[t][k] - v).abs().max() / v.abs().max().clamp(min=1e-6))
              for t, pd in enumerate(want) for k, v in pd.items())
    res = dict(det3d_keys=len(det3d), port_keys=len(state), entries_differ=len(differ),
               head_maps_rel=gap, source=meta.get("source") == pth,
               seconds=time.perf_counter() - t0)
    if differ or gap > TS_CONVERT_TOL or not res["source"]:
        raise AssertionError(f"converter at full width: {res}, e.g. {differ[:5]}")
    del src, dst
    torch.cuda.empty_cache()
    return res


def _ts_test_cli(cfg, records, tmp):
    """``tools/test.py --checkpoint`` on the two-stage recipe over phase 12's
    val records (the seeded model's checkpoint; score threshold 0, so that
    the untrained first stage's candidates reach the RoI head and the
    evaluation): the detections' file, the mAP dict, 6 B1 launches a frame."""
    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import test as test_cli
    from sparse2dense_tpu_torch.training.checkpoint import save_checkpoint
    from sparse2dense_tpu_torch.utils.config import TWO_STAGE

    cfg_path = os.path.join(tmp, "two_stage_records.py")
    with open(TWO_STAGE) as f, open(cfg_path, "w") as out:
        out.write(f.read() + DATA_APPEND.format(root=records["root"], train=records["train"],
                                                val=records["val"]) + EVAL_APPEND)
    model = _ts_model(cfg, seed=5)
    ckpt = save_checkpoint(tmp, "two_stage_seeded", {"model": model.state_dict()}, latest=False)
    del model
    torch.cuda.empty_cache()
    evald = os.path.join(tmp, "two_stage_eval")
    WK.launches = 0
    detections, (result, _), times = test_cli.main(
        [cfg_path, "--checkpoint", ckpt, "--work_dir", evald, "--speed_test"])
    res = dict(launches=WK.launches, ms_frame=[1000 * t for t in times],
               detections=sum(len(d["scores"]) for d in detections.values()),
               local_bev_mAP=result.get("local_bev_mAP"))
    if res["launches"] != EXPECTED_LAUNCHES["window"][0] * DATA_VAL_FRAMES or \
            sorted(detections) != [f"val_{i}" for i in range(DATA_VAL_FRAMES)] or \
            not os.path.exists(os.path.join(evald, "detection_pred.pkl")) or \
            res["detections"] == 0 or not math.isfinite(res["local_bev_mAP"]):
        raise AssertionError(f"two_stage tools/test.py: {res}, {sorted(detections)}")
    return res


def phase_two_stage(smi, records):
    """The two-stage recipe on the card (``TWO_STAGE``: the flagship student
    frozen under the RoI head, 500 RoIs, 5 points a box, BEV at stride 8
    from 512 channels): inference frames at batch 1 (window engine, 6 B1 a
    frame; medians of the frame and of its stages); model-level training
    steps at batch 1 and 6 (``_ts_steps``); the pillar two-stage recipe's
    frame (``PP_TWO_STAGE``, no sparse kernel); the tiny model on the card
    against the CPU; the converter at full width; ``tools/test.py`` on the
    recipe over phase 12's val records (``records``: its root and info
    paths). Launch counts set to 0 just before each run and read just
    after."""
    import gc

    import torch

    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import (PP_TWO_STAGE, TWO_STAGE, ConfigDict,
                                                     frame_voxels)

    t0, res, parts = time.perf_counter(), {}, {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    cfg = ConfigDict.fromfile(TWO_STAGE)
    model = _ts_model(cfg)
    batch = make_batch(cfg, 1, max_voxels=frame_voxels(cfg, train=False), n_points=170000,
                       n_obj=32, device="cuda")
    bias, rois = _ts_heatmap_bias(model, batch, cfg)
    res["frame"] = dict(_ts_frames(model, batch, "two_stage", EXPECTED_LAUNCHES["window"][0]),
                        heatmap_bias=bias, valid_rois=rois)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    part("frames")
    res["steps"] = {b: _ts_steps(cfg, model, b) for b in TS_BATCHES}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    part("steps")

    pcfg = ConfigDict.fromfile(PP_TWO_STAGE)
    pmodel = _ts_model(pcfg)
    batch = make_batch(pcfg, 1, max_voxels=frame_voxels(pcfg, train=False), device="cuda",
                       **PP_FRAME)
    bias, rois = _ts_heatmap_bias(pmodel, batch, pcfg)
    res["pp_frame"] = dict(_ts_frames(pmodel, batch, "two_stage pp", 0), heatmap_bias=bias,
                           valid_rois=rois)
    del pmodel, batch
    gc.collect()
    torch.cuda.empty_cache()
    part("pp_frames")
    with no_tf32():
        res["tiny"] = _ts_tiny_agreement()
    part("tiny")
    with tempfile.TemporaryDirectory() as tmp:
        res["converter"] = _ts_converter(tmp)
        part("converter")
        res["test_cli"] = _ts_test_cli(cfg, records, tmp)
        part("test_cli")
    res["seconds"], res["part_seconds"] = time.perf_counter() - t0, parts
    f, pf = res["frame"], res["pp_frame"]
    print(f"[two_stage] frame (batch 1, {f['rois'][1]} RoIs x {f['rois'][2]} features): median "
          f"{f['frame_ms_median']:.2f} ms over {TS_TIMED}; stages "
          f"{', '.join(f'{k} {v:.2f}' for k, v in f['stages_ms'].items())} ms; peak "
          f"{f['peak_mem_gb']:.2f} GiB; {f['detections']} detections (first stage's heatmap "
          f"bias {f['heatmap_bias']}: {f['valid_rois']} valid RoIs); B1 {f['launches']} | {smi}",
          flush=True)
    for b, s in res["steps"].items():
        iou = s["iou"]
        busy = "not measured" if iou["device_busy_ms"] is None else \
            f"{iou['device_busy_ms']:.2f} ms over {iou['device_ops']} device operations"
        print(f"[two_stage] make_train_step, batch {b}: median {s['step_ms']:.1f} ms ("
              f"{', '.join(f'{k} {v:.1f}' for k, v in s['stages_ms'].items())}); peak "
              f"{s['peak_mem_gb']:.2f} GiB (by stage: "
              f"{', '.join(f'{k} {v:.2f}' for k, v in s['stages_peak_gb'].items())}); "
              f"train-mode forward and loss split "
              f"{', '.join(f'{k} {v:.1f}' for k, v in s['forward_stages_ms'].items())} ms; "
              f"fg RoIs {s['fg_rois']}; B1 a step {s['launches_per_step']}, a forward "
              f"{s['launches_per_forward']}; boxes_iou3d over {iou['pairs']} pairs: host "
              f"{iou['host_ms']:.2f} ms, event span {iou['span_ms']:.2f} ms, device busy "
              f"{busy}; rcnn_loss_cls {s['metrics']['rcnn_loss_cls']:.4f}, rcnn_loss_reg "
              f"{s['metrics']['rcnn_loss_reg']:.4f} | {smi}", flush=True)
    print(f"[two_stage] pillar two-stage frame: median {pf['frame_ms_median']:.2f} ms; stages "
          f"{', '.join(f'{k} {v:.2f}' for k, v in pf['stages_ms'].items())} ms; peak "
          f"{pf['peak_mem_gb']:.2f} GiB; {pf['valid_rois']} valid RoIs at heatmap bias "
          f"{pf['heatmap_bias']}; (B1, B2, B3) 0 | {smi}", flush=True)
    c, t = res["converter"], res["test_cli"]
    print(f"[two_stage] converter at full width: {c['det3d_keys']} det3d keys onto "
          f"{c['port_keys']} teacher entries, {c['entries_differ']} differ, head maps "
          f"{c['head_maps_rel']:.3e} of their largest; {c['seconds']:.1f} s | {smi}", flush=True)
    print(f"[two_stage] tools/test.py --checkpoint on the recipe: "
          f"{', '.join(f'{x:.1f}' for x in t['ms_frame'])} ms a frame (after 2), "
          f"{t['detections']} detections, local BEV mAP {t['local_bev_mAP']}, B1 "
          f"{t['launches']}; phase {res['seconds']:.1f} s ("
          f"{', '.join(f'{k} {v:.1f}' for k, v in parts.items())}) | {smi}", flush=True)
    print("[two_stage] " + json.dumps(res), flush=True)
    return res


# phase "nusc": the nuScenes families at full width. NUSC_* sizes: records of
# NUSC_FRAMES scenes (a key frame and 10 sweeps of NUSC_SWEEP_POINTS each, from
# a scene of twice that, so the sweeps share voxels as a lidar's do: ~137k
# voxels a view at 0.075 x 0.075 x 0.2 m, under the test budget of 160,000)
NUSC_FRAMES, NUSC_SWEEP_POINTS, NUSC_OBJECTS = 8, 30000, 32
NUSC_WARMUP, NUSC_TIMED = 2, 5
NUSC_VIEWS = 4   # double flip: [orig, yflip, xflip, double] a frame
NUSC_STEP_BATCHES = (1, 4)   # the training step at batch 1 and the recipe's samples_per_gpu
NUSC_STEP_WARMUP, NUSC_STEPS = 1, 2
NUSC_CANDIDATES = 300   # heatmap cells a frame over the score threshold (``_nusc_heatmap_bias``)
NUSC_FRAME_STAGES = ("reader_backbone", "neck", "heads", "merge", "decode_nms")
NUSC_TINY_TOL = 1e-4
NUSC_DOWN_BUDGET = 280000   # the nuScenes recipes' stage budget of conv2_down's output
NUSC_DATA_APPEND = """
data["workers_per_gpu"] = {workers}
data["val"].update(root_path={root!r}, info_path={info!r}, ann_file={info!r})
data["train"].update(root_path={root!r}, info_path={info!r}, ann_file={info!r})
"""


def _nusc_model(cfg, seed=0):
    """The recipe's detector (``model``) on the card, seeded weights."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.utils.config import detector_cfg

    return build_detector(detector_cfg(cfg), test_cfg=cfg["test_cfg"],
                          voxel_generator=cfg["voxel_generator"], device="cuda",
                          generator=torch.Generator().manual_seed(seed))


def _nusc_heatmap_bias(model, batch, cfg):
    """Sets every task's heatmap output bias so that ``NUSC_CANDIDATES``
    cells of a frame's merged (or single-view) heatmaps pass the score
    threshold (random weights give heatmaps of small spread: at the initial
    -2.19 every cell passes and floods the NMS) -> the bias."""
    import math

    import torch

    from sparse2dense_tpu_torch.models.heads.center_head import merge_double_flip

    heads = [getattr(model.bbox_head, f"task_{t}") for t in range(len(model.bbox_head.tasks))]
    outs = [h.cls_head_out if hasattr(h, "cls_head_out") else h.hm_out for h in heads]
    with torch.no_grad():
        for o in outs:
            o.bias.zero_()
    with torch.inference_mode():
        preds = model(batch)["preds"]
        if cfg["test_cfg"].get("double_flip", False):
            preds = [merge_double_flip(pd) for pd in preds]
        logits = torch.cat([p["hm"].flatten(1) for p in preds], 1)
        kth = float(logits.topk(NUSC_CANDIDATES, 1).values[:, -1].min())
    thr = cfg["test_cfg"]["score_threshold"]
    bias = math.log(thr / (1 - thr)) - kth
    with torch.no_grad():
        for o in outs:
            o.bias.fill_(bias)
    return bias


def _nusc_window_rows(batch, grid, gen):
    """B1 against its plain version on the nuScenes frame's own plans (the
    key view's rows of the frame's batch, padded to the test budget as the
    model gets them, on the 41x1440x1440 grid: conv_input 5->16 and conv1
    16->16 on the subm plan, conv2_down 16->32 on the strided plan at the
    recipe's stage budget), per frame 4 views x (1, 4, 1); and conv2_down's
    active output cells against that budget (the stages past it are dense,
    and the backbone reports only its plans' residual rows)."""
    import torch

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid
    from sparse2dense_tpu_torch.tools.bench_window_pass import window_cases

    cases, *_, coords, _ = window_cases(batch, grid, gen, down_budget=NUSC_DOWN_BUDGET)
    # conv2_down's active output cells against the recipe's stage budget
    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    out_lin = WC.downsample_active_set_yxz(coords, coords[:, 0] >= 0, grid,
                                           conv_out_grid(grid, *down), *down, 4 * 10 ** 6)[1]
    active = int((out_lin < WC.MISS).sum())
    rows = []
    for name, plan, f, cin, cout, ksize, per_view, stride, pad in cases[:3]:
        row = _window_case_row(name + " (nusc)", plan, f, cin, cout, ksize, 0, stride, pad,
                               coords, grid, gen)
        row["per_frame_nusc"] = NUSC_VIEWS * per_view
        rows.append(row)
    torch.cuda.empty_cache()
    return rows, dict(conv2_down_active=active, stage_budget=NUSC_DOWN_BUDGET,
                      stage_overflow=max(0, active - NUSC_DOWN_BUDGET))


def _nusc_frames(model, dataset, cfg, tag, want_b1):
    """Frames of a nuScenes recipe from its val records: the host pipeline
    (load, sweeps, flips, voxelizations) and the copy to the card timed
    apart (the frames cycle through the records); the whole frame (``model(batch)`` + ``predict``) and, in as many
    frames again, its stages (the reader and backbone over the views, the
    neck, the heads, the double-flip merge, decode and NMS) with a stage
    clock; medians; B1 launches a frame; finite boxes; the
    split's detections equal the whole frame's; the peak; the backbone's
    counters (the most over the frames) against their budgets."""
    import torch

    from sparse2dense_tpu_torch.data.loader import collate_tensors, to_device
    from sparse2dense_tpu_torch.models.heads.center_head import (center_head_predict,
                                                                 merge_double_flip)
    from sparse2dense_tpu_torch.ops import window_kernel as WK

    budget = cfg["voxel_generator"]["max_voxel_num"][1]
    flip = bool(cfg["test_cfg"].get("double_flip", False))
    plain_cfg = dict(cfg["test_cfg"], double_flip=False)
    host, copy, whole, split, per_frame, counters = [], [], [], [], [], {}
    torch.cuda.reset_peak_memory_stats()
    _zero_sparse_launches()
    for i in range(NUSC_WARMUP + 2 * NUSC_TIMED):
        t = time.perf_counter()
        example = dataset[i % len(dataset)]
        t1 = time.perf_counter()
        batch = to_device(collate_tensors([example], budget), torch.device("cuda"))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        batch = {k: v for k, v in batch.items() if k != "metadata"}
        before = WK.launches
        staged = i >= NUSC_WARMUP + NUSC_TIMED
        with torch.inference_mode():
            if staged:
                clock = _StageClock()
                f_a, _, telemetry = model._bev(batch, "")
                clock("reader_backbone")
                x = model.neck(f_a)
                clock("neck")
                preds = model.bbox_head(x)
                clock("heads")
                if flip:
                    preds = [merge_double_flip(pd) for pd in preds]
                clock("merge")
                det = center_head_predict(preds, plain_cfg, model.bbox_head.num_classes)
                clock("decode_nms")
                split.append(clock.ms)
                again = model.predict(model(batch))
                same = all(bool(torch.equal(det[k], again[k])) for k in det)
                if not same:
                    raise AssertionError(f"{tag}: the stage split's detections differ from "
                                         "the frame's")
            else:
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                out = model(batch)
                det = model.predict(out)
                torch.cuda.synchronize()
                if i >= NUSC_WARMUP:
                    whole.append((time.perf_counter() - t3) * 1e3)
                    host.append((t1 - t) * 1e3)
                    copy.append((t2 - t1) * 1e3)
                telemetry = out["telemetry"]
        per_frame.append((WK.launches - before) // (2 if staged else 1))
        for k, (c, b) in telemetry.items():   # the most over the frames
            counters[k] = [max(int(c.max()), counters.get(k, [0])[0]), b]
    launches = _sparse_launches()
    if per_frame != [want_b1] * len(per_frame) or launches[1:] != (0, 0):
        raise AssertionError(f"{tag}: (B1, B2, B3) launches {launches}, B1 a frame "
                             f"{per_frame}, expected {want_b1}")
    valid = det["valid"]
    if not bool(torch.isfinite(det["box3d_lidar"][valid]).all()) or not bool(valid.any()):
        raise AssertionError(f"{tag}: {int(valid.sum())} valid boxes, or not finite")
    return dict(frame_ms_median=_median(whole), frame_ms=whole, host_ms_median=_median(host),
                to_device_ms_median=_median(copy),
                stages_ms={k: _median([s[k] for s in split]) for k in split[0]},
                launches=launches[0], launches_per_frame=per_frame[0],
                detections=int(valid.sum()), views=int(batch["voxels"].shape[0]),
                voxels=[int((batch["coordinates"][v, :, 0] >= 0).sum())
                        for v in range(batch["voxels"].shape[0])],
                counters=counters, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)


def _nusc_steps(cfg, dataset, batch_size):
    """``make_train_step`` on the 0075voxel_dcn recipe at ``batch_size``
    (samples of its train pipeline from the records, keys (0, epoch, i)):
    the medians of the step and its stages (forward with the loss,
    backward, optimizer), the peaks; finite metrics, ``grad_norm`` > 0,
    a nonzero gradient on every DCN head's offset and deformable convs, 6
    B1 launches a sample a step. Out of memory: the peak it reached,
    reported, not hidden."""
    import gc

    import torch

    from sparse2dense_tpu_torch.data.loader import collate_tensors, to_device
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
    from sparse2dense_tpu_torch.training.train_state import make_train_step

    model = _nusc_model(cfg, seed=7)
    budget = cfg["voxel_generator"]["max_voxel_num"][0]
    examples = [dataset[0, e, i % len(dataset)] for e, i in
                ((k // len(dataset), k) for k in range(batch_size))]
    batch = to_device(collate_tensors(examples, budget), torch.device("cuda"))
    batch = {k: v for k, v in batch.items() if k != "metadata"}
    opt = OneCycleAdam(model.parameters(), cfg["optimizer"], cfg["lr_config"], 10,
                       cfg["optimizer_config"]["grad_clip"])
    step = make_train_step(model, opt)
    rows, res = [], dict(batch=batch_size, out_of_memory=False)
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(NUSC_STEP_WARMUP + NUSC_STEPS):
            WK.launches = 0
            clock = _StageClock()
            metrics = step(batch, mark=clock)
            rows.append(dict(step_ms=sum(clock.ms.values()), stages=dict(clock.ms),
                             peaks=dict(clock.peak), launches=WK.launches,
                             metrics={k: float(v) for k, v in metrics.items()}))
    except torch.cuda.OutOfMemoryError:
        res.update(out_of_memory=True, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   card_gb=torch.cuda.get_device_properties(0).total_memory / 2 ** 30,
                   free_gb=torch.cuda.mem_get_info()[0] / 2 ** 30)
    if not res["out_of_memory"]:
        tag = f"nusc train batch {batch_size}"
        _check_metrics(tag, rows[-1]["metrics"])
        dead = [n for n, p in model.named_parameters()
                if (".conv_offset." in n or ".conv_adaption." in n)
                and (p.grad is None or not bool(p.grad.abs().max() > 0))]
        if dead:
            raise AssertionError(f"{tag}: no gradient on {dead[:4]}")
        if any(r["launches"] != EXPECTED_LAUNCHES["window"][0] * batch_size for r in rows):
            raise AssertionError(f"{tag}: B1 a step {[r['launches'] for r in rows]}")
        timed = rows[NUSC_STEP_WARMUP:]
        res.update(step_ms=_median([r["step_ms"] for r in timed]),
                   stages_ms={s: _median([r["stages"][s] for r in timed])
                              for s in timed[0]["stages"]},
                   stages_peak_gb={s: max(r["peaks"][s] for r in timed)
                                   for s in timed[0]["stages"]},
                   peak_mem_gb=max(max(r["peaks"].values()) for r in timed),
                   launches_per_step=[r["launches"] for r in rows],
                   voxels=[int((batch["coordinates"][b, :, 0] >= 0).sum())
                           for b in range(batch_size)],
                   metrics=rows[-1]["metrics"])
    del model, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _nusc_test_cli(cfg_path, model, tmp, batch_size):
    """``tools/test.py --checkpoint --batch_size`` on the served recipe over
    the val records (the seeded model's checkpoint): a token a frame, the
    results json, (None, None) without the devkit, 24 B1 launches a frame.
    Out of memory at ``batch_size`` 2: the peak at 1 frame, then a run at 1."""
    import torch

    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.tools import test as test_cli
    from sparse2dense_tpu_torch.training.checkpoint import save_checkpoint

    ckpt = save_checkpoint(tmp, "nusc_seeded", {"model": model.state_dict()}, latest=False)
    evald = os.path.join(tmp, "nusc_eval")
    res = dict(batch=batch_size)
    WK.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        detections, result, times = test_cli.main(
            [cfg_path, "--checkpoint", ckpt, "--work_dir", evald, "--batch_size",
             str(batch_size), "--speed_test"])
    except torch.cuda.OutOfMemoryError:
        res.update(out_of_memory_at=batch_size,
                   peak_gb_at_oom=torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.empty_cache()
        return dict(_nusc_test_cli(cfg_path, model, tmp, 1), **res)
    frames = len(detections)
    res.update(launches=WK.launches, ms_batch=[1000 * t for t in times], frames=frames,
               detections=sum(len(d["scores"]) for d in detections.values()),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    path = os.path.join(evald, "infos_pred_nusc.json")
    with open(path) as f:
        written = json.load(f)["results"]
    want_frames = NUSC_FRAMES // batch_size * batch_size
    if result != (None, None) or sorted(detections) != [f"sample_{i}" for i in
                                                         range(want_frames)] \
            or sorted(written) != sorted(detections) or res["detections"] == 0 \
            or res["launches"] != 6 * NUSC_VIEWS * frames:
        raise AssertionError(f"nusc tools/test.py: {res}, {sorted(detections)}, {result}")
    return res


def _nusc_tiny_cfg():
    """``configs/tests/voxelnet_tiny.py`` as a nuScenes model: the six tasks,
    the velocity head and code weights, DCN heads, double flip, score
    threshold 0."""
    from sparse2dense_tpu_torch.training.synthetic import NUSC_CLASSES
    from sparse2dense_tpu_torch.utils.config import ConfigDict

    cfg = ConfigDict.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", "tests", "voxelnet_tiny.py"))
    tasks = [dict(num_class=len(c), class_names=list(c)) for c in
             (NUSC_CLASSES[:1], NUSC_CLASSES[1:3], NUSC_CLASSES[3:5], NUSC_CLASSES[5:6],
              NUSC_CLASSES[6:8], NUSC_CLASSES[8:10])]
    cfg["class_names"] = list(NUSC_CLASSES)
    cfg["S_model"]["bbox_head"].update(
        tasks=tasks, dataset="nuscenes", weight=0.25, dcn_head=True,
        code_weights=[1.0] * 6 + [0.2, 0.2, 1.0, 1.0],
        common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2),
                      "vel": (2, 2)})
    cfg["train_cfg"]["assigner"]["target_assigner"]["tasks"] = tasks
    cfg["test_cfg"].update(double_flip=True, score_threshold=0.0)
    return cfg


def _nusc_tiny_run(dev):
    """The tiny nuScenes model (seeded weights) on ``dev``: its eval maps
    and detections on a double-flip frame (4 views), and one training
    step's metrics at batch 2."""
    import torch

    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.training.train_state import make_train_step

    cfg = _nusc_tiny_cfg()
    model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                           voxel_generator=cfg["voxel_generator"], device=dev,
                           generator=torch.Generator().manual_seed(4))
    frame = dict(max_voxels=512, n_points=3000, n_obj=6)
    batch = make_batch(cfg, 1, device=dev, **frame)
    with torch.inference_mode():
        out = model(batch)
        det = model.predict(out)
    maps = {f"{t}/{k}": v.cpu() for t, pd in enumerate(out["preds"]) for k, v in pd.items()}
    maps.update({k: det[k].cpu() for k in ("box3d_lidar", "scores")})
    labels = (det["valid"].cpu(), det["label_preds"].cpu())
    batch = make_batch(cfg, 2, device=dev, with_targets=True, **frame)
    opt = OneCycleAdam(model.parameters(), cfg["optimizer"], cfg["lr_config"], 4,
                       cfg["optimizer_config"]["grad_clip"])
    metrics = make_train_step(model, opt)(batch)
    return maps, labels, {k: float(v) for k, v in metrics.items()}


def _nusc_tiny_agreement():
    """``_nusc_tiny_run`` on the card against the CPU: detections' validity
    and labels equal; maps, boxes, scores and the step's metrics within
    ``NUSC_TINY_TOL`` of the CPU's largest value."""
    (cu, cu_l, cu_m), (cp, cp_l, cp_m) = _nusc_tiny_run("cuda"), _nusc_tiny_run("cpu")
    if not all(bool((a == b).all()) for a, b in zip(cu_l, cp_l)):
        raise AssertionError("tiny nusc: valid or labels differ between the card and the CPU")
    maps = max(float((cu[k] - cp[k]).abs().max() / cp[k].abs().max().clamp(min=1e-6))
               for k in cp)
    step = max(abs(v - cp_m[k]) / max(abs(cp_m[k]), 1e-6) for k, v in cu_m.items())
    res = dict(maps=maps, step=step, valid=int(cp_l[0].sum()))
    print(f"[nusc] tiny model, cuda vs cpu: maps and detections {maps:.3e}, step metrics "
          f"{step:.3e} (within {NUSC_TINY_TOL}); {res['valid']} detections", flush=True)
    if max(maps, step) > NUSC_TINY_TOL:
        raise AssertionError(f"tiny nusc disagrees with its CPU run: {res}")
    return res


def phase_nusc(smi):
    """The nuScenes families on the card (``utils.config.NUSC_*``): records
    of NUSC_FRAMES 10-sweep scenes (``training/synthetic.write_nusc_records``);
    B1 against its plain version on the served frame's own plans; frames of
    ``0075voxel_dcn_flip`` (4 views, DCN heads, the merge; 24 B1 a frame)
    split by stage, with the backbone's counters; ``tools/test.py
    --batch_size 2`` over the records (per-frame tokens); ``make_train_step``
    on ``0075voxel_dcn`` at batch 1 and 4; the ``circular_nms`` pillar frame
    (no sparse kernel); the tiny nuScenes model on the card against the CPU.
    Launch counts set to 0 just before each run and read just after."""
    import gc

    import torch

    from sparse2dense_tpu_torch.data.loader import build_dataset, collate_tensors, to_device
    from sparse2dense_tpu_torch.models.builder import sparse_shape_from_voxel_cfg
    from sparse2dense_tpu_torch.training.synthetic import write_nusc_records
    from sparse2dense_tpu_torch.utils.config import NUSC_PP, NUSC_VOXELNET, ConfigDict

    t0, res, parts = time.perf_counter(), {}, {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    free_b, total_b = torch.cuda.mem_get_info()
    res["card_at_start"] = dict(allocated_gb=torch.cuda.memory_allocated() / 2 ** 30,
                                free_gb=free_b / 2 ** 30, total_gb=total_b / 2 ** 30)
    with tempfile.TemporaryDirectory() as tmp:
        info = write_nusc_records(tmp, NUSC_FRAMES, NUSC_SWEEP_POINTS, n_obj=NUSC_OBJECTS)
        paths = {}
        for name, src, workers in (("flip", NUSC_VOXELNET["0075voxel_dcn_flip"], 2),
                                   ("dcn", NUSC_VOXELNET["0075voxel_dcn"], 0),
                                   ("pp", NUSC_PP["circular_nms"], 0)):
            paths[name] = os.path.join(tmp, f"nusc_{name}.py")
            with open(src) as f, open(paths[name], "w") as out:
                out.write(f.read() + NUSC_DATA_APPEND.format(workers=workers, root=tmp,
                                                             info=info))
        cfg = ConfigDict.fromfile(paths["flip"])
        val = build_dataset(cfg.data["val"])
        example = val[0]
        res["records"] = dict(
            points=len(example[0]["points"]),
            sweep_points=[int((example[0]["points"][:, 4] == lag).sum())
                          for lag in sorted(set(example[0]["points"][:, 4].tolist()))],
            voxels_per_view=[int(e["num_voxels"][0]) for e in example])
        part("records")
        first = to_device(collate_tensors([example], cfg["voxel_generator"]["max_voxel_num"][1]),
                          torch.device("cuda"))
        first = {k: v for k, v in first.items() if k != "metadata"}
        gen = torch.Generator(device="cuda").manual_seed(15)
        res["window_rows"], res["stage"] = _nusc_window_rows(
            first, sparse_shape_from_voxel_cfg(cfg["voxel_generator"]), gen)
        part("b1_rows")

        model = _nusc_model(cfg)
        res["heatmap_bias"] = _nusc_heatmap_bias(model, first, cfg)
        del first
        res["frame"] = _nusc_frames(model, val, cfg, "nusc dcn_flip",
                                    EXPECTED_LAUNCHES["window"][0] * NUSC_VIEWS)
        free()
        part("frames")
        res["test_cli"] = _nusc_test_cli(paths["flip"], model, tmp, 2)
        del model
        free()
        part("test_cli")

        dcfg = ConfigDict.fromfile(paths["dcn"])
        train = build_dataset(dcfg.data["train"])
        res["steps"] = {b: _nusc_steps(dcfg, train, b) for b in NUSC_STEP_BATCHES}
        free()
        part("steps")

        pcfg = ConfigDict.fromfile(paths["pp"])
        pmodel = _nusc_model(pcfg)
        pval = build_dataset(pcfg.data["val"])
        first = to_device(collate_tensors([pval[0]], pcfg["voxel_generator"]["max_voxel_num"][1]),
                          torch.device("cuda"))
        res["pp_heatmap_bias"] = _nusc_heatmap_bias(
            pmodel, {k: v for k, v in first.items() if k != "metadata"}, pcfg)
        del first
        res["pp_frame"] = _nusc_frames(pmodel, pval, pcfg, "nusc pp circular_nms", 0)
        del pmodel
        free()
        part("pp_frame")
    with no_tf32():
        res["tiny"] = _nusc_tiny_agreement()
    part("tiny")
    res["seconds"], res["part_seconds"] = time.perf_counter() - t0, parts
    _print_nusc(res, smi)
    return res


def _print_nusc(res, smi):
    f, pf, t, r = res["frame"], res["pp_frame"], res["test_cli"], res["records"]
    c = res["card_at_start"]
    print(f"[nusc] records: {r['points']} points a frame (the key frame and 9 sweeps: "
          f"{r['sweep_points']}), voxels a view {r['voxels_per_view']}; the card at the phase's "
          f"start: {c['allocated_gb']:.2f} GiB allocated, {c['free_gb']:.2f} of "
          f"{c['total_gb']:.2f} GiB free | {smi}", flush=True)
    nonzero = {k: v for k, v in f["counters"].items() if v[0] > v[1]}
    st = res["stage"]
    print(f"[nusc] 0075voxel_dcn_flip counters (max count, budget): {f['counters']}; conv2_down "
          f"active cells {st['conv2_down_active']} against the stage budget "
          f"{st['stage_budget']}: overflow {st['stage_overflow']}; "
          + (f"OVER BUDGET: {nonzero}" if nonzero or st["stage_overflow"] else
             "every counter within its budget"), flush=True)
    print(f"[nusc] 0075voxel_dcn_flip frame ({f['views']} views, {f['voxels']} voxels): median "
          f"{f['frame_ms_median']:.2f} ms over {NUSC_TIMED} (host pipeline "
          f"{f['host_ms_median']:.1f} ms, copy to the card {f['to_device_ms_median']:.2f} ms, "
          f"apart); stages {', '.join(f'{k} {v:.2f}' for k, v in f['stages_ms'].items())} ms; "
          f"peak {f['peak_mem_gb']:.2f} GiB; {f['detections']} detections (heatmap bias "
          f"{res['heatmap_bias']:.3f}); B1 {f['launches_per_frame']} a frame | {smi}",
          flush=True)
    oom = (f"out of memory at batch {t['out_of_memory_at']} (peak {t['peak_gb_at_oom']:.2f} "
           f"GiB), run at 1; " if "out_of_memory_at" in t else "")
    print(f"[nusc] tools/test.py --batch_size {t['batch']}: {oom}"
          f"{', '.join(f'{x:.1f}' for x in t['ms_batch'])} ms a batch (after 2), {t['frames']} "
          f"frames keyed apart, {t['detections']} detections, peak {t['peak_mem_gb']:.2f} GiB, "
          f"B1 {t['launches']} | {smi}", flush=True)
    for b, s in res["steps"].items():
        if s["out_of_memory"]:
            print(f"[nusc] 0075voxel_dcn make_train_step, batch {b}: OUT OF MEMORY at "
                  f"{s['peak_mem_gb']:.2f} GiB of the {s['card_gb']:.1f} GiB card "
                  f"({s['free_gb']:.2f} GiB free after) | {smi}", flush=True)
            continue
        print(f"[nusc] 0075voxel_dcn make_train_step, batch {b} ({s['voxels']} voxels): median "
              f"{s['step_ms']:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in s['stages_ms'].items())}"
              f"); peak {s['peak_mem_gb']:.2f} GiB (by stage: "
              f"{', '.join(f'{k} {v:.2f}' for k, v in s['stages_peak_gb'].items())}); loss {s['metrics']['loss']:.3f}, grad_norm "
              f"{s['metrics']['grad_norm']:.3f}; B1 a step {s['launches_per_step']} | {smi}",
              flush=True)
    print(f"[nusc] circular_nms pillar frame: median {pf['frame_ms_median']:.2f} ms (host "
          f"pipeline {pf['host_ms_median']:.1f} ms apart); stages "
          f"{', '.join(f'{k} {v:.2f}' for k, v in pf['stages_ms'].items())} ms; peak "
          f"{pf['peak_mem_gb']:.2f} GiB; {pf['detections']} detections; (B1, B2, B3) 0; phase "
          f"{res['seconds']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in res['part_seconds'].items())})"
          f" | {smi}", flush=True)
    print("[nusc] " + json.dumps({k: v for k, v in res.items() if k != "window_rows"}), flush=True)


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
    if sys.argv[1:] == ["two_stage"]:   # the two-stage phase alone, on fresh records
        with tempfile.TemporaryDirectory() as records:
            paths = _write_records(records)
            phase_two_stage(smi, dict(root=records, **paths))
        print(f"[main] chip_smoke two_stage: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if sys.argv[1:] == ["nusc"]:   # the nuScenes phase alone
        phase_nusc(smi)
        print(f"[main] chip_smoke nusc: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    seconds = {}

    def timed(name, fn, *args, **kw):   # each phase's seconds, printed at the end
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    with no_tf32():
        rows = timed("kernels", phase_kernels)
    probe_rows = timed("probes", phase_probes)
    from sparse2dense_tpu_torch.utils.config import FRAME_BUDGETS, TILE_FRAME_BUDGETS

    window = timed("window", phase_main_path, "window")
    plane = timed("plane", phase_main_path, "plane", budgets=FRAME_BUDGETS)
    tile = timed("tile", phase_main_path, "tile", budgets=TILE_FRAME_BUDGETS)
    train = timed("train", phase_train)
    cli = timed("cli", phase_cli)
    second = timed("second", phase_second)
    engines = timed("engines", phase_engines, plane, tile)
    pp = timed("pp", phase_pp)
    with tempfile.TemporaryDirectory() as records:
        data, for_dp = timed("data", phase_data, smi, records)
        dp = timed("dp", phase_dp, smi, for_dp)
        two_stage = timed("two_stage", phase_two_stage, smi, for_dp["records"])
    nusc = timed("nusc", phase_nusc, smi)
    with no_tf32():
        timed("agreement", phase_agreement)

    wrows, prows, trows = ([r for r in rows if r["kernel"] == k]
                           for k in ("window_pass", "plane_subm", "tile_subm"))
    wrows = wrows + nusc["window_rows"]   # B1 on the nuScenes frame's plans (per_frame 0)
    b1_paths = {"window": window["launches"]["window_pass"],
                "plane": plane["launches"]["window_pass"], "train": train["launches"],
                f"train_batch{BIG_BATCH}": train["big"]["launches"], "cli": cli["launches"],
                "second": second["frame"]["launches"], "second_train": second["train_launches"],
                **{f"second_dfs{dfs}": r["launches"] for dfs, r in second["deep"].items()},
                "second_cli": second["cli"]["launches"], "data_train": data["train_launches"],
                "data_val": data["val_launches"],
                "data_val_untrained": data["untrained_val_launches"],
                "dp_nccl_train": dp["nccl_launches"],
                **{f"dp_gloo_{tag}_{who}": dp[tag][f"{who}_launches"]
                   for tag, *_ in DP_CASES for who in ("rank0", "rank1", "one")},
                "dp_test_rank0": dp["test_launches"][0], "dp_test_rank1": dp["test_launches"][1],
                "two_stage": two_stage["frame"]["launches"],
                **{"two_stage_train" + ("" if b == 1 else f"_batch{b}"):
                   sum(st["launches_per_step"]) for b, st in two_stage["steps"].items()},
                "two_stage_test": two_stage["test_cli"]["launches"],
                "nusc": nusc["frame"]["launches"], "nusc_test": nusc["test_cli"]["launches"],
                **{"nusc_train" + ("" if b == 1 else f"_batch{b}"): sum(st["launches_per_step"])
                   for b, st in nusc["steps"].items() if not st["out_of_memory"]}}
    b2_paths = {"plane": plane["launches"]["plane_subm"]}
    b3_paths = {"tile": tile["launches"]["tile_subm"]}
    for tag, r in engines.items():
        if tag.startswith("window_dfs"):
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
             dfs2_frame=_record("window_pass", "", "", 0, wrows, "per_frame_dfs2"),
             dfs3_frame=_record("window_pass", "", "", 0, wrows, "per_frame_dfs3"),
             dfs99_frame=_record("window_pass", "", "", 0, wrows, "per_frame_dfs99"),
             nusc_frame=_record("window_pass", "", "", 0, nusc["window_rows"], "per_frame_nusc")),
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
    b1_deep = [r for r in wrows if r.get("case") == "deep backward a step"][0]
    for dfs in (3, 99):
        rec = record["kernels"][0][f"dfs{dfs}_frame"]
        print(f"[kernels] window_pass a dense_from_stage={dfs} frame "
              f"({sum(r[f'per_frame_dfs{dfs}'] for r in wrows if r.get(f'per_frame_dfs{dfs}'))} "
              f"launches): L2-warm {rec['ms']:.4f} ms, L2-cold {rec['cold_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms, plain {rec['plain_ms']:.1f} ms, cuDNN "
              f"{rec['library_ms']:.1f} ms; window backward a training step "
              f"{b1_deep[f'window_backward_ms_dfs{dfs}']:.3f} ms", flush=True)
    for dfs, r in second["deep"].items():
        print(f"[second] dense_from_stage {dfs}: frame median {r['frame_ms_median']:.1f} ms, "
              f"{r['launches_per_frame'][0]} window passes a frame; counters "
              f"{json.dumps(r['counters'])}", flush=True)
    for tag, r in engines.items():
        frame = (f"frame median {r['frame']['frame_ms_median']:.1f} ms" if r["frame"] else
                 "no frame")
        print(f"[engines] {tag}: {frame}; student train-mode BEV against the shipped engine "
              f"{r['agreement']['rel_to_max']:.3e} of its largest value "
              f"({'judged' if r['agreement']['exact'] else 'not judged'})", flush=True)
        if tag in ("window_dfs3", "window_dfs99"):
            print(f"[engines] {tag}: the student's residual rows and stage rows against their "
                  f"budgets {json.dumps(r['agreement']['counters']['engine'])}", flush=True)
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
    for role, f in pp["frames"].items():
        print(f"[pp] {role} ({f['model']}) frame: median {f['frame_ms_median']:.1f} ms, min "
              f"{f['frame_ms_min']:.1f}, max {f['frame_ms_max']:.1f}; peak "
              f"{f['peak_mem_gb']:.2f} GiB; {f['detections']} detections", flush=True)
    for b, t in pp["steps"].items():
        print(f"[pp] teacher-student step, batch {b} ({t['pillars']} pillars): median "
              f"{t['step_ms']:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in t['stages_ms'].items())}"
              f"); peak {t['peak_mem_gb']:.2f} GiB (by stage: "
              f"{', '.join(f'{k} {v:.2f}' for k, v in t['stages_peak_gb'].items())})", flush=True)
    print(f"[pp] cli: dense teacher -> load_from -> distil at batch {pp['cli']['batch']} -> "
          f"resume: {pp['cli']['seconds']:.1f} s; phase pp {pp['seconds']:.1f} s; (B1, B2, B3) "
          f"launches 0 on every pp path", flush=True)
    print(f"[main] chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' build "
          f"included; by phase {json.dumps(seconds)}", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
