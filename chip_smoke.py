"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device: the card's name and power limit;
2. kernels: builds the three CUDA kernels from ``sparse2dense_tpu_torch/csrc``
   (one nvcc process per source, started together) and holds each against
   its plain PyTorch version on the real data of one synthetic Waymo frame
   (150k voxels on the 41x1504x1504 grid):
   - the window pass on the window plans of conv_input 5->16, conv1 16->16,
     the strided conv2_down 16->32 (V_out=320000) and a (3,1,1) z-only
     strided conv, within 1e-4 + 1e-4*|p| (summation order only);
   - the plane subm conv on the plane states, masks and plans of conv2
     (32), conv3 (64) and conv4 (128) of the same frame on the plane
     engine, in bfloat16 within one bf16 rounding step,
     2^-7*|p| + 1e-3*max|p| (the output is rounded to bf16 after float32
     sums taken in another order), and in float32 within 1e-4 + 1e-4*|p|;
   - the tile subm conv on the tile states, masks and plans of conv1 (16,
     tz 8), conv2 (32, tz 4), conv3 (64, tz 2) and conv4 (128, tz 6) of the
     same frame on the tile engine with every stage on tiles, at
     ``utils.config.TILE_FRAME_BUDGETS``, with the same tolerances, and on
     conv1's plan at the reference's default window of 256 tiles, which
     misses targets: the kernel leaves out exactly the taps the plan drops;
   and times kernel, plain version and, for the plane and tile convs, the
   bf16 cuDNN ``F.conv3d`` on the densified grid (a yardstick the port never
   calls);
3. main path, window engine: the flagship KD_VoxelNet + S2D_RPN at full
   width, random weights from a seeded generator, through ``build_detector
   -> forward -> predict`` on 3 warm-up and 8 timed frames (median, min and
   max printed): 6 window-pass launches a frame, residual rows within
   budget, finite maps and boxes;
4. main path, plane engine: the same with the reference bench's override
   ``engine="plane"`` at ``utils.config.FRAME_BUDGETS`` (this frame's sets
   outgrow the reference's default plane and chunk budgets;
   ``tests/test_torch_plane_sets.py`` counts them): 6 window-pass and 12
   plane launches a frame, zero ``plane_drop``, ``planek_miss``,
   ``plane_chunk_drop`` and ``down_drop``;
5. main path, tile engine: the same with the reference bench's override
   ``engine="tile", tile_backend="pallas"`` (``dense_from_stage`` 2) at
   ``TILE_FRAME_BUDGETS``: 9 tile launches a frame and none of the other
   kernels, zero ``conv1_tile_drop``, ``tilek_miss`` and ``down_drop``;
6. agreement: the tiny distillation model on the card against the same model
   on the CPU (plain versions only), window, plane and tile engines.

TF32 is switched off for cuDNN and matmuls in phases 2 and 6, which compare
against float32 plain versions; phases 3 to 5 run at PyTorch's defaults
(TF32 on in cuDNN convs, off in matmuls). With TF32 off cuDNN picks an FFT
algorithm for the neck's 3x3 convs that costs ~200 ms a frame on an H100
(``sparse2dense_tpu_torch/tools/profile_flagship.py``). The second-to-last
lines are a JSON record of the kernels and the card's ``nvidia-smi`` name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
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
PLANE_STAGES = (("conv2", 32), ("conv3", 64), ("conv4", 128))
# (stage, channels, launches a frame on the tile main path, dense_from_stage 2)
TILE_STAGES = (("conv1", 16, 5), ("conv2", 32, 4), ("conv3", 64, 0), ("conv4", 128, 0))
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
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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

    from sparse2dense_tpu_torch.ops import window_conv as WC
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid

    vfe = (batch["voxels"].sum(-2) / batch["num_points"].clamp(min=1)[..., None])[0]
    feats5, coords, lin = WC.sort_rows(vfe, batch["coordinates"][0], grid)
    subm = WC.make_subm_plan_presorted(lin, coords, grid, window=384)
    valid = (lin < WC.MISS)[:, None]
    feats16 = torch.randn(lin.shape[0], 16, device="cuda", generator=gen) * valid

    def strided(stride, pad, ksize, budget):
        g_out = conv_out_grid(grid, stride, pad, ksize)
        oc, ol = WC.downsample_active_set_yxz(coords, coords[:, 0] >= 0, grid, g_out,
                                              stride, pad, ksize, budget)
        return WC.make_strided_plan(lin, ol, oc, grid, g_out, stride, pad, ksize,
                                    window=384, resid_budget=16384)

    cases = [  # (name, plan, features, cin, cout, ksize, launches per frame)
        ("conv_input 5->16", subm, feats5, 5, 16, (3, 3, 3), 1),
        ("conv1 16->16", subm, feats16, 16, 16, (3, 3, 3), 4),
        ("conv2_down 16->32", strided((2, 2, 2), (1, 1, 1), (3, 3, 3), 320000),
         feats16, 16, 32, (3, 3, 3), 1),
        ("z-only (3,1,1) 16->16", strided((2, 1, 1), (0, 0, 0), (3, 1, 1), 300000),
         feats16, 16, 16, (3, 1, 1), 0),
    ]
    rows = []
    for name, plan, f, cin, cout, ksize, per_frame in cases:
        w = torch.randn((cout, cin) + ksize, device="cuda", generator=gen) * 0.2
        wd = WC.taps_zyx_to_dyx(w).to(torch.bfloat16)
        fb = f.to(torch.bfloat16).contiguous()
        got = WK.window_pass_cuda(fb, plan, wd, ksize)
        want = WC.window_pass_plain(fb.float(), plan, wd.float())
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > TOL_ABS + TOL_REL * want.abs()).sum())
        ms = cuda_ms(lambda: WK.window_pass_cuda(fb, plan, wd, ksize), reps=20)
        plain_ms = cuda_ms(lambda: WC.window_pass_plain(fb.float(), plan, wd.float()),
                           reps=3, warmup=1)
        v_in, vo, nb = plan.lin.shape[0], plan.out_lin.shape[0], plan.ws.shape[0]
        nbytes = (v_in * cin * 2 + v_in * 4 + nb * 128 * 3 * 4 + nb * 3 * 4 + 9 * 3 * 4
                  + 27 * cin * cout * 2 + vo * cout * 4)
        hits = _hits(plan, ksize)
        flops = 2.0 * hits * cin * cout
        bound_ms, bound_by = bound(nbytes, flops)
        row = dict(kernel="window_pass", case=name, v_in=v_in, v_out=vo,
                   n_resid=int(plan.n_resid), hits=hits, max_abs_err=float(err.max()),
                   n_bad=bad, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes,
                   flops=flops, bound_by=bound_by, library_ms=None, per_frame=per_frame)
        print("[kernels] " + json.dumps(row), flush=True)
        if bad:
            raise AssertionError(f"{name}: {bad} outputs beyond {TOL_ABS} + {TOL_REL}*|p|")
        if int(plan.n_resid) > plan.resid_rows.shape[0]:
            raise AssertionError(f"{name}: residual rows over budget")
        rows.append(row)
    return rows


def _plane_stage_data(batch, model):
    """(state, mask, sets, grid, plan) of conv2..conv4 of the plane flagship
    frame: the stage outputs of one backbone forward, with their plans."""
    import torch

    from sparse2dense_tpu_torch.ops import plane_conv as PK

    bb = model.backbone
    with torch.inference_mode():
        feats = model.reader(batch["voxels"], batch["num_points"])
        _, multi_scale, _ = bb(feats, batch["coordinates"])
    out = []
    for k, (name, _) in enumerate(PLANE_STAGES):
        (state, mask, sets), grid = multi_scale[name]
        plan = PK.make_plane_plan_batched(sets, PK.t1p_of(bb.plane_budgets[k]),
                                          *bb.plane_wins[k])
        out.append((state.clone(), mask.clone(), sets, grid, plan))
    return out


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


def _plane_rows(stages, gen):
    """Plane subm kernel against its plain version at conv2..conv4."""
    import torch
    import torch.nn.functional as F

    from sparse2dense_tpu_torch.ops import plane_conv as PK
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK

    rows = []
    # the three flagship shapes, and C = 16 (built, not on the main path) on
    # conv2's plan with a random masked state
    state2, mask2 = stages[0][:2]
    state16 = (torch.randn((state2.shape[0], 16, 16), device="cuda", generator=gen)
               * mask2[..., None]).reshape(-1, 256).to(state2.dtype)
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


def _tile_stage_data(batch, model):
    """(state, mask, sets, grid, plan) of conv1..conv4 of the tile flagship
    frame with every stage on tiles: the stage outputs of one backbone
    forward, in the tile state layout, with their plans. conv1 and conv2 are
    the same computation as on the main path (dense_from_stage 2)."""
    import torch

    from sparse2dense_tpu_torch.ops import tile_kernel as TKK

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


def _tile_rows(stages, gen):
    """Tile subm kernel against its plain version at conv1..conv4, and on
    conv1's plan at the reference's default window (misses)."""
    import torch
    import torch.nn.functional as F

    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import tile_kernel as TKK
    from sparse2dense_tpu_torch.ops import tile_planes as TP

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


def phase_kernels():
    """Both kernels against their plain versions at the flagship's data;
    returns per-case rows."""
    import torch

    from sparse2dense_tpu_torch.models.builder import sparse_shape_from_voxel_cfg
    from sparse2dense_tpu_torch.ops import cuda_build
    from sparse2dense_tpu_torch.ops import plane_kernel as PKK
    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import window_kernel as WK
    from sparse2dense_tpu_torch.utils.config import FRAME_BUDGETS, TILE_FRAME_BUDGETS

    t0 = time.perf_counter()
    logs = cuda_build.build_all([(WK.SOURCE, WK.LIBRARY), (PKK.SOURCE, PKK.LIBRARY),
                                 (TBK.SOURCE, TBK.LIBRARY)])
    print(f"[kernels] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s\n" + "\n".join(
        "  " + line for log in logs.values() for line in log.splitlines()
        if "registers" in line or "smem" in line or "spill" in line), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg, batch, model = _flagship("plane", FRAME_BUDGETS)
    rows = _window_rows(batch, sparse_shape_from_voxel_cfg(cfg["voxel_generator"]), gen)
    stages = _plane_stage_data(batch, model)
    del model
    rows += _plane_rows(stages, gen)
    del stages
    torch.cuda.empty_cache()
    _, _, model = _flagship("tile", TILE_FRAME_BUDGETS, dense_from_stage=99)
    stages = _tile_stage_data(batch, model)
    del model
    rows += _tile_rows(stages, gen)
    return rows


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
    return worst


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
    from sparse2dense_tpu_torch.utils.config import FRAME_BUDGETS, TILE_FRAME_BUDGETS

    window = phase_main_path("window")
    plane = phase_main_path("plane", budgets=FRAME_BUDGETS)
    tile = phase_main_path("tile", budgets=TILE_FRAME_BUDGETS)
    with no_tf32():
        phase_agreement()

    wrows, prows, trows = ([r for r in rows if r["kernel"] == k]
                           for k in ("window_pass", "plane_subm", "tile_subm"))
    record = {"kernels": [
        _record("window_pass", "sparse2dense_tpu_torch/csrc/window_pass.cu",
                "sparse2dense_tpu/ops/pallas/window_kernel.py:69",
                window["launches"]["window_pass"], wrows),
        _record("plane_subm", "sparse2dense_tpu_torch/csrc/plane_subm.cu",
                "sparse2dense_tpu/ops/pallas/plane_block_kernel.py:131",
                plane["launches"]["plane_subm"], prows),
        _record("tile_subm", "sparse2dense_tpu_torch/csrc/tile_subm.cu",
                "sparse2dense_tpu/ops/pallas/tile_block_kernel.py:156",
                tile["launches"]["tile_subm"], trows),
    ]}
    for rec, res in zip(record["kernels"], (window, plane, tile)):
        print(f"[main] {rec['name']} share of the {res['engine']} frame: {rec['ms']:.3f} ms "
              f"of {res['frame_ms_median']:.1f} ms = {rec['ms'] / res['frame_ms_median']:.2%}",
              flush=True)
    for res in (window, plane, tile):
        print(f"[main] {res['engine']} engine frame: median {res['frame_ms_median']:.1f} ms, "
              f"min {res['frame_ms_min']:.1f}, max {res['frame_ms_max']:.1f} over "
              f"{len(res['frame_ms'])} frames", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
