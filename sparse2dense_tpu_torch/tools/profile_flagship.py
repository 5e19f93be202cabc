"""Where the time of a flagship frame goes, on one NVIDIA GPU.

    python3 -m sparse2dense_tpu_torch.tools.profile_flagship [--frames 3] [--no-tf32]
        [--engine window|plane|tile|gather] [--dense-from-stage N] [--config PATH]

Runs the flagship KD_VoxelNet + S2D_RPN (random weights from a seeded
generator, heatmap bias -6 as in chip_smoke.py), or the student of the
recipe config ``--config`` names (such as the SECOND one,
``sparse2dense_tpu_torch/configs/waymo_second_3x_distill_interval_5.py``:
window and gather engines; or a pillar one: the distillation config's
KD_PointPillars, the dense config's PointPillars, on the same cloud
voxelized to at most the recipe's 60,000 test pillars), on a 150k-voxel
synthetic Waymo frame, on the
window engine (the config as it is), the gather engine (the engine set
alone), the plane engine (the reference bench's override, with the plane
and tile budgets ``utils.config.FRAME_BUDGETS`` that this frame needs to
drop nothing) or the tile engine (the override ``engine="tile",
tile_backend="pallas"``, with ``utils.config.TILE_FRAME_BUDGETS``);
``--dense-from-stage`` sets the backbone's (the window engine's 2, 3 and 99
with the frame settings ``profile_train_step.engine_settings`` gives:
``utils.config.DFS2_FRAME_SETTINGS`` and the others), and
prints one JSON line per measurement:

- ``stages``: per-module wall time (ms, median over the frames) of the
  backbone's and the neck's layers (on the tile engine: conv_input,
  conv1_0, conv1_1 and conv2_0, conv2_1 are fused tile convs, conv2_down
  and conv3_down chunk-layout strided convs), the head and predict, with
  the device synchronised at every module boundary; ``glue`` is what lies
  between the modules (row sort, window plans, densify, BEV reshape; with
  the plane engine: plane and chunk sets, plane plans, layout permutations;
  with the tile engine: tile sets, tile state, block plans, layouts); a
  pillar model reports its reader, backbone (the scatter, with S2D for the
  student), neck (RPN) and head whole;
- ``device``: a torch.profiler trace of one frame: device-busy time (sum of
  GPU kernel time), the frame's wall time, the idle share, and the ten GPU
  kernels with the most time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch


def _flagship(engine: str, config: str = None, dense_from_stage: int = None):
    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import (FLAGSHIP, FRAME_BUDGETS,
                                                     TILE_FRAME_BUDGETS, flagship,
                                                     frame_voxels)

    budgets = {"plane": FRAME_BUDGETS, "tile": TILE_FRAME_BUDGETS}.get(engine)
    cfg = flagship(engine, budgets, config or FLAGSHIP)
    if dense_from_stage is not None:
        from .profile_train_step import engine_settings

        cfg["S_model"]["backbone"].update(engine_settings(engine, dense_from_stage))
    if cfg["S_model"]["bbox_head"]["type"] == "CenterHead":
        cfg["S_model"]["bbox_head"]["init_bias"] = -6.0
    model = build_detector(cfg["S_model"], test_cfg=cfg["test_cfg"],
                           voxel_generator=cfg["voxel_generator"], device="cuda",
                           generator=torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 1, max_voxels=frame_voxels(cfg, train=False), n_points=170000,
                       n_obj=32, device="cuda")
    return model, batch


def _frame(model, batch):
    with torch.inference_mode():
        return model.predict(model(batch), example=batch)


def stage_times(model, batch, frames: int):
    """Median wall ms per module, device synchronised at module boundaries."""
    if type(model.backbone).__name__.startswith("PointPillarsScatter"):
        mods = dict(backbone=model.backbone, neck=model.neck)
    else:
        mods = {f"{part}.{n}": m for part in ("backbone", "neck")
                for n, m in getattr(model, part).named_children()}
    mods.update(reader=model.reader, head=model.bbox_head)
    spans = defaultdict(list)
    start = {}

    def pre(name):
        def hook(*_):
            torch.cuda.synchronize()
            start[name] = time.perf_counter()
        return hook

    def post(name):
        def hook(*_):
            torch.cuda.synchronize()
            spans[name].append((time.perf_counter() - start[name]) * 1e3)
        return hook

    handles = [h for n, m in mods.items() for h in (m.register_forward_pre_hook(pre(n)),
                                                  m.register_forward_hook(post(n)))]
    totals, predicts = [], []
    try:
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = model(batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                model.predict(out, example=batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            totals.append((t2 - t0) * 1e3)
            predicts.append((t2 - t1) * 1e3)
    finally:
        for h in handles:
            h.remove()

    def med(x):
        return sorted(x)[len(x) // 2]

    res = {n: med(v) for n, v in spans.items()}
    res["predict"] = med(predicts)
    res["frame"] = med(totals)
    res["glue"] = res["frame"] - sum(v for k, v in res.items() if k != "frame")
    return res


_TRACER_OVERHEAD = {"Command Buffer Full", "Buffer Flush", "Activity Buffer Request"}


def device_profile(model, batch):
    return device_trace(lambda: _frame(model, batch))


def device_trace(fn):
    """A torch.profiler trace of one call of ``fn``: device-busy ms, wall
    ms, idle share, launches and the GPU kernels with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # GPU kernels and copies only: not the CPU-side aten ops (their device
    # time double-counts their kernels) nor the tracer's own overhead records
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("aten::")
               and e.key not in _TRACER_OVERHEAD]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:100], ms=e.self_device_time_total / 1e3, calls=e.count)
                     for e in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--engine", choices=("window", "plane", "tile", "gather"), default="window")
    ap.add_argument("--config", default=None,
                    help="a recipe config whose student runs (default: the flagship's)")
    ap.add_argument("--dense-from-stage", dest="dfs", type=int, default=None)
    ap.add_argument("--no-tf32", action="store_true",
                    help="full float32 in cuDNN convs (PyTorch's default lets them use "
                         "TF32), as chip_smoke.py's comparison phases run")
    args = ap.parse_args()
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model, batch = _flagship(args.engine, args.config, args.dfs)
    _frame(model, batch)  # warm-up: kernel build, allocator
    print(json.dumps({"gpu": smi, "config": args.config, "engine": args.engine,
                      "dense_from_stage": args.dfs,
                      "tf32": torch.backends.cudnn.allow_tf32,
                      "stages": stage_times(model, batch, args.frames)}), flush=True)
    print(json.dumps({"device": device_profile(model, batch)}), flush=True)


if __name__ == "__main__":
    main()
