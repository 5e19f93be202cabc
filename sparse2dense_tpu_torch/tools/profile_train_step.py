"""The flagship teacher-student training step on one NVIDIA GPU: where its
time and memory go.

    python3 -m sparse2dense_tpu_torch.tools.profile_train_step [--batch 1]
        [--warmup 2] [--steps 4] [--no-remat] [--profile] [--config PATH]
        [--engine window|plane|tile|gather] [--dense-from-stage N]

Builds the flagship's VoxelNet teacher and KD_VoxelNet + S2D_RPN student,
or the teacher and student of the recipe config ``--config`` names (such as
the SECOND one, ``configs/waymo_second_3x_distill_interval_5.py``)
(``engine="window", dense_from_stage=1``, bf16 dense stages; seeded random
weights: the recipe's teacher checkpoint is not in the repository), with
``--engine`` and ``--dense-from-stage`` applied to teacher and student alike
(``--engine plane`` at ``utils.config.FRAME_BUDGETS``, ``--engine tile`` at
``TILE_FRAME_BUDGETS`` with ``tile_backend="pallas"`` and, unless given,
the reference's ``dense_from_stage`` 2, the window engine's
``--dense-from-stage 2`` at ``DFS2_FRAME_SETTINGS``: the frame needs them), a
training batch of ``--batch`` synthetic frames (the bench's frame: 170k
points, 32 objects, 150k voxels, seeds 0, 1, ...; with the head's
targets and the distillation streams), and runs ``TS_Trainer.step`` at
PyTorch's defaults, the student's dense backbone stages rematerialised
unless ``--no-remat`` is given. Prints one JSON line: each step's stages
(teacher forward, student forward + losses, backward, optimizer; the device
synchronised at each boundary), the peak memory of each stage (the peak
counter reset at each boundary) and window-pass (B1), plane-conv (B2) and
tile-conv (B3) launches, the medians
of the timed steps, the last step's metrics and the peak memory. With
``--profile``, a second line: a torch.profiler trace of one step (device
busy time, idle share, launches, the kernels with the most time).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .profile_flagship import device_trace

STAGES = ("teacher_forward", "student_forward", "backward", "optimizer")
FRAME = dict(max_voxels=150000, n_points=170000, n_obj=32)


def engine_settings(engine: str = "window", dense_from_stage=None) -> dict:
    """Backbone overrides of a training run on ``engine`` (the recipe's own
    for "window" with no ``dense_from_stage``): the reference bench's
    override, for the plane engine at ``FRAME_BUDGETS``, for the tile engine
    (``tile_backend="pallas"``, which trains as "xla" does) at
    ``TILE_FRAME_BUDGETS`` and the reference's ``dense_from_stage`` 2 unless
    one is given, for the window engine at ``dense_from_stage=2`` with
    ``DFS2_FRAME_SETTINGS`` (the bench's frame needs these budgets)."""
    from ..utils.config import DFS2_FRAME_SETTINGS, FRAME_BUDGETS, TILE_FRAME_BUDGETS

    out = {} if engine == "window" else dict(engine=engine)
    if engine == "plane":
        out.update(FRAME_BUDGETS)
    if engine == "tile":
        out.update(TILE_FRAME_BUDGETS, tile_backend="pallas", dense_from_stage=2)
    if dense_from_stage is not None:
        out["dense_from_stage"] = dense_from_stage
    if engine == "window" and dense_from_stage == 2:
        out.update(DFS2_FRAME_SETTINGS)
    return out


def train_setup(batch_size: int, total_steps: int, remat: bool = True, config: str = None,
                backbone: dict = None):
    """(batch, trainer) of the flagship (or of the recipe config at
    ``config``) on the card; ``remat`` is the student backbone's
    ``remat_dense``; ``backbone`` (``engine_settings``) updates teacher and
    student backbones alike."""
    from ..models import build_detector
    from ..solver.optim import OneCycleAdam
    from ..training.synthetic import make_batch
    from ..training.trainer import TS_Trainer
    from ..utils.config import FLAGSHIP, ConfigDict

    cfg = ConfigDict.fromfile(config or FLAGSHIP)
    for key in ("model", "S_model"):
        cfg[key]["backbone"].update(backbone or {})
    cfg.S_model.backbone["remat_dense"] = remat
    kw = dict(test_cfg=cfg.test_cfg, voxel_generator=cfg.voxel_generator, device="cuda")
    teacher = build_detector(cfg.model, generator=torch.Generator().manual_seed(0), **kw)
    student = build_detector(cfg.S_model, generator=torch.Generator().manual_seed(1), **kw)
    batch = make_batch(cfg, batch_size, device="cuda", with_targets=True, distillation=True,
                       **FRAME)
    optimizer = OneCycleAdam(student.parameters(), cfg.optimizer, cfg.lr_config, total_steps,
                             cfg.optimizer_config["grad_clip"])
    return batch, TS_Trainer(teacher, student, optimizer, cfg.model)


def run_steps(trainer, batch, steps: int):
    """``steps`` calls of ``trainer.step``: per step its host-clock ms, the
    ms and the peak GiB of each stage (device synchronised, peak counter
    read and reset at the boundaries), the step's peak and the B1, B2 and
    B3 launches; and the last step's metrics. Counts launches from 0. A
    step that runs out of device memory raises with the stages it finished
    (``stages_ms``, ``stages_peak_gb``) and the peak of the one it did not
    (``failed_peak_gb``) on the error."""
    from ..ops import plane_kernel as PKK
    from ..ops import tile_block_kernel as TBK
    from ..ops import window_kernel as WK

    rows, metrics = [], None
    WK.launches = PKK.launches = TBK.launches = 0
    for _ in range(steps):
        stages, peaks, clock = {}, {}, [0.0]

        def mark(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name] = (now - clock[0]) * 1e3
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            clock[0] = now

        before, before2, before3 = WK.launches, PKK.launches, TBK.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = clock[0] = time.perf_counter()
        try:
            metrics = trainer.step(batch, mark)
        except torch.cuda.OutOfMemoryError as e:
            # what the step got through, for the caller that reports it
            e.stages_ms, e.stages_peak_gb = stages, peaks
            e.failed_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            raise
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3, stages=stages,
                         peak_gb=peaks, step_peak_gb=max(peaks.values()),
                         window_pass_launches=WK.launches - before,
                         plane_subm_launches=PKK.launches - before2,
                         tile_subm_launches=TBK.launches - before3))
    return rows, metrics


def median(xs):
    return sorted(xs)[len(xs) // 2]


def summary(rows):
    """Medians of the step and of each stage over ``rows``; the peak GiB of
    each stage and of the step, the most over ``rows``."""
    return dict(step_ms=median([r["step_ms"] for r in rows]),
                stages_ms={s: median([r["stages"][s] for r in rows]) for s in STAGES},
                stages_peak_gb={s: max(r["peak_gb"][s] for r in rows) for s in STAGES},
                peak_mem_gb=max(r["step_peak_gb"] for r in rows))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--no-remat", dest="remat", action="store_false",
                    help="keep the dense stages' activations (remat_dense=False)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--config", default=None,
                    help="a recipe config whose teacher and student train (default: the "
                         "flagship's)")
    ap.add_argument("--engine", default="window", choices=("window", "plane", "tile", "gather"))
    ap.add_argument("--dense-from-stage", dest="dfs", type=int, default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    backbone = engine_settings(args.engine, args.dfs)
    batch, trainer = train_setup(args.batch, args.warmup + args.steps + args.profile,
                                 args.remat, args.config, backbone)
    rows, metrics = run_steps(trainer, batch, args.warmup + args.steps)
    print(json.dumps(dict(gpu=smi, config=args.config, backbone=backbone, batch=args.batch,
                          remat=args.remat,
                          **summary(rows[args.warmup:]),
                          peak_all_steps_gb=max(r["step_peak_gb"] for r in rows),
                          steps=rows, metrics={k: float(v) for k, v in metrics.items()})),
          flush=True)
    if args.profile:
        print(json.dumps({"device": device_trace(lambda: trainer.step(batch))}), flush=True)


if __name__ == "__main__":
    main()
