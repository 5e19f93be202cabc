"""The flagship teacher-student training step on one NVIDIA GPU: where its
time and memory go.

    python3 -m sparse2dense_tpu_torch.tools.profile_train_step [--batch 1]
        [--warmup 2] [--steps 4] [--profile]

Builds the flagship's VoxelNet teacher and KD_VoxelNet + S2D_RPN student
(``engine="window", dense_from_stage=1``, bf16 dense stages; seeded random
weights: the recipe's teacher checkpoint is not in the repository), a
training batch of ``--batch`` synthetic frames (the bench's frame: 170k
points, 32 objects, 150k voxels, seeds 0, 1, ...; with the CenterHead
targets and the distillation streams), and runs ``TS_Trainer.step`` at
PyTorch's defaults. Prints one JSON line: each step's stages (teacher
forward, student forward + losses, backward, optimizer; the device
synchronised at each boundary) and window-pass (B1) launches, the medians
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


def train_setup(batch_size: int, total_steps: int):
    """(batch, trainer) of the flagship on the card."""
    from ..models import build_detector
    from ..solver.optim import OneCycleAdam
    from ..training.synthetic import make_batch
    from ..training.trainer import TS_Trainer
    from ..utils.config import FLAGSHIP, ConfigDict

    cfg = ConfigDict.fromfile(FLAGSHIP)
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
    ms of each stage (device synchronised at the boundaries) and the B1
    launches; and the last step's metrics. Counts B1 launches from 0."""
    from ..ops import window_kernel as WK

    rows, metrics = [], None
    WK.launches = 0
    for _ in range(steps):
        stages, clock = {}, [0.0]

        def mark(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name] = (now - clock[0]) * 1e3
            clock[0] = now

        before = WK.launches
        torch.cuda.synchronize()
        t0 = clock[0] = time.perf_counter()
        metrics = trainer.step(batch, mark)
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3, stages=stages,
                         window_pass_launches=WK.launches - before))
    return rows, metrics


def median(xs):
    return sorted(xs)[len(xs) // 2]


def summary(rows):
    """Medians of the step and of each stage over ``rows``."""
    return dict(step_ms=median([r["step_ms"] for r in rows]),
                stages_ms={s: median([r["stages"][s] for r in rows]) for s in STAGES})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    batch, trainer = train_setup(args.batch, args.warmup + args.steps + args.profile)
    torch.cuda.reset_peak_memory_stats()
    rows, metrics = run_steps(trainer, batch, args.warmup + args.steps)
    print(json.dumps(dict(gpu=smi, batch=args.batch, **summary(rows[args.warmup:]),
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                          steps=rows, metrics={k: float(v) for k, v in metrics.items()})),
          flush=True)
    if args.profile:
        print(json.dumps({"device": device_trace(lambda: trainer.step(batch))}), flush=True)


if __name__ == "__main__":
    main()
