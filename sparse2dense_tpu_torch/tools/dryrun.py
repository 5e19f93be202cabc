"""The data-parallel dry run (counterpart of
``__graft_entry__.dryrun_multichip(n)``): n processes on this host train
through the real CLI, then take one distillation step.

    python -m sparse2dense_tpu_torch.tools.dryrun [N] [--device cuda|cpu]
        [--work_dir D]

Spawns N processes (default 2) with torchrun's environment: gloo on the
CPU (``--device cpu``); on CUDA rank r on ``cuda:r``, through NCCL when
each rank has a card, else through gloo, the cards shared
(``parallel.dist.init_distributed``). Each runs
(1) ``tools/train.py --launcher pytorch`` on ``configs/tests/pp_tiny.py``
over 2N synthetic frames for one epoch at batch 1 a process, then (2) one
teacher-student step of ``configs/tests/distill_tiny.py`` on its own
synthetic frame (seed = its rank). Each checks that its losses are finite
and that the ranks hold equal parameters after each part, and fails
otherwise; the dry run raises if a process failed.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
from typing import Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PP_TINY = os.path.join(ROOT, "configs", "tests", "pp_tiny.py")
DISTILL_TINY = os.path.join(ROOT, "configs", "tests", "distill_tiny.py")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Data-parallel dry run")
    p.add_argument("n", nargs="?", type=int, default=2, help="processes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--work_dir", default=None)
    return p.parse_args(argv)


def _check(what: str, metrics: dict, gap: float) -> None:
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise RuntimeError(f"{what}: metrics not finite: {bad}")
    if gap != 0.0:
        raise RuntimeError(f"{what}: the ranks' parameters differ by up to {gap}")


def worker(n: int, device: str, work_dir: str) -> None:
    """One rank of the dry run (see the module's docstring)."""
    from ..parallel import dist
    from ..parallel.launch import build_job
    from ..training.synthetic import make_batch
    from ..utils.config import ConfigDict
    from . import train

    trainer = train.main([PP_TINY, "--launcher", "pytorch", "--device", device,
                          "--work_dir", os.path.join(work_dir, "train"),
                          "--synthetic", str(2 * n), "--epochs", "1", "--batch_size", "1",
                          "--max_voxels", "128"])
    rank, dev = dist.rank(), dist.rank_device(device)
    if trainer.global_iter < 1:
        raise RuntimeError("the train CLI took no step")
    _check("train CLI", {k: v[-1] for k, v in trainer.log_buffer.val_history.items()},
           dist.max_param_gap(trainer.model.parameters()))

    student, step = build_job(dict(config=DISTILL_TINY, kind="ts"), dev)
    batch = make_batch(ConfigDict.fromfile(DISTILL_TINY), 1, max_voxels=96, n_points=250,
                       n_obj=2, seed=rank, device=dev, with_targets=True, distillation=True)
    metrics = step(batch)
    _check("distill step", metrics, dist.max_param_gap(student.parameters()))
    if dist.is_main():
        print(f"dryrun({n}) on {device}: train CLI {trainer.global_iter} steps a rank; "
              f"distill step loss {float(metrics['loss']):.4f}, sparse2dense "
              f"{float(metrics['sparse2dense_loss']):.4f}; parameters equal across ranks",
              flush=True)
    dist.close_distributed()


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..parallel.launch import spawn

    args = parse_args(argv)
    threads = 1 if args.device == "cpu" else None
    if args.work_dir:
        spawn(worker, args.n, (args.n, args.device, args.work_dir), threads=threads)
        return
    with tempfile.TemporaryDirectory() as work_dir:
        spawn(worker, args.n, (args.n, args.device, work_dir), threads=threads)


if __name__ == "__main__":
    main()
