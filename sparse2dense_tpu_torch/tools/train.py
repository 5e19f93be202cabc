"""Training entry point (counterpart of ``sparse2dense_tpu/tools/train.py``;
the reference's tools/train.py:64-155).

    python -m sparse2dense_tpu_torch.tools.train <config.py> [--synthetic N]
        [--work_dir D] [--resume_from CKPT] [--load_from CKPT] [--seed S]
        [--batch_size B] [--max_voxels V] [--epochs E] [--device cuda|cpu]
        [--launcher none|pytorch]

    torchrun --nproc_per_node N -m sparse2dense_tpu_torch.tools.train
        <config.py> --launcher pytorch [--device cpu] ...

The reference's semantics: with ``cfg.distillation`` the teacher is built
from ``cfg.model`` (its weights from ``--load_from`` or ``cfg.load_from``,
through ``merge_params``) and the student from ``cfg.S_model``, and training
runs the teacher-student step (``TS_Trainer``); otherwise a plain detector
trains from ``cfg.S_model`` (``cfg.model`` for a recipe without one, such as
the nuScenes recipes). The batch is ``cfg.data.samples_per_gpu``
unless ``--batch_size`` is given: a process's batch, the JAX CLI's
per-device batch; the one-cycle schedule covers the epoch's steps (of one
process's shard) times the epochs. The frames come from ``cfg.data.train``
(``data/loader.py``: ``build_dataset`` and ``InputPipeline`` with
``cfg.data.workers_per_gpu`` worker processes, shuffled by ``--seed``);
``--synthetic N`` trains on N synthetic frames instead (``make_batch``
with the head's targets, CenterHead or MultiGroupHead,
seeds 0, 1, ... a batch, rank r of W taking seeds r, W + r, ...; the same
batches every epoch). The distillation
branch follows the teacher's backbone (``distill.branch_of``): "centerpoint"
for the flagship's recipe, "second" for SECOND's. Checkpoints go to ``--work_dir``, else
``cfg.work_dir``, else ``work_dirs/<config name>`` (the reference's layout):
``epoch_<n>`` each ``checkpoint_config.interval`` epochs and the ``latest``
symlink.

Runs on CUDA unless ``--device cpu`` is given. ``--launcher pytorch``
trains data-parallel in torchrun's processes (``parallel/dist.py``: rank r
on ``cuda:LOCAL_RANK`` unless ``--device`` names one; NCCL where each rank
has a card, gloo on the CPU and where ranks share one; each rank takes shard r of the
frames, SyncBN, global-batch losses, summed gradients); without torchrun's
environment it raises. Only rank 0 logs and writes checkpoints. Left out:
the JAX CLI's ``--no_mesh`` (there is no device mesh) and ``--ts_step``
(the eager step already runs the frozen teacher under ``no_grad`` before
the student's graph, the JAX CLI's split step).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--load_from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_voxels", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic frames instead of cfg.data")
    p.add_argument("--launcher", default="none", choices=["none", "pytorch"],
                   help="'pytorch': data-parallel in torchrun's processes")
    p.add_argument("--device", default=None,
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    return p.parse_args(argv)


class SyntheticLoader:
    """``max(n // (batch_size * world), 1)`` batches of ``make_batch`` (seed
    ``i * world + rank`` for the i-th), the JAX CLI's synthetic dataset
    split over ``world`` processes."""

    def __init__(self, cfg, n: int, batch_size: int, max_voxels: int, distillation: bool,
                 device, rank: int = 0, world: int = 1):
        self.cfg, self.batch_size, self.max_voxels = cfg, batch_size, max_voxels
        self.distillation, self.device = distillation, device
        self.rank, self.world = rank, world
        self.n = max(n // (batch_size * world), 1)

    def __len__(self):
        return self.n

    def set_epoch(self, e: int):
        """Every epoch takes the same batches."""

    def __iter__(self):
        from ..training.synthetic import make_batch

        for i in range(self.n):
            yield make_batch(self.cfg, self.batch_size, max_voxels=self.max_voxels,
                             seed=i * self.world + self.rank,
                             device=self.device, with_targets=True,
                             distillation=self.distillation)


def main(argv: Optional[Sequence[str]] = None):
    """Train as the command line says; returns the trainer."""
    args = parse_args(argv)
    from ..parallel.dist import broadcast_state, init_distributed, rank_device

    rank, world = init_distributed(args.launcher, args.device)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger("sparse2dense_tpu_torch")

    from ..models import build_detector
    from ..solver.optim import OneCycleAdam
    from ..training.checkpoint import load_checkpoint, merge_params
    from ..training.hooks import build_hooks
    from ..training.trainer import TS_Trainer, Trainer
    from ..utils.config import ConfigDict, detector_cfg

    device = rank_device(args.device)
    cfg = ConfigDict.fromfile(args.config)
    name = os.path.splitext(os.path.basename(args.config))[0]
    work_dir = args.work_dir or cfg.get("work_dir") or os.path.join("work_dirs", name)
    os.makedirs(work_dir, exist_ok=True)
    distillation = bool(cfg.get("distillation", False))
    total_epochs = args.epochs or cfg.total_epochs
    batch_size = args.batch_size or cfg.get("data", {}).get("samples_per_gpu", 4)
    max_voxels = args.max_voxels or _default_max_voxels(cfg)

    if args.synthetic:
        train_loader = SyntheticLoader(cfg, args.synthetic, batch_size, max_voxels,
                                       distillation, device, rank, world)
    else:
        from ..data.loader import InputPipeline, build_dataset

        workers = int(cfg.data.get("workers_per_gpu", 4) or 0)
        train_loader = InputPipeline(build_dataset(cfg.data["train"]), batch_size, max_voxels,
                                     seed=args.seed, num_workers=workers, device=device,
                                     num_shards=world, shard_id=rank)
    epoch_len = len(train_loader)
    kw = dict(test_cfg=cfg.test_cfg, voxel_generator=cfg.get("voxel_generator"),
              device=device)
    student = build_detector(detector_cfg(cfg), generator=torch.Generator().manual_seed(args.seed),
                             **kw)
    broadcast_state(student)
    optimizer = OneCycleAdam(student.parameters(), cfg.optimizer, cfg.lr_config,
                             max(epoch_len * total_epochs, 1),
                             cfg.optimizer_config.get("grad_clip"))
    with open(args.config) as f:
        meta = {"config": f.read(), "classes": list(cfg.get("class_names", []))}
    hooks = build_hooks(cfg.get("log_config"), cfg.get("checkpoint_config") or {"interval": 1},
                        work_dir=work_dir)
    common = dict(work_dir=work_dir, hooks=hooks, logger=logger, meta=meta)
    if distillation:
        teacher = build_detector(cfg.model,
                                 generator=torch.Generator().manual_seed(args.seed + 9), **kw)
        load_from = args.load_from or cfg.get("load_from")
        if load_from:
            restored, _ = load_checkpoint(load_from)
            teacher.load_state_dict(merge_params(teacher.state_dict(), restored["model"],
                                                 logger))
            logger.info(f"loaded teacher checkpoint {load_from}")
        broadcast_state(teacher)
        trainer = TS_Trainer(teacher, student, optimizer, teacher_cfg=dict(cfg.model), **common)
    else:
        trainer = Trainer(student, optimizer, **common)

    resume_from = args.resume_from or cfg.get("resume_from")
    if resume_from:
        trainer.resume(resume_from)
    logger.info(f"start training: {total_epochs} epochs x {epoch_len} iters of batch "
                f"{batch_size} a process x {world} processes, distillation={distillation}, "
                f"on {device}")
    trainer.run(train_loader, total_epochs)
    logger.info("training finished")
    return trainer


def _default_max_voxels(cfg):
    mv = cfg.voxel_generator["max_voxel_num"]
    return mv[0] if isinstance(mv, (list, tuple)) else mv


if __name__ == "__main__":
    from ..parallel.dist import close_distributed

    main()
    close_distributed()
