"""Evaluation entry point (counterpart of ``sparse2dense_tpu/tools/test.py``;
the shape of the reference's tools/dist_test.py, docs/WAYMO.md:103-121).

    python -m sparse2dense_tpu_torch.tools.test <config.py> --checkpoint CKPT
        [--work_dir D] [--batch_size B] [--max_voxels V] [--speed_test]
        [--testset] [--device cuda|cpu] [--launcher none|pytorch]

Builds ``cfg.S_model`` (``cfg.model`` for a recipe without one, such as
the nuScenes recipes; seeded weights, then the model of ``--checkpoint``,
a checkpoint of the port's ``tools/train.py``, through ``merge_params``),
the ``cfg.data.val`` loader (``cfg.data.test`` with ``--testset``) at the
voxel generator's test budget, predicts every frame
(``training.trainer.predict``), merges the processes' detections
(``gather_detections``) and runs ``dataset.evaluation``: the detections'
file under ``--work_dir`` and the local BEV mAP. ``--speed_test`` logs the
latency of a batch's forward and predict, the first 2 batches skipped.
Runs on CUDA unless ``--device cpu`` is given. ``--launcher pytorch``
evaluates in torchrun's processes (as ``tools/train.py``): rank r predicts
shard r of the frames (the shards wrap to equal length) and rank 0 merges
the ranks' detections (the first of a duplicate frame kept) and evaluates;
the other ranks return None. Without torchrun's environment it raises.
``--speed_test`` times each process's own batches of ``--batch_size`` (1
by default: one frame on one card, as the JAX CLI).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Evaluate a detector")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--work_dir", default="./work_dir")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_voxels", type=int, default=None)
    p.add_argument("--speed_test", action="store_true")
    p.add_argument("--testset", action="store_true")
    p.add_argument("--launcher", default="none", choices=["none", "pytorch"],
                   help="'pytorch': shard the frames over torchrun's processes")
    p.add_argument("--device", default=None,
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Evaluate as the command line says; returns (detections, the
    evaluation's result, the timed batches' seconds); on a rank other than
    0, (None, None, its timed batches' seconds)."""
    args = parse_args(argv)
    from ..parallel.dist import init_distributed, rank_device

    rank, world = init_distributed(args.launcher, args.device)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger("sparse2dense_tpu_torch")

    from ..data.loader import InputPipeline, build_dataset
    from ..models import build_detector
    from ..training.checkpoint import load_checkpoint, merge_params
    from ..training.trainer import gather_detections, predict
    from ..utils.config import ConfigDict, detector_cfg

    device = rank_device(args.device)
    cfg = ConfigDict.fromfile(args.config)
    model = build_detector(detector_cfg(cfg), test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.get("voxel_generator"), device=device,
                           generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        state, _ = load_checkpoint(args.checkpoint)
        model.load_state_dict(merge_params(model.state_dict(), state["model"], logger))
        logger.info(f"loaded {args.checkpoint}")
    mv = cfg.voxel_generator["max_voxel_num"]
    max_voxels = args.max_voxels or (mv[1] if isinstance(mv, (list, tuple)) else mv)
    dataset = build_dataset(cfg.data["test" if args.testset else "val"])
    loader = InputPipeline(dataset, args.batch_size, max_voxels, shuffle=False,
                           num_workers=int(cfg.data.get("workers_per_gpu", 4) or 0),
                           device=device, num_shards=world, shard_id=rank, drop_last=False)
    times = []
    detections = predict(model, loader, times=times)
    times = times[2:]   # the first batches pay for the allocator and cuDNN's choices
    if args.speed_test and times:
        ms = 1000 * sum(times) / len(times)
        logger.info(f"inference: {1000 * args.batch_size / ms:.2f} frames/s ({ms:.1f} ms a "
                    f"batch of {args.batch_size}, {len(times)} batches)")
    os.makedirs(args.work_dir, exist_ok=True)
    detections = gather_detections(detections, args.work_dir, logger)
    if detections is None:
        return None, None, times
    result = dataset.evaluation(detections, output_dir=args.work_dir, testset=args.testset)
    logger.info(f"evaluation result: {result[0]}")
    return detections, result, times


if __name__ == "__main__":
    from ..parallel.dist import close_distributed

    main()
    close_distributed()
