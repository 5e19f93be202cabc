"""Trainer and TS_Trainer (counterpart of
``sparse2dense_tpu/training/trainer.py``; the reference's
det3d/torchie/trainer/trainer.py:209-892): the step, the epoch loop, the
hooks, checkpoints and validation (``Trainer.val``: the eval-mode model's
detections over a loader, keyed by frame token, then the dataset's
evaluation). Under data parallelism (``parallel/dist.py``) every rank
steps on the global batch's gradients and logs the global metrics; only
rank 0 writes checkpoints (the other ranks wait for the write) and logs,
and rank 0 merges the ranks' detections (:func:`gather_detections`).

``epoch`` counts the epochs done, ``inner_iter`` is the step's index in its
epoch, ``global_iter`` counts the steps done over the run, and
``log_buffer`` holds every step's scalar metrics for the hooks, as in the
reference."""
from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Callable, Dict, Optional

import torch

from ..parallel.dist import barrier, is_main, rank, world_size
from .checkpoint import load_checkpoint, save_checkpoint
from .distill import branch_of, make_ts_train_step
from .hooks import LogBuffer, build_hooks
from .train_state import Mark, make_train_step


class Trainer:
    """Trains ``model`` with ``optimizer`` (``solver.optim.OneCycleAdam``)
    through ``train_step`` (the plain detector step unless given), writing
    checkpoints under ``work_dir``. ``hooks`` default to ``build_hooks``'
    (timer, epoch checkpoints, text log); ``meta`` (config text, classes)
    goes into every checkpoint."""

    def __init__(self, model, optimizer, train_step: Optional[Callable] = None,
                 work_dir: Optional[str] = None, hooks=None,
                 logger: Optional[logging.Logger] = None, meta: Optional[dict] = None):
        self.model, self.optimizer = model, optimizer
        self.work_dir = work_dir
        self.logger = logger or logging.getLogger("sparse2dense_tpu_torch")
        self.log_buffer = LogBuffer()
        self.hooks = hooks if hooks is not None else build_hooks(work_dir=work_dir)
        self.epoch = 0
        self.inner_iter = 0
        self.global_iter = 0
        self.epoch_length = 0
        self.current_stats: Dict[str, float] = {}
        self.meta = meta or {}
        self._train_step = train_step or make_train_step(model, optimizer)

    def call_hook(self, name: str) -> None:
        for h in self.hooks:
            getattr(h, name)(self)

    def save_checkpoint(self, out_dir: str, name: Optional[str] = None, latest: bool = True,
                        mid_epoch: bool = False) -> str:
        """The model (parameters, BN buffers) and the optimizer (moments,
        step count) as ``<out_dir>/<name>``, ``epoch_<n>`` by default. A
        mid-epoch (preemption) save resumes by restarting the interrupted
        epoch. Rank 0 writes; every rank waits for the write."""
        name = name or f"epoch_{self.epoch + 1}"
        path = os.path.abspath(os.path.join(out_dir, name))
        if is_main():
            meta = dict(self.meta, epoch=self.epoch if mid_epoch else self.epoch + 1,
                        iter=self.global_iter)
            state = {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.state_dict()}
            save_checkpoint(out_dir, name, state, meta=meta, latest=latest)
            self.logger.info(f"saved checkpoint {path}")
        barrier()
        return path

    def resume(self, path: str) -> None:
        """Model, BN buffers, optimizer and schedule position from ``path``,
        then ``epoch`` and ``global_iter`` from its meta (on every rank)."""
        state, meta = load_checkpoint(path)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(meta.get("epoch", 0))
        self.global_iter = int(meta.get("iter", 0))
        self.logger.info(f"resumed from {path}: epoch {self.epoch}, iter {self.global_iter}")

    def step(self, batch, mark: Mark = None) -> Dict:
        """One optimization step; metrics as 0-dim tensors."""
        return self._train_step(batch, mark)

    def train_epoch(self, data_loader) -> None:
        """One pass over ``data_loader`` (batches of ``make_batch``'s
        layout), with the hooks; each step's scalar metrics go to
        ``log_buffer``."""
        self.epoch_length = len(data_loader)
        data_loader.set_epoch(self.epoch)
        self.call_hook("before_train_epoch")
        for i, batch in enumerate(data_loader):
            self.inner_iter = i
            batch = {k: v for k, v in batch.items() if k != "metadata"}
            self.call_hook("before_train_iter")
            self.current_stats["lr"] = float(self.optimizer.lr(self.optimizer.count))
            metrics = self.step(batch)
            self.log_buffer.update({k: float(v) for k, v in metrics.items() if v.dim() == 0})
            self.call_hook("after_train_iter")
            self.global_iter += 1
        self.call_hook("after_train_epoch")
        self.epoch += 1

    def run(self, data_loader, max_epochs: int, val_loader=None, val_dataset=None,
            val_interval: int = 0) -> None:
        """Epochs from ``epoch`` up to ``max_epochs``, between the hooks'
        ``before_run`` and ``after_run``; with a ``val_loader`` and a
        ``val_interval``, :meth:`val` after every ``val_interval``-th epoch
        and the last."""
        self.call_hook("before_run")
        while self.epoch < max_epochs:
            self.train_epoch(data_loader)
            if val_loader is not None and val_interval and (
                    self.epoch % val_interval == 0 or self.epoch == max_epochs):
                self.val(val_loader, val_dataset)
        self.call_hook("after_run")

    def val(self, data_loader, dataset, output_dir: Optional[str] = None):
        """The model's detections over ``data_loader`` (:func:`predict`),
        merged across processes (:func:`gather_detections`), then
        ``dataset.evaluation`` with its files under ``output_dir`` (else
        ``<work_dir>/eval``). On a rank other than 0: None."""
        out_dir = output_dir or os.path.join(self.work_dir, "eval")
        os.makedirs(out_dir, exist_ok=True)
        detections = gather_detections(predict(self.model, data_loader), out_dir, self.logger)
        if detections is None:
            return None
        result = dataset.evaluation(detections, output_dir=out_dir)
        self.logger.info(f"evaluation after epoch {self.epoch}: {result[0]}")
        return result


@torch.no_grad()
def predict(model, data_loader, times: Optional[list] = None) -> Dict[str, dict]:
    """The eval-mode ``model``'s detections over ``data_loader``: token ->
    {"box3d_lidar", "scores", "label_preds"} (NumPy, the valid ones); a
    frame without metadata is keyed ``frame_p{rank}_{n}`` (the reference's
    key, unique over the processes). Under double flip (the model's test
    config) a batch of B frames holds 4B views and the merged output B
    rows: row b is keyed by its group's first view, ``metadata[4 * b]`` (the
    reference keys it by ``metadata[b]``, a view of frame b // 4: at B <= 4
    every row takes frame 0's token and overwrites it). With ``times``, each
    batch's forward and predict seconds (synchronized) are appended."""
    was_training = model.training
    model.eval()
    detections, proc = {}, rank()
    views = 4 if (getattr(model, "test_cfg", None) or {}).get("double_flip", False) else 1
    try:
        for batch in data_loader:
            meta = batch.get("metadata") or []
            batch = {k: v for k, v in batch.items() if k != "metadata"}
            t0 = time.perf_counter()
            out = model.predict(model(batch), example=batch)
            boxes, scores, labels, valid = (out[k].cpu().numpy() for k in (
                "box3d_lidar", "scores", "label_preds", "valid"))
            if times is not None:
                times.append(time.perf_counter() - t0)
            for b in range(boxes.shape[0]):
                m = valid[b]
                m_b = meta[views * b] if views * b < len(meta) else None
                token = m_b["token"] if m_b else f"frame_p{proc}_{len(detections)}"
                detections[token] = {"box3d_lidar": boxes[b][m], "scores": scores[b][m],
                                     "label_preds": labels[b][m]}
    finally:
        model.train(was_training)
    return detections


def gather_detections(detections: dict, out_dir: str,
                      logger: Optional[logging.Logger] = None) -> Optional[dict]:
    """The detections of every process, on rank 0; None on the others. One
    process: the identity. More: every rank writes its detections to
    ``<out_dir>/detections_shard_{rank}.pkl``, all wait, and rank 0 merges
    the shards in rank order, keeping the first of a duplicate token (the
    wrapped tail of the val sampler) and logging how many it dropped."""
    world = world_size()
    if world == 1:
        return detections
    with open(os.path.join(out_dir, f"detections_shard_{rank()}.pkl"), "wb") as f:
        pickle.dump(detections, f)
    barrier()
    if not is_main():
        return None
    merged = {}
    for r in range(world):
        with open(os.path.join(out_dir, f"detections_shard_{r}.pkl"), "rb") as f:
            shard = pickle.load(f)
        overlap = merged.keys() & shard.keys()
        if overlap and logger is not None:
            logger.warning(f"eval merge: {len(overlap)} duplicate tokens from process {r} "
                           "(the wrapped sampler tail); keeping the first")
        for k, v in shard.items():
            merged.setdefault(k, v)
    return merged


class TS_Trainer(Trainer):
    """Teacher-student trainer: the frozen ``teacher`` (eval mode, no
    gradient) distils into ``student``; the branch follows the teacher's
    backbone (``teacher_cfg``). Checkpoints hold the student."""

    def __init__(self, teacher, student, optimizer, teacher_cfg: dict, **kw):
        self.teacher = teacher
        self.branch = branch_of(teacher_cfg)
        super().__init__(student, optimizer,
                         make_ts_train_step(teacher, student, optimizer, self.branch), **kw)
