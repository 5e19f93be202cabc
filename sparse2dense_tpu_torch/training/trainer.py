"""Trainer and TS_Trainer (counterpart of
``sparse2dense_tpu/training/trainer.py``; the reference's
det3d/torchie/trainer/trainer.py:209-892): the step, the epoch loop, the
hooks and checkpoints. Validation and data parallelism come with the data
layer and DDP.

``epoch`` counts the epochs done, ``inner_iter`` is the step's index in its
epoch, ``global_iter`` counts the steps done over the run, and
``log_buffer`` holds every step's scalar metrics for the hooks, as in the
reference."""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

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
        epoch."""
        name = name or f"epoch_{self.epoch + 1}"
        meta = dict(self.meta, epoch=self.epoch if mid_epoch else self.epoch + 1,
                    iter=self.global_iter)
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}
        path = save_checkpoint(out_dir, name, state, meta=meta, latest=latest)
        self.logger.info(f"saved checkpoint {path}")
        return path

    def resume(self, path: str) -> None:
        """Model, BN buffers, optimizer and schedule position from ``path``,
        then ``epoch`` and ``global_iter`` from its meta."""
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

    def run(self, data_loader, max_epochs: int) -> None:
        """Epochs from ``epoch`` up to ``max_epochs``, between the hooks'
        ``before_run`` and ``after_run``."""
        self.call_hook("before_run")
        while self.epoch < max_epochs:
            self.train_epoch(data_loader)
        self.call_hook("after_run")


class TS_Trainer(Trainer):
    """Teacher-student trainer: the frozen ``teacher`` (eval mode, no
    gradient) distils into ``student``; the branch follows the teacher's
    backbone (``teacher_cfg``). Checkpoints hold the student."""

    def __init__(self, teacher, student, optimizer, teacher_cfg: dict, **kw):
        self.teacher = teacher
        self.branch = branch_of(teacher_cfg)
        super().__init__(student, optimizer,
                         make_ts_train_step(teacher, student, optimizer, self.branch), **kw)
