"""Trainer and TS_Trainer (counterpart of
``sparse2dense_tpu/training/trainer.py``): the step and the epoch loop.
Checkpoints, hooks, validation, data parallelism and the training CLI come
with the runtime slice."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .distill import branch_of, make_ts_train_step
from .train_state import Mark, make_train_step


class Trainer:
    """Trains ``model`` with ``optimizer`` (``solver.optim.OneCycleAdam``)
    through ``train_step`` (the plain detector step unless given)."""

    def __init__(self, model, optimizer, train_step: Optional[Callable] = None):
        self.model, self.optimizer = model, optimizer
        self.epoch = 0
        self.global_iter = 0
        self._train_step = train_step or make_train_step(model, optimizer)

    def step(self, batch, mark: Mark = None) -> Dict:
        """One optimization step; metrics as 0-dim tensors."""
        return self._train_step(batch, mark)

    def train_epoch(self, data_loader) -> List[Dict[str, float]]:
        """One pass over ``data_loader`` (batches of ``make_batch``'s
        layout); returns each step's metrics as floats."""
        log = []
        for batch in data_loader:
            batch = {k: v for k, v in batch.items() if k != "metadata"}
            log.append({k: float(v) for k, v in self.step(batch).items()})
            self.global_iter += 1
        self.epoch += 1
        return log


class TS_Trainer(Trainer):
    """Teacher-student trainer: the frozen ``teacher`` (eval mode, no
    gradient) distils into ``student``; the branch follows the teacher's
    backbone (``teacher_cfg``)."""

    def __init__(self, teacher, student, optimizer, teacher_cfg: dict):
        self.teacher = teacher
        self.branch = branch_of(teacher_cfg)
        super().__init__(student, optimizer,
                         make_ts_train_step(teacher, student, optimizer, self.branch))
