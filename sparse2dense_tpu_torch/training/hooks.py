"""Priority-ordered training hooks (counterpart of
``sparse2dense_tpu/training/hooks.py``; the reference's
det3d/torchie/trainer/hooks/).

The optimizer hook has no counterpart: forward, backward, clipping and the
optimizer step are one ``Trainer.step``. The others keep the reference's
shape: ``LogBuffer`` windowed means (log_buffer.py:6), text logging every
``interval`` iterations (hooks/logger/text.py:41-130), TensorBoard scalars
(hooks/logger/tensorboard.py:9; ``before_run`` raises where the
``tensorboard`` package is missing), per-epoch checkpoints
(hooks/checkpoint.py:5) with an optional rolling mid-epoch "preempt"
checkpoint, and iteration timing (hooks/iter_timer.py:6). Under data
parallelism only rank 0 logs (the reference's loggers are rank 0's); the
checkpoint hooks run on every rank and ``Trainer.save_checkpoint`` lets
rank 0 write.
"""
from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict
from typing import Optional

from ..parallel.dist import is_main


class LogBuffer:
    def __init__(self):
        self.val_history = OrderedDict()
        self.n_history = OrderedDict()
        self.output = OrderedDict()
        self.ready = False

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.clear_output()

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, vars: dict, count: int = 1):
        for k, v in vars.items():
            self.val_history.setdefault(k, []).append(float(v))
            self.n_history.setdefault(k, []).append(count)

    def average(self, n: int = 0):
        for k in self.val_history:
            v = self.val_history[k][-n:] if n > 0 else self.val_history[k]
            c = self.n_history[k][-n:] if n > 0 else self.n_history[k]
            total = sum(x * y for x, y in zip(v, c))
            self.output[k] = total / max(sum(c), 1)
        self.ready = True


class Hook:
    priority = 50

    def before_run(self, trainer):
        pass

    def after_run(self, trainer):
        pass

    def before_train_epoch(self, trainer):
        pass

    def after_train_epoch(self, trainer):
        pass

    def before_train_iter(self, trainer):
        pass

    def after_train_iter(self, trainer):
        pass


class IterTimerHook(Hook):
    priority = 60

    def before_train_epoch(self, trainer):
        self.t = time.time()

    def before_train_iter(self, trainer):
        trainer.log_buffer.update({"data_time": time.time() - self.t})

    def after_train_iter(self, trainer):
        trainer.log_buffer.update({"time": time.time() - self.t})
        self.t = time.time()


class TextLoggerHook(Hook):
    priority = 90

    def __init__(self, interval=20, logger: Optional[logging.Logger] = None):
        self.interval = interval
        self.logger = logger or logging.getLogger("sparse2dense_tpu_torch")

    def after_train_iter(self, trainer):
        if (trainer.inner_iter + 1) % self.interval != 0 or not is_main():
            return
        trainer.log_buffer.average(self.interval)
        items = [f"epoch [{trainer.epoch + 1}][{trainer.inner_iter + 1}/"
                 f"{trainer.epoch_length}]"]
        if "lr" in trainer.current_stats:
            items.append(f"lr: {trainer.current_stats['lr']:.3e}")
        for k, v in trainer.log_buffer.output.items():
            items.append(f"{k}: {v:.4f}")
        self.logger.info(", ".join(items))
        trainer.log_buffer.clear_output()


class TensorboardLoggerHook(Hook):
    """Scalar summaries every ``interval`` iters (reference
    torchie/trainer/hooks/logger/tensorboard.py:9)."""

    priority = 91

    def __init__(self, interval=20, log_dir=None):
        self.interval = interval
        self.log_dir = log_dir
        self._writer = None

    def before_run(self, trainer):
        if not is_main():
            return
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(
            self.log_dir or os.path.join(trainer.work_dir, "tf_logs"))

    def after_train_iter(self, trainer):
        if (trainer.inner_iter + 1) % self.interval != 0 or not self._writer:
            return
        trainer.log_buffer.average(self.interval)
        for k, v in trainer.log_buffer.output.items():
            tag = k if k in ("time", "data_time") else f"train/{k}"
            self._writer.add_scalar(tag, v, trainer.global_iter + 1)
        if "lr" in trainer.current_stats:
            self._writer.add_scalar("learning_rate",
                                    trainer.current_stats["lr"],
                                    trainer.global_iter + 1)

    def after_run(self, trainer):
        if self._writer:
            self._writer.close()
            self._writer = None


class CheckpointHook(Hook):
    """Epoch-interval checkpoints (reference hooks/checkpoint.py:5) plus an
    optional ``iter_interval``: a rolling ``preempt`` checkpoint every N
    iterations. Resuming a preempt checkpoint restarts the interrupted epoch
    with the saved parameters and optimizer, so at most N optimizer steps of
    progress are lost and each epoch still covers the whole dataset."""

    priority = 70

    def __init__(self, interval=1, out_dir=None, iter_interval=0):
        self.interval = interval
        self.iter_interval = iter_interval
        self.out_dir = out_dir

    def after_train_iter(self, trainer):
        if not self.iter_interval:
            return
        if (trainer.global_iter + 1) % self.iter_interval != 0:
            return
        trainer.save_checkpoint(self.out_dir or trainer.work_dir,
                                name="preempt", latest=False, mid_epoch=True)

    def after_train_epoch(self, trainer):
        if (trainer.epoch + 1) % self.interval != 0:
            return
        trainer.save_checkpoint(self.out_dir or trainer.work_dir)


def build_hooks(log_config=None, checkpoint_config=None, work_dir=None):
    hooks = [IterTimerHook()]
    if checkpoint_config:
        hooks.append(CheckpointHook(
            interval=checkpoint_config.get("interval", 1), out_dir=work_dir,
            iter_interval=checkpoint_config.get("iter_interval", 0)))
    interval = (log_config or {}).get("interval", 20)
    for h in (log_config or {}).get("hooks", [dict(type="TextLoggerHook")]):
        kind = h.get("type") if isinstance(h, dict) else h
        if kind == "TensorboardLoggerHook":
            hooks.append(TensorboardLoggerHook(interval=interval))
    hooks.append(TextLoggerHook(interval=interval))
    return sorted(hooks, key=lambda h: h.priority)
