"""The plain detector's training step (counterpart of
``sparse2dense_tpu/training/train_state.py``): forward in train mode, loss,
backward, then the optimizer (clip, Adam, one-cycle schedules; see
``solver/optim.py``). The model and the optimizer hold the state that the
reference carries in its ``TrainState``."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Mark = Optional[Callable[[str], None]]


def mark_at(mark: Mark, name: str) -> None:
    """Call ``mark(name)`` at a stage boundary of a step, if given (a timer
    that synchronises the device and reads a clock)."""
    if mark is not None:
        mark(name)


def telemetry_metrics(telemetry) -> Dict[str, torch.Tensor]:
    """The backbone's counters, summed over the batch, as step metrics: a
    budget overflow or a missed neighbour shows in the logs, not only in
    accuracy."""
    return {f"telemetry/{name}": counts.sum() for name, (counts, _) in telemetry.items()}


def make_train_step(model, optimizer):
    """-> train_step(batch, mark=None) -> metrics: every loss of the model's
    logs, "loss", "grad_norm" (before clipping) and "telemetry/*", as 0-dim
    tensors. ``batch`` carries the inputs and the CenterHead targets.
    ``mark`` is called after "forward", "backward" and "optimizer"."""

    def train_step(batch, mark: Mark = None):
        model.train()
        out = model(batch)
        loss, logs = model.loss(out["preds"], batch)
        mark_at(mark, "forward")
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark_at(mark, "backward")
        grad_norm = optimizer.step()
        mark_at(mark, "optimizer")
        metrics = {k: v.detach() for k, v in logs.items()}
        metrics.update(loss=loss.detach(), grad_norm=grad_norm)
        metrics.update(telemetry_metrics(out["telemetry"]))
        return metrics

    return train_step
