"""Checkpoint save and restore (counterpart of
``sparse2dense_tpu/training/checkpoint.py``; the reference's
det3d/torchie/trainer/checkpoint.py).

A checkpoint is one ``torch.save`` file: {"model": the model's
``state_dict`` (parameters and BatchNorm buffers), "optimizer": the
optimizer's (Adam moments and the step count, hence the position of the
one-cycle schedules), "meta": {epoch, iter, config text, classes}}.
``latest`` beside it is a relative symlink, as the reference's
``latest.pth``. Loading tolerates missing and extra entries with a log line,
the analogue of ``load_state_dict(strict=False)``. The reference's own
checkpoints (det3d ``.pth``, the JAX package's Orbax directories) are not
read here.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import torch


def save_checkpoint(out_dir: str, name: str, state: Dict, meta: Optional[dict] = None,
                    latest: bool = True) -> str:
    """Write ``state`` (a dict of ``state_dict``s) and ``meta`` to
    ``<out_dir>/<name>``; with ``latest``, repoint ``<out_dir>/latest`` to it
    (the rolling mid-epoch "preempt" saves leave it on the last epoch)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(out_dir, name))
    torch.save(dict(state, meta=meta or {}), path)
    if latest:
        link = os.path.join(out_dir, "latest")
        if os.path.islink(link) or os.path.exists(link):
            os.unlink(link)
        os.symlink(name, link)
    return path


def load_checkpoint(path: str) -> Tuple[Dict, dict]:
    """-> (state, meta) of a checkpoint written by :func:`save_checkpoint`,
    its tensors on the CPU (``load_state_dict`` copies them to the model's
    device)."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    meta = state.pop("meta", {})
    return state, meta


def merge_params(target: Dict[str, torch.Tensor], restored: Dict[str, torch.Tensor],
                 logger: Optional[logging.Logger] = None) -> Dict[str, torch.Tensor]:
    """``target`` (a ``state_dict``) with each entry that ``restored`` holds
    under the same name and shape replaced by the restored one; logs the
    counts of entries missing from ``restored`` and of those whose shapes
    differ, instead of failing."""
    out, missing, mismatched = {}, [], []
    for name, value in target.items():
        if name not in restored:
            missing.append(name)
            out[name] = value
        elif tuple(restored[name].shape) != tuple(value.shape):
            mismatched.append(name)
            out[name] = value
        else:
            out[name] = restored[name]
    if (missing or mismatched) and logger:
        logger.warning(f"checkpoint merge: {len(missing)} missing, "
                       f"{len(mismatched)} shape-mismatched keys")
    return out
