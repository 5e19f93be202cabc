"""The reference's optimizer (counterpart of ``sparse2dense_tpu/solver/optim.py``):
global-norm gradient clipping, then Adam (b2 0.99, eps 1e-8) whose b1 and
learning rate follow the one-cycle schedules step by step, with decoupled
("fixed") weight decay, in optax's order: clip, Adam moments with bias
correction by the current b1, decay added to the Adam direction, times
-lr. Parameters whose gradient is None step as if it were zero, as every
leaf of the reference's gradient tree does."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from .schedules import one_cycle_lr, one_cycle_momentum

B2, EPS = 0.99, 1e-8


class OneCycleAdam(torch.optim.Optimizer):
    """Built from reference-schema configs: ``optimizer_cfg`` = dict(type=
    "adam", wd=..., fixed_wd=...), ``lr_cfg`` = dict(type="one_cycle",
    lr_max, moms, div_factor, pct_start), ``grad_clip`` = dict(max_norm=...)
    or None. :meth:`step` returns the global gradient norm before clipping."""

    def __init__(self, params: Iterable[torch.nn.Parameter], optimizer_cfg: dict,
                 lr_cfg: dict, total_steps: int, grad_clip: Optional[dict] = None):
        if optimizer_cfg.get("type", "adam").lower() != "adam":
            raise NotImplementedError(f"optimizer {optimizer_cfg.get('type')}")
        if lr_cfg.get("type", "one_cycle") != "one_cycle":
            raise NotImplementedError(f"lr schedule {lr_cfg.get('type')}")
        pct = float(lr_cfg.get("pct_start", 0.4))
        self.lr = one_cycle_lr(float(lr_cfg["lr_max"]), float(lr_cfg.get("div_factor", 10.0)),
                               pct, total_steps)
        self.momentum = one_cycle_momentum(tuple(lr_cfg.get("moms", (0.95, 0.85))), pct,
                                           total_steps)
        wd = float(optimizer_cfg.get("wd", 0.0))
        self.wd = wd if bool(optimizer_cfg.get("fixed_wd", True)) and wd > 0 else 0.0
        self.max_norm = float(grad_clip["max_norm"]) if grad_clip and grad_clip.get(
            "max_norm") else None
        self.count = 0
        super().__init__(params, {})

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.max_norm is not None:
            scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                self.max_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        lr, b1 = float(self.lr(self.count)), float(self.momentum(self.count))
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** t)
        for p in params:
            if not self.state[p]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nus, B2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2))
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(torch._foreach_div(mus, bc1), den)
        if self.wd:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.wd))
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
        return norm
