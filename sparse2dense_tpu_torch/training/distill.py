"""The teacher-student (Sparse2Dense) distillation step (counterpart of
``sparse2dense_tpu/training/distill.py``; det3d's
``TS_Trainer.batch_processor_inline``). The teacher runs frozen (eval mode,
no gradient) on the ``dense_*`` stream and, for F_D_b, on the
``reconstruction_*`` stream; the student trains. Every branch adds to the
student's head loss masked MSE terms of F_S_a against F_D_a and of F_S_b
against F_D_b, and the PCR mask and offset losses:

- "centerpoint" (SpMiddleResNetFHD teachers): x10 where F_D_a > 0, x20
  elsewhere, x5 and x20 on F_b; the KD heatmap focal loss against the
  teacher's sigmoid heatmap and the KD box regression MSE at the gt centres
  weighted by the code weights and the head weight; PCR x1;
- "second" (SpMiddleFHD teachers, an anchor head with no heatmap): the four
  MSE terms of "centerpoint" and nothing else; PCR x0.5;
- "pp" (PointPillars teachers): the maps max-pooled 2x2 first, five terms
  all x10: F_a where A_D > 0 and elsewhere, the cross term F_a where
  B_D > 0 (det3d's, kept), F_b where B_D > 0 and elsewhere; the KD heatmap
  focal loss (no KD regression); PCR x0.5.

The masks are F_D > 0 elementwise, as det3d's boolean indexing. Each
normaliser is the global batch's (``parallel.dist.global_sum``), so under
data parallelism the processes' losses add up to their joined batch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.heads.center_head import _clip_sigmoid
from ..models.losses.centernet import fast_focal_loss, gather_feat_nhwc
from ..parallel.dist import global_sum, reduce_metrics
from .train_state import Mark, mark_at, reduce_step, telemetry_metrics

_ANNO = ("reg", "height", "dim", "rot")


def masked_mse(pred, target, mask):
    """mean((pred - target)^2) over the elements where ``mask`` is True
    (in every process's batch)."""
    m = mask.to(pred.dtype)
    return ((pred - target).square() * m).sum() / global_sum(m.sum()).clamp(min=1.0)


def distill_reg_loss(s_anno, t_anno, mask, ind):
    """Per-dimension MSE of the student's and the teacher's box maps
    (B, H, W, D) gathered at the gt centres: (D,)."""
    pred, gt = gather_feat_nhwc(s_anno, ind), gather_feat_nhwc(t_anno, ind)
    m = mask.to(pred.dtype)[..., None]
    return ((pred * m - gt * m).square() / (global_sum(m.sum()) + 1e-4)).sum((0, 1))


def _maxpool2(x):
    """2x2 max-pool of an NHWC map."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def make_teacher_forward(teacher):
    """-> teacher_forward(batch) -> (teacher preds, F_D_a, F_D_b): the
    frozen teacher in eval mode under ``no_grad``."""

    def teacher_forward(batch):
        teacher.eval()
        with torch.no_grad():
            out = teacher(batch, return_recon_feature=True)
        return out["preds"], out["f_a"], out["f_b"]

    return teacher_forward


def _kd_heatmap(s_preds, t_preds, batch):
    """(KD heatmap focal loss against the teacher's sigmoid heatmap, the
    teacher's own heatmap loss for the logs)."""
    ind, mask, cat = batch["ind"][0], batch["mask"][0], batch["cat"][0]
    t_hm = torch.sigmoid(t_preds[0]["hm"])
    kd_hm = fast_focal_loss(_clip_sigmoid(s_preds[0]["hm"]), t_hm, ind, mask, cat)
    return kd_hm, fast_focal_loss(t_hm.clamp(1e-4, 1 - 1e-4), batch["hm"][0], ind, mask, cat)


def _kd_reg(head, s_preds, t_preds, batch):
    """The "centerpoint" branch's KD box regression, code- and head-weighted."""
    kd_reg = distill_reg_loss(torch.cat([s_preds[0][k] for k in _ANNO], -1),
                              torch.cat([t_preds[0][k] for k in _ANNO], -1),
                              batch["mask"][0], batch["ind"][0])
    cw = torch.tensor(head.code_weights[:kd_reg.shape[0]], dtype=kd_reg.dtype,
                      device=kd_reg.device)
    return (kd_reg * cw).sum() * head.weight


def _s2d_loss(branch, f_s_a, f_d_a, f_s_b, f_d_b):
    """The branch's masked MSE terms of the student's maps against the
    teacher's."""
    if branch == "pp":
        a_s, a_d, b_s, b_d = (_maxpool2(x) for x in (f_s_a, f_d_a, f_s_b, f_d_b))
        inds = a_d > 0
        s2d = masked_mse(a_s, a_d, ~inds) * 10
        s2d = s2d + masked_mse(a_s, a_d, inds) * 10
        inds = b_d > 0
        s2d = s2d + masked_mse(a_s, a_d, inds) * 10   # det3d's cross term
        s2d = s2d + masked_mse(b_s, b_d, inds) * 10
        return s2d + masked_mse(b_s, b_d, ~inds) * 10
    inds = f_d_a > 0
    s2d = masked_mse(f_s_a, f_d_a, inds) * 10
    s2d = s2d + masked_mse(f_s_a, f_d_a, ~inds) * 20
    inds = f_d_b > 0
    s2d = s2d + masked_mse(f_s_b, f_d_b, inds) * 5
    return s2d + masked_mse(f_s_b, f_d_b, ~inds) * 20


def make_ts_train_step(teacher, student, optimizer, branch: str):
    """-> ts_step(batch, mark=None) -> metrics (every loss in the logs,
    "loss", "grad_norm", "telemetry/*"; the global batch's under data
    parallelism). ``mark`` is called after "teacher_forward",
    "student_forward" (with the losses), "backward", "allreduce" (more than
    one process) and "optimizer". The frozen teacher runs in eval mode and
    makes no collective."""
    if branch not in ("centerpoint", "second", "pp"):
        raise ValueError(f"unknown distillation branch {branch!r}")
    pcr_weight = 1.0 if branch == "centerpoint" else 0.5
    teacher_forward = make_teacher_forward(teacher)

    def student_losses(t_out, batch):
        t_preds, f_d_a, f_d_b = t_out
        out = student(batch)
        s_preds = out["preds"]
        task_loss, logs = student.loss(s_preds, batch)
        mask_loss, offset_loss = student.pcr_loss(out, batch)
        s2d = _s2d_loss(branch, out["f_s_a"], f_d_a, out["f_s_b"], f_d_b)
        distill = s2d
        if branch != "second":   # SECOND's teachers have no heatmap head
            kd_hm, t_hm_loss = _kd_heatmap(s_preds, t_preds, batch)
            distill = distill + kd_hm
            logs.update(kd_hm_loss=kd_hm, T_hm_loss=t_hm_loss)
        if branch == "centerpoint":
            kd_reg = _kd_reg(student.bbox_head, s_preds, t_preds, batch)
            distill = distill + kd_reg
            logs.update(kd_reg_loss=kd_reg)
        total = task_loss + distill + (mask_loss + offset_loss) * pcr_weight
        logs.update(sparse2dense_loss=s2d, mask_loss=mask_loss,
                    reconstruction_loss=offset_loss)
        return total, logs, out["telemetry"]

    def ts_step(batch, mark: Mark = None):
        t_out = teacher_forward(batch)
        mark_at(mark, "teacher_forward")
        student.train()
        total, logs, telemetry = student_losses(t_out, batch)
        mark_at(mark, "student_forward")
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark_at(mark, "backward")
        reduce_step(optimizer, mark)
        grad_norm = optimizer.step()
        mark_at(mark, "optimizer")
        metrics = {k: v.detach() for k, v in logs.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm)
        metrics.update(telemetry_metrics(telemetry))
        return reduce_metrics(metrics)

    return ts_step


def branch_of(teacher_cfg: dict) -> str:
    """The distillation branch of a teacher config (det3d keys on the
    teacher backbone's class name)."""
    bk = teacher_cfg["backbone"]["type"]
    if bk.startswith("PointPillarsScatter"):
        return "pp"
    if bk == "SpMiddleResNetFHD":
        return "centerpoint"
    return "second"
