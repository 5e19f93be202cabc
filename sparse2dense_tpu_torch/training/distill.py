"""The teacher-student (Sparse2Dense) distillation step (counterpart of
``sparse2dense_tpu/training/distill.py``; det3d's
``TS_Trainer.batch_processor_inline``). The teacher runs frozen (eval mode,
no gradient) on the ``dense_*`` stream and, for F_D_b, on the
``reconstruction_*`` stream; the student trains. The "centerpoint" branch
(SpMiddleResNetFHD teachers) adds to the student's head loss: masked MSE of
F_S_a against F_D_a (x10 where F_D_a > 0, x20 elsewhere) and of F_S_b
against F_D_b (x5, x20), the KD heatmap focal loss against the teacher's
sigmoid heatmap, the KD box regression MSE at the gt centres weighted by the
code weights and the head weight, and the PCR mask and offset losses (x1).
The masks are F_D > 0 elementwise, as det3d's boolean indexing.
"""
from __future__ import annotations

import torch

from ..models.heads.center_head import _clip_sigmoid
from ..models.losses.centernet import fast_focal_loss, gather_feat_nhwc
from .train_state import Mark, mark_at, telemetry_metrics

_ANNO = ("reg", "height", "dim", "rot")


def masked_mse(pred, target, mask):
    """mean((pred - target)^2) over the elements where ``mask`` is True."""
    m = mask.to(pred.dtype)
    return ((pred - target).square() * m).sum() / m.sum().clamp(min=1.0)


def distill_reg_loss(s_anno, t_anno, mask, ind):
    """Per-dimension MSE of the student's and the teacher's box maps
    (B, H, W, D) gathered at the gt centres: (D,)."""
    pred, gt = gather_feat_nhwc(s_anno, ind), gather_feat_nhwc(t_anno, ind)
    m = mask.to(pred.dtype)[..., None]
    return ((pred * m - gt * m).square() / (m.sum() + 1e-4)).sum((0, 1))


def make_teacher_forward(teacher):
    """-> teacher_forward(batch) -> (teacher preds, F_D_a, F_D_b): the
    frozen teacher in eval mode under ``no_grad``."""

    def teacher_forward(batch):
        teacher.eval()
        with torch.no_grad():
            out = teacher(batch, return_recon_feature=True)
        return out["preds"], out["f_a"], out["f_b"]

    return teacher_forward


def make_ts_train_step(teacher, student, optimizer, branch: str):
    """-> ts_step(batch, mark=None) -> metrics (every loss in the logs,
    "loss", "grad_norm", "telemetry/*"). ``mark`` is called after
    "teacher_forward", "student_forward" (with the losses), "backward" and
    "optimizer"."""
    if branch != "centerpoint":
        raise NotImplementedError(
            f"the {branch!r} distillation branch comes with the PointPillars and SECOND "
            "families, a later slice")
    teacher_forward = make_teacher_forward(teacher)
    head = student.bbox_head

    def student_losses(t_out, batch):
        t_preds, f_d_a, f_d_b = t_out
        out = student(batch)
        s_preds = out["preds"]
        task_loss, logs = student.loss(s_preds, batch)
        mask_loss, offset_loss = student.pcr_loss(out, batch)
        f_s_a, f_s_b = out["f_s_a"], out["f_s_b"]
        inds = f_d_a > 0
        s2d = masked_mse(f_s_a, f_d_a, inds) * 10
        s2d = s2d + masked_mse(f_s_a, f_d_a, ~inds) * 20
        inds = f_d_b > 0
        s2d = s2d + masked_mse(f_s_b, f_d_b, inds) * 5
        s2d = s2d + masked_mse(f_s_b, f_d_b, ~inds) * 20
        ind, mask, cat = batch["ind"][0], batch["mask"][0], batch["cat"][0]
        t_hm = torch.sigmoid(t_preds[0]["hm"])
        kd_hm = fast_focal_loss(_clip_sigmoid(s_preds[0]["hm"]), t_hm, ind, mask, cat)
        kd_reg = distill_reg_loss(torch.cat([s_preds[0][k] for k in _ANNO], -1),
                                  torch.cat([t_preds[0][k] for k in _ANNO], -1), mask, ind)
        cw = torch.tensor(head.code_weights[:kd_reg.shape[0]], dtype=kd_reg.dtype,
                          device=kd_reg.device)
        kd_reg = (kd_reg * cw).sum() * head.weight
        total = task_loss + (s2d + kd_hm + kd_reg) + (mask_loss + offset_loss)
        logs.update(kd_hm_loss=kd_hm, kd_reg_loss=kd_reg, sparse2dense_loss=s2d,
                    mask_loss=mask_loss, reconstruction_loss=offset_loss,
                    T_hm_loss=fast_focal_loss(t_hm.clamp(1e-4, 1 - 1e-4), batch["hm"][0], ind,
                                              mask, cat))
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
        grad_norm = optimizer.step()
        mark_at(mark, "optimizer")
        metrics = {k: v.detach() for k, v in logs.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm)
        metrics.update(telemetry_metrics(telemetry))
        return metrics

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
