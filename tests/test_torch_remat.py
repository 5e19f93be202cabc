"""Rematerialisation in training: ``distill_tiny``'s teacher-student step and
a plain step of its teacher (window engine, dense stages from conv2 in
float32), once with the backbone's ``remat_dense`` on (the default) and once
off, from the same seeded weights and batch. The dense modules and the PCR
generators must run under the checkpoint and be recomputed in the backward;
the metrics, every gradient and every BN running statistic must be as
without it. Tolerance: 1e-6 of the largest value of the module that holds
the tensor (a gradient summed in another order; on this CPU the two come
out bit-equal). A running statistic moved twice a step (the recompute's
forward updating it again) is off by about one update, 1e-2 of the batch
statistic, and fails.

Split into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the gradients and the
running statistics, ``tests/test_torch_remat_grads.py``."""
import numpy as np
import pytest

import torch

from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models import remat as R
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.train_state import make_train_step
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import session_shared

CFG = "configs/tests/distill_tiny.py"
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6, seed=0)
ENGINE = dict(engine="window", dense_from_stage=1, dense_compute_dtype=None)
TOL = 1e-6
# rematerialised calls a step: conv2_0..conv4_1, conv3_down, conv4_down,
# extra_conv; and the student's PCR generators
DENSE_CALLS = {"DenseBasicBlock": 6, "DenseDownsample": 3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' small ops run as fast on it, and
    the suite's parallel workers share the cores (several threads each made
    this file's steps tens of times slower there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step(remat_dense: bool):
    cfg = ConfigDict.fromfile(CFG)
    for key in ("model", "S_model"):
        cfg[key]["backbone"].update(ENGINE, remat_dense=remat_dense)
    kw = dict(test_cfg=cfg.test_cfg, voxel_generator=cfg.voxel_generator, device="cpu")
    teacher = build_detector(cfg.model, generator=torch.Generator().manual_seed(4), **kw)
    student = build_detector(cfg.S_model, generator=torch.Generator().manual_seed(5), **kw)
    assert student.backbone.remat_dense is remat_dense
    batch = make_batch(cfg, 1, device="cpu", with_targets=True, distillation=True, **FRAME)
    clip = cfg.optimizer_config["grad_clip"]
    out = {}
    for tag, model, step in (
            ("ts", student, TS_Trainer(teacher, student, OneCycleAdam(
                student.parameters(), cfg.optimizer, cfg.lr_config, 10, clip), cfg.model).step),
            ("teacher", teacher, make_train_step(teacher, OneCycleAdam(
                teacher.parameters(), cfg.optimizer, cfg.lr_config, 10, clip)))):
        R.calls.clear()
        R.recomputes.clear()
        metrics = step(batch)
        out[tag] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            stats={k: v.clone() for k, v in model.state_dict().items() if "running" in k},
            calls=dict(R.calls), recomputes=dict(R.recomputes))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both steps with remat on and off; computed once a session for this
    file and ``tests/test_torch_remat_grads.py`` (``session_shared``)."""
    return session_shared(tmp_path_factory, "remat_runs",
                          lambda: {flag: _step(flag) for flag in (True, False)})


@pytest.mark.parametrize("tag,calls", [("ts", dict(DENSE_CALLS, _pcr=1)),
                                       ("teacher", DENSE_CALLS)])
def test_modules_run_under_checkpoint(runs, tag, calls):
    assert runs[True][tag]["calls"] == calls
    assert runs[True][tag]["recomputes"] == calls
    assert runs[False][tag]["calls"] == (dict(_pcr=1) if tag == "ts" else {})


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    scale = {}
    for name, w in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(w.abs().max()))
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=TOL * scale[name.rsplit(".", 1)[0]], err_msg=name)


@pytest.mark.parametrize("tag", ["ts", "teacher"])
def test_remat_metrics_equal(runs, tag):
    got, want = runs[True][tag]["metrics"], runs[False][tag]["metrics"]
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=TOL, err_msg=k)
    assert np.isfinite(list(got.values())).all() and got["grad_norm"] > 0


