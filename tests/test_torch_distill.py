"""The flagship training step at tiny size against JAX: ``distill_tiny``'s
VoxelNet teacher and KD_VoxelNet + S2D_RPN student, both on the window
engine with dense stages from conv2 in float32, the same seeded random
weights (``from_flax``) and the same synthetic distillation batch. One
teacher-student step, then one plain step of the teacher, in each package.

JAX's gradients come from its own ``make_ts_train_step`` / ``make_train_step``
with a ``TrainState`` whose ``tx`` is ``optax.sgd(1.0)``: the parameters
before minus the parameters after. The frame keeps every window plan's
residual rows within budget in both packages, where the reference is exact.
Tolerances: metrics 1e-4 relative (float32 sums in other orders through two
detectors); gradients 1e-3 * max|g| + 1e-6, max|g| taken over the module
that holds the tensor (a conv bias followed by BatchNorm has an exactly
zero gradient: what either package computes for it is the rounding residue
of summing the conv's output gradient, ~1e-5 here, which scales with the
layer's gradients, not with itself); BN running statistics 1e-5."""
import numpy as np
import pytest

import jax
import optax
import torch

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.distill import make_ts_train_step as jax_ts_step
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.training.train_state import TrainState
from sparse2dense_tpu.training.train_state import make_train_step as jax_train_step
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.train_state import make_train_step
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import rand_variables

CFG = "configs/tests/distill_tiny.py"
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6, seed=0)
ENGINE = dict(engine="window", dense_from_stage=1, dense_compute_dtype=None)
# the port's telemetry metric -> the reference's (sown per plan, summed)
TELEMETRY = {"telemetry/conv1": "telemetry/backbone/win_resid/[0]",
             "telemetry/conv2_down": "telemetry/backbone/conv2_down/win_resid/[0]"}


def _sgd_grads(before, after):
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), before, after)


def _port_grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = Config.fromfile(CFG), ConfigDict.fromfile(CFG)
    for cfg in (jcfg, tcfg):
        for key in ("model", "S_model"):
            cfg[key]["backbone"].update(ENGINE)
    kw = dict(test_cfg=jcfg.test_cfg, voxel_generator=jcfg.voxel_generator)
    jteacher, jstudent = (jax_build_detector(jcfg[k], **kw) for k in ("model", "S_model"))
    jbatch = jax_make_batch(jcfg, 1, distillation=True, **FRAME)
    t_vars = rand_variables(lambda: jteacher.init(jax.random.PRNGKey(0), jbatch, train=False),
                            seed=11)
    s_vars = rand_variables(lambda: jstudent.init(jax.random.PRNGKey(1), jbatch, train=True),
                            seed=12)
    sgd = optax.sgd(1.0)
    s_state = TrainState.create(apply_fn=jstudent.apply, params=s_vars["params"],
                                batch_stats=s_vars["batch_stats"], tx=sgd)
    s_state, jmetrics = jax.jit(jax_ts_step(jteacher, jstudent, "centerpoint"))(
        t_vars, s_state, jbatch)
    t_state = TrainState.create(apply_fn=jteacher.apply, params=t_vars["params"],
                                batch_stats=t_vars["batch_stats"], tx=sgd)
    t_state, jt_metrics = jax.jit(jax_train_step(jteacher))(t_state, jbatch)

    kw = dict(test_cfg=tcfg.test_cfg, voxel_generator=tcfg.voxel_generator, device="cpu")
    teacher, student = (build_detector(tcfg[k], **kw) for k in ("model", "S_model"))
    teacher.load_state_dict(from_flax(t_vars, teacher))
    student.load_state_dict(from_flax(s_vars, student))
    batch = make_batch(tcfg, 1, device="cpu", with_targets=True, distillation=True, **FRAME)
    clip = tcfg.optimizer_config["grad_clip"]
    trainer = TS_Trainer(teacher, student,
                         OneCycleAdam(student.parameters(), tcfg.optimizer, tcfg.lr_config, 10,
                                      clip), tcfg.model)
    metrics = trainer.step(batch)
    s_grads = _port_grads(student)
    s_stats = {k: v.clone() for k, v in student.state_dict().items() if "running" in k}
    t_metrics = make_train_step(teacher, OneCycleAdam(teacher.parameters(), tcfg.optimizer,
                                                      tcfg.lr_config, 10, clip))(batch)
    t_stats = {k: v.clone() for k, v in teacher.state_dict().items() if "running" in k}
    return dict(
        jbatch=jbatch, batch=batch, jmetrics=jmetrics, metrics=metrics,
        jt_metrics=jt_metrics, t_metrics=t_metrics,
        s_grads=s_grads, js_grads=from_flax({"params": _sgd_grads(s_vars["params"],
                                                                  s_state.params)}, student),
        t_grads=_port_grads(teacher), jt_grads=from_flax(
            {"params": _sgd_grads(t_vars["params"], t_state.params)}, teacher),
        s_stats=s_stats, js_stats=from_flax({"batch_stats": s_state.batch_stats}, student),
        t_stats=t_stats, jt_stats=from_flax({"batch_stats": t_state.batch_stats}, teacher))


def test_make_batch_with_targets_and_distillation_bit_exact(run):
    jbatch, batch = run["jbatch"], run["batch"]
    assert sorted(jbatch) == sorted(batch)
    for key, want in jbatch.items():
        got = batch[key]
        for w, g in zip(want, got) if isinstance(want, list) else [(want, got)]:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, key
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
    assert int(np.asarray(jbatch["mask"][0]).sum()) > 0
    assert int((np.asarray(jbatch["reconstruction_coordinates_4"])[..., 0] >= 0).sum()) > 50


def _compare_metrics(got, want):
    names = {k: TELEMETRY.get(k, k) for k in got}
    assert sorted(names.values()) == sorted(want), (sorted(names.values()), sorted(want))
    for k, jk in names.items():
        np.testing.assert_allclose(float(got[k]), float(want[jk]), rtol=1e-4, err_msg=k)


def test_ts_step_metrics(run):
    _compare_metrics(run["metrics"], run["jmetrics"])
    for k, v in run["metrics"].items():
        assert np.isfinite(float(v)), k
    assert float(run["metrics"]["grad_norm"]) > 0
    assert all(float(v) == 0 for k, v in run["metrics"].items() if k.startswith("telemetry/"))


def assert_grads_close(got, want):
    # ``want`` also holds the model's buffers (from_flax fills the PCR ones)
    assert set(got) <= set(want)
    scale = {}
    for name in got:
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(want[name].abs().max()))
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name].numpy(), rtol=0,
                                   atol=1e-3 * scale[name.rsplit(".", 1)[0]] + 1e-6,
                                   err_msg=name)


def test_ts_step_student_gradients(run):
    assert_grads_close(run["s_grads"], run["js_grads"])
    # the window-engine convs (the custom autograd Function) got gradient
    for name in ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                 "backbone.conv1_1.conv2_weight", "backbone.conv2_down.conv_weight"):
        assert np.abs(run["s_grads"][name]).max() > 0, name


def _compare_stats(got, want):
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_ts_step_batchnorm_statistics(run):
    _compare_stats(run["s_stats"], run["js_stats"])


def test_teacher_train_step(run):
    """The plain step of the VoxelNet teacher (RPN neck): metrics,
    gradients and the BN statistics of its training forward."""
    _compare_metrics(run["t_metrics"], run["jt_metrics"])
    assert_grads_close(run["t_grads"], run["jt_grads"])
    _compare_stats(run["t_stats"], run["jt_stats"])
