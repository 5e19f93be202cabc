"""The SECOND family against JAX: the box coder, anchors and anchor targets,
the three SECOND losses, MultiGroupHead (forward, loss, predict),
SpMiddleFHD in train mode on the gather and window engines, the "second"
teacher-student step at ``second_distill_tiny``, and the recipe's two
configs against their zoo rows.

Inputs are made from seeded numpy generators; both packages get the same
arrays and the same weights (one Flax tree through ``from_flax``).
Tolerances: host-side NumPy (coder, anchors, targets) bit-equal; the losses
1e-6; the head's maps 1e-5, its loss 1e-5 relative, its detections' boxes
1e-5 with labels and validity equal; SpMiddleFHD's BEV 1e-4 of its largest
value, BN statistics 1e-5, ``win_resid`` telemetry equal; the TS step as
``tests/test_torch_distill.py`` (metrics 1e-4 relative, gradients 1e-3 of
their module's largest, BN statistics 1e-5). The window-engine TS step of
the port is held against its own gather-engine step with the same weights
at the same tolerances: the engines compute one operator while every
window plan's residual rows fit their budget (they do here).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): SpMiddleFHD in training,
``tests/test_torch_second_backbone.py`` (gather engine) and
``tests/test_torch_second_window.py``; the teacher-student step,
``tests/test_torch_second_step.py``; IoU, anchors and losses,
``tests/test_torch_second_losses.py``; the anchor head,
``tests/test_torch_second_head.py``; the zoo,
``tests/test_torch_second_recipe.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sparse2dense_tpu.core.box_coder import GroundBox3dCoder as JCoder
from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.models.heads import mg_head as jmg
from sparse2dense_tpu.training.distill import make_ts_train_step as jax_ts_step
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.training.train_state import TrainState
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.core.box_coder import GroundBox3dCoder as TCoder
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.heads import mg_head as tmg
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import _port_grads, _sgd_grads
from tests.test_torch_layers import flax_shapes, rand_variables

CFG = "configs/tests/second_tiny.py"
DCFG = "configs/tests/second_distill_tiny.py"
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6, seed=0)
# the port's telemetry metric -> the reference's (sown per plan, summed)
TELEMETRY = {"telemetry/subm0": "telemetry/backbone/win_resid/[0]",
             "telemetry/down1": "telemetry/backbone/down1/win_resid/[0]"}


# ------------------------------------------------------------ host side

@pytest.mark.parametrize("vec_encode", [False, True])
@pytest.mark.parametrize("nd", [7, 9])
def test_box_coder_against_jax(vec_encode, nd):
    rng = np.random.RandomState(nd + vec_encode)
    anchors = (np.abs(rng.randn(40, nd)) + 0.5).astype(np.float32)
    boxes = (anchors * rng.uniform(0.8, 1.2, anchors.shape)).astype(np.float32)
    kw = dict(vec_encode=vec_encode, n_dim=nd)
    jc, tc = JCoder(**kw), TCoder(**kw)
    enc = tc.encode(boxes, anchors)
    np.testing.assert_array_equal(enc, jc.encode(boxes, anchors))
    dec = tc.decode(enc, anchors)
    np.testing.assert_array_equal(dec, jc.decode(enc, anchors))
    diff = dec - boxes   # the angle back modulo 2 pi (atan2 with vec_encode)
    diff[:, -1] = (diff[:, -1] + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(diff, 0, atol=1e-4 * np.abs(boxes).max())
    # the head decodes torch tensors: as numpy's float32 decode
    got = tc.decode(torch.from_numpy(enc), torch.from_numpy(anchors), xp=torch).numpy()
    np.testing.assert_allclose(got, dec, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def batches():
    jcfg, tcfg = Config.fromfile(DCFG), ConfigDict.fromfile(DCFG)
    return dict(jcfg=jcfg, tcfg=tcfg,
                jbatch=jax_make_batch(jcfg, 2, distillation=True, **FRAME),
                batch=make_batch(tcfg, 2, device="cpu", with_targets=True, distillation=True,
                                 **FRAME))


# ----------------------------------------------------------------- losses

def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    preds = rng.randn(2, 50, 3).astype(np.float32) * 3
    targets = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 50))]
    weights = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    return preds, targets, weights


# ------------------------------------------------------------------ head

@pytest.fixture(scope="module")
def head(batches):
    """The tiny config's MultiGroupHead in both packages on a random BEV map;
    the loss and the detections computed from the JAX head's maps."""
    jcfg, tcfg = batches["jcfg"], batches["tcfg"]
    jhead = jmg.MultiGroupHead(**{k: v for k, v in jcfg.S_model.bbox_head.items()
                                  if k != "type"})
    x = np.random.RandomState(3).randn(2, 4, 4, 64).astype(np.float32)
    variables = rand_variables(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=5)
    jpreds = jhead.apply(variables, jnp.asarray(x))
    thead = tmg.MultiGroupHead(**{k: v for k, v in tcfg.S_model.bbox_head.items()
                                  if k != "type"})
    thead.load_state_dict(from_flax(variables, thead))
    with torch.no_grad():
        preds = thead(torch.from_numpy(x))
    as_torch = [{k: torch.from_numpy(np.asarray(v)) for k, v in pd.items()} for pd in jpreds]
    return dict(jhead=jhead, thead=thead, jpreds=jpreds, preds=preds, as_torch=as_torch)


# -------------------------------------------------------------- backbone


# ---------------------------------------------------- teacher-student step

def _ts_models(tcfg, engine=None):
    if engine:
        for key in ("model", "S_model"):
            tcfg[key]["backbone"].update(engine)
    kw = dict(test_cfg=tcfg.test_cfg, voxel_generator=tcfg.voxel_generator, device="cpu")
    return [build_detector(tcfg[k], **kw) for k in ("model", "S_model")]


def _port_step(tcfg, t_state, s_state, batch, engine=None):
    teacher, student = _ts_models(tcfg, engine)
    teacher.load_state_dict(t_state)
    student.load_state_dict(s_state)
    trainer = TS_Trainer(teacher, student, OneCycleAdam(
        student.parameters(), tcfg.optimizer, tcfg.lr_config, 10,
        tcfg.optimizer_config["grad_clip"]), tcfg.model)
    assert trainer.branch == "second"
    metrics = trainer.step(batch)
    return dict(metrics=metrics, grads=_port_grads(student),
                stats={k: v.clone() for k, v in student.state_dict().items() if "running" in k})


@pytest.fixture(scope="module")
def ts_run():
    """One "second" step at ``second_distill_tiny`` (the gather engine, the
    fixture's default) in each package from one Flax tree; JAX's gradients
    from ``optax.sgd(1.0)``. Then the port's step on the window engine
    (``dense_from_stage`` 1) and on the gather engine at the same
    ``dense_from_stage``, from the same weights."""
    jcfg, tcfg = Config.fromfile(DCFG), ConfigDict.fromfile(DCFG)
    kw = dict(test_cfg=jcfg.test_cfg, voxel_generator=jcfg.voxel_generator)
    jteacher, jstudent = (jax_build_detector(jcfg[k], **kw) for k in ("model", "S_model"))
    jbatch = jax_make_batch(jcfg, 1, distillation=True, **FRAME)
    teacher, student = _ts_models(tcfg)
    t_vars = rand_variables(flax_shapes(teacher), seed=11)
    s_vars = rand_variables(flax_shapes(student, pcr=True), seed=12)
    s_state = TrainState.create(apply_fn=jstudent.apply, params=s_vars["params"],
                                batch_stats=s_vars["batch_stats"], tx=optax.sgd(1.0))
    s_state, jmetrics = jax.jit(jax_ts_step(jteacher, jstudent, "second"))(t_vars, s_state,
                                                                            jbatch)
    t_sd, s_sd = from_flax(t_vars, teacher), from_flax(s_vars, student)
    batch = make_batch(tcfg, 1, device="cpu", with_targets=True, distillation=True, **FRAME)
    runs = {"reference": _port_step(ConfigDict.fromfile(DCFG), t_sd, s_sd, batch)}
    for engine in ("window", "gather"):
        runs[engine] = _port_step(ConfigDict.fromfile(DCFG), t_sd, s_sd, batch,
                                  dict(engine=engine, dense_from_stage=1))
    return dict(jmetrics=jmetrics, runs=runs,
                jgrads=from_flax({"params": _sgd_grads(s_vars["params"], s_state.params)},
                                 student),
                jstats=from_flax({"batch_stats": s_state.batch_stats}, student))


def _compare_metrics(got, want):
    names = {k: TELEMETRY.get(k, k) for k in got}
    assert sorted(names.values()) == sorted(want), (sorted(names.values()), sorted(want))
    for k, jk in names.items():
        np.testing.assert_allclose(float(got[k]), float(want[jk]), rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------- configs

def _plain(x):
    if isinstance(x, (JCoder, TCoder)):
        return sorted(vars(x).items())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


