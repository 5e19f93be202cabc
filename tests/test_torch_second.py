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
window plan's residual rows fit their budget (they do here)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sparse2dense_tpu import zoo
from sparse2dense_tpu.core import anchors as janchors
from sparse2dense_tpu.core import box_np_ops as jbox
from sparse2dense_tpu.core.box_coder import GroundBox3dCoder as JCoder
from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.models.backbones.scn import SpMiddleFHD as JSpMiddleFHD
from sparse2dense_tpu.models.heads import mg_head as jmg
from sparse2dense_tpu.models.losses import second_losses as jloss
from sparse2dense_tpu.training.distill import make_ts_train_step as jax_ts_step
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.training.train_state import TrainState
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.core import anchors as tanchors
from sparse2dense_tpu_torch.core import box_np_ops as tbox
from sparse2dense_tpu_torch.core.box_coder import GroundBox3dCoder as TCoder
from sparse2dense_tpu_torch.core.box_coder import build_box_coder
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleFHD
from sparse2dense_tpu_torch.models.heads import mg_head as tmg
from sparse2dense_tpu_torch.models.losses import second_losses as tloss
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.distill import branch_of, make_ts_train_step
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import SECOND, SECOND_DENSE, ConfigDict

from tests.test_torch_distill import _compare_stats, _port_grads, _sgd_grads, assert_grads_close
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


def test_iou_and_anchors_against_jax():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-10, 10, (30, 2)), rng.uniform(0.5, 5, (30, 2)),
                            rng.uniform(-np.pi, np.pi, (30, 1))], 1).astype(np.float32)
    np.testing.assert_array_equal(tbox.nearest_iou_similarity(boxes, boxes[:7]),
                                  jbox.nearest_iou_similarity(boxes, boxes[:7]))
    # the recipe's assigner at its full feature map: 188 x 188 x 6 anchors
    cfg = ConfigDict.fromfile(SECOND)
    ta = tanchors.build_target_assigner(cfg.target_assigner, cfg.box_coder)
    ja = janchors.build_target_assigner(zoo._second_target_assigner(zoo.WAYMO_TASKS),
                                        zoo._SECOND_BOX_CODER)
    got, want = ta.generate_anchors([1, 188, 188]), ja.generate_anchors([1, 188, 188])
    assert got["anchors"].shape == (1, 188, 188, 6, 7)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def batches():
    jcfg, tcfg = Config.fromfile(DCFG), ConfigDict.fromfile(DCFG)
    return dict(jcfg=jcfg, tcfg=tcfg,
                jbatch=jax_make_batch(jcfg, 2, distillation=True, **FRAME),
                batch=make_batch(tcfg, 2, device="cpu", with_targets=True, distillation=True,
                                 **FRAME))


def test_make_batch_anchor_targets_bit_exact(batches):
    """``AssignTarget``'s anchors, labels and regression targets (and the
    voxel streams) equal the reference's."""
    jbatch, batch = batches["jbatch"], batches["batch"]
    assert sorted(jbatch) == sorted(batch)
    for key, want in jbatch.items():
        got = batch[key]
        for w, g in zip(want, got) if isinstance(want, list) else [(want, got)]:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, key
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
    labels = np.asarray(jbatch["labels"][0])
    assert (labels > 0).sum() > 0 and (labels == 0).sum() > 0
    # the anchors alone, in inference (no targets)
    plain = make_batch(batches["tcfg"], 2, device="cpu", **FRAME)
    np.testing.assert_array_equal(plain["anchors"][0].numpy(), np.asarray(jbatch["anchors"][0]))
    assert "labels" not in plain


# ----------------------------------------------------------------- losses

def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    preds = rng.randn(2, 50, 3).astype(np.float32) * 3
    targets = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 50))]
    weights = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    return preds, targets, weights


@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "weighted_smooth_l1",
                                  "weighted_softmax_ce"])
def test_second_losses_against_jax(name):
    preds, targets, weights = _loss_inputs()
    kw = {}
    if name == "weighted_smooth_l1":
        targets = preds + np.random.RandomState(1).randn(*preds.shape).astype(np.float32) * 0.3
        kw = dict(sigma=3.0, code_weights=[1.0, 0.5, 2.0])
    want = np.asarray(getattr(jloss, name)(jnp.asarray(preds), jnp.asarray(targets),
                                           jnp.asarray(weights), **kw))
    got = getattr(tloss, name)(torch.from_numpy(preds), torch.from_numpy(targets),
                               torch.from_numpy(weights), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


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


def test_multigroup_head_forward(head):
    assert sorted(head["preds"][0]) == ["box_preds", "cls_preds", "dir_cls_preds"]
    for jp, tp in zip(head["jpreds"], head["preds"]):
        for k, v in jp.items():
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_mg_head_loss(head, batches):
    want_total, want = jmg.mg_head_loss(head["jhead"], head["jpreds"], batches["jbatch"])
    got_total, got = tmg.mg_head_loss(head["thead"], head["as_torch"], batches["batch"])
    assert sorted(got) == sorted(want) == ["cls_loss_0", "dir_loss_0", "loc_loss_0"]
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)


def test_mg_head_predict(head, batches):
    test_cfg = batches["jcfg"].test_cfg
    want = jmg.mg_head_predict(head["jhead"], head["jpreds"], batches["jbatch"], test_cfg)
    got = tmg.mg_head_predict(head["thead"], head["as_torch"], batches["batch"], test_cfg)
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["label_preds"].numpy(), np.asarray(want["label_preds"]))
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy()[valid], np.asarray(want[k])[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# -------------------------------------------------------------- backbone

@pytest.fixture(scope="module", params=[("gather", 2), ("window", 1)],
                ids=["gather", "window"])
def backbone(request, batches):
    """SpMiddleFHD in train mode on ``second_tiny``'s (25, 32, 32) grid: the
    gather engine at the reference's default ``dense_from_stage`` 2, the
    window engine at the shipped 1; dense stages in float32."""
    engine, dfs = request.param
    grid = (25, 32, 32)
    coords = np.asarray(jax_make_batch(Config.fromfile(CFG), 2, **FRAME)["coordinates"])
    feats = np.random.RandomState(7).randn(*coords.shape[:2], 5).astype(np.float32)
    jmod = JSpMiddleFHD(num_input_features=5, sparse_shape=grid, engine=engine,
                        dense_from_stage=dfs)
    tmod = SpMiddleFHD(num_input_features=5, sparse_shape=grid, engine=engine,
                       dense_from_stage=dfs)
    variables = rand_variables(flax_shapes(tmod), seed=9)
    apply = (jax.jit(lambda v, f, c: jmod.apply(v, f, c, train=True,
                                                mutable=["batch_stats", "telemetry"]))
             if engine == "window" else
             lambda v, f, c: jmod.apply(v, f, c, train=True,
                                        mutable=["batch_stats", "telemetry"]))
    (jbev, _), mutated = apply(variables, jnp.asarray(feats), jnp.asarray(coords))
    tmod.load_state_dict(from_flax(variables, tmod))
    tmod.train()
    bev, conv4, telemetry = tmod(torch.from_numpy(feats), torch.from_numpy(coords))
    return dict(engine=engine, jbev=np.asarray(jbev), bev=bev.detach().numpy(),
                jstats=from_flax({"batch_stats": mutated["batch_stats"]}, tmod),
                stats={k: v for k, v in tmod.state_dict().items() if "running" in k},
                jtelemetry=jax.tree_util.tree_map(np.asarray, mutated.get("telemetry", {})),
                telemetry=telemetry, conv4=conv4)


def test_spmiddlefhd_train_bev(backbone):
    want, got = backbone["jbev"], backbone["bev"]
    assert got.shape == want.shape == (2, 4, 4, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_spmiddlefhd_train_batchnorm_statistics(backbone):
    _compare_stats(backbone["stats"], backbone["jstats"])


def test_spmiddlefhd_telemetry(backbone):
    """Window engine: the residual rows of subm0's and down1's plans, as the
    reference sows them, each within its budget; the gather engine has
    none."""
    tele, jtele = backbone["telemetry"], backbone["jtelemetry"]
    if backbone["engine"] == "gather":
        assert tele == {} and jtele == {}
        return
    assert sorted(tele) == ["down1", "subm0"]
    assert int(tele["subm0"][0].sum()) == int(jtele["win_resid"][0])
    assert int(tele["down1"][0].sum()) == int(jtele["down1"]["win_resid"][0])
    for name, (count, budget) in tele.items():
        assert int(count.max()) <= budget, name


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


def test_branch_of_second():
    assert branch_of(ConfigDict.fromfile(DCFG).model) == "second"
    assert branch_of(ConfigDict.fromfile(SECOND).model) == "second"
    with pytest.raises(ValueError, match="unknown distillation branch"):
        make_ts_train_step(None, None, None, "voxelnext")


def _compare_metrics(got, want):
    names = {k: TELEMETRY.get(k, k) for k in got}
    assert sorted(names.values()) == sorted(want), (sorted(names.values()), sorted(want))
    for k, jk in names.items():
        np.testing.assert_allclose(float(got[k]), float(want[jk]), rtol=1e-4, err_msg=k)


def test_second_ts_step_against_jax(ts_run):
    run, jmetrics = ts_run["runs"]["reference"], ts_run["jmetrics"]
    _compare_metrics(run["metrics"], jmetrics)
    assert "kd_hm_loss" not in run["metrics"] and "T_hm_loss" not in run["metrics"]
    assert float(run["metrics"]["grad_norm"]) > 0
    assert_grads_close(run["grads"], ts_run["jgrads"])
    _compare_stats(run["stats"], ts_run["jstats"])


def test_second_ts_step_window_against_gather(ts_run):
    """The port's window engine against its gather engine: metrics,
    gradients (subm0's and down1's among them, through B1's autograd
    Function on the card) and BN statistics."""
    win, gat = ts_run["runs"]["window"], ts_run["runs"]["gather"]
    assert all(float(win["metrics"][k]) == 0 for k in ("telemetry/subm0", "telemetry/down1"))
    _compare_metrics({k: v for k, v in win["metrics"].items() if not k.startswith("telemetry/")},
                     gat["metrics"])
    assert_grads_close(win["grads"], {k: torch.from_numpy(v) for k, v in gat["grads"].items()})
    for name in ("backbone.subm0.conv_0_weight", "backbone.subm0.conv_1_weight",
                 "backbone.down1.conv_weight"):
        assert np.abs(win["grads"][name]).max() > 0, name
    _compare_stats(win["stats"], gat["stats"])


# ---------------------------------------------------------------- configs

def _plain(x):
    if isinstance(x, (JCoder, TCoder)):
        return sorted(vars(x).items())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("variant,path", [("dense_interval_5", SECOND_DENSE),
                                          ("distill_interval_5", SECOND)])
def test_second_recipe_configs_against_the_zoo(variant, path):
    """The port's two SECOND configs are the reference zoo rows, key for
    key, the data layer's entries included; the one exemption is the
    distillation's teacher checkpoint, which is not in the repository. The
    heads' box coder is its config dict in the port."""
    want, got = zoo.waymo_second(variant), ConfigDict.fromfile(path)
    for key in ("model", "S_model"):
        if key in got:
            head = got[key]["bbox_head"]
            head["box_coder"] = build_box_coder(head["box_coder"])
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key != "load_from":
            assert repr(_plain(value)) == repr(_plain(want[key])), key
    assert got["load_from"] is None
    assert (variant == "distill_interval_5") == bool(got["distillation"])
