"""The PointPillars family against JAX: the pillar feature net, the scatter,
the nearest resize of the S2D scatter, PointPillars' inference, the
KD_PointPillars student in train mode with its PCR loss, one "pp"
teacher-student step, ``from_flax`` on the student's eval- and train-mode
trees, the recipe's two configs against their zoo rows, and the training
CLI's pp chain.

The models are ``configs/tests/pp_tiny.py`` (PointPillars on a 32x32 grid)
and a tiny distillation pair written here from its widths: the teacher
pp_tiny, the student KD_PointPillars with ``PointPillarsScatter_S2D``, both
PFNs ending at 64 channels (the S2D scatter's maps are 64 wide, so the
teacher's canvas must be too). Inputs are made from seeded numpy
generators; both packages get the same arrays and the same weights (one
Flax tree through ``from_flax``). Tolerances: the PFN's output and running
statistics 1e-5; the scatter and the resizes exact; head maps 1e-4 with
detections equal (boxes and scores 1e-5); the student's maps and PCR loss
1e-4; the TS step, with one point a pillar (see ``ts_run``), as
``tests/test_torch_distill.py`` (metrics 1e-4 relative, gradients 1e-3 of
their module's largest, BN statistics 1e-5)."""
import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from sparse2dense_tpu import zoo
from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.models.backbones.scatter import scatter_to_bev as jscatter
from sparse2dense_tpu.models.readers.pillar_encoder import PillarFeatureNet as JPFN
from sparse2dense_tpu.training.distill import make_ts_train_step as jax_ts_step
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.training.train_state import TrainState
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scatter import resize_nearest, scatter_to_bev
from sparse2dense_tpu_torch.models.readers.pillar_encoder import PillarFeatureNet
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.distill import branch_of
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import PP, PP_DENSE, ConfigDict

from tests.test_torch_distill import _compare_stats, _port_grads, _sgd_grads, assert_grads_close
from tests.test_torch_layers import flax_shapes, rand_variables

CFG = "configs/tests/pp_tiny.py"
FRAME = dict(max_voxels=256, n_points=3000, n_obj=6, seed=0)
PFN_KW = dict(num_input_features=5, num_filters=(32, 32), voxel_size=(0.5, 0.5, 6.0),
              pc_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 4.0))


def distill_cfg(cfg):
    """The tiny distillation pair from pp_tiny's config (either package's
    loader): teacher pp_tiny, student KD_PointPillars + S2D scatter; both
    PFNs end at 64 channels."""
    cfg = copy.deepcopy(cfg)
    teacher = cfg["S_model"]
    teacher["reader"]["num_filters"] = [32, 64]
    teacher["backbone"]["num_input_features"] = 64
    teacher["neck"]["num_input_features"] = 64
    student = copy.deepcopy(teacher)
    student["type"] = "KD_PointPillars"
    student["backbone"]["type"] = "PointPillarsScatter_S2D"
    cfg["model"], cfg["S_model"] = teacher, student
    cfg["distillation"] = True
    return cfg


# ------------------------------------------------------------ pillar reader

def _pillars(seed=0, b=2, v=48, p=8):
    """(voxels, num_points, coords) with padded points in most pillars and
    padded pillars (num_points 0, coords -1) at the end of each sample; the
    grid's last cell is left free."""
    rng = np.random.RandomState(seed)
    num = rng.randint(1, p + 1, (b, v)).astype(np.int32)
    num[:, -6:] = 0
    voxels = (rng.randn(b, v, p, 5) * np.array([3, 3, 1, 1, 1])).astype(np.float32)
    voxels *= (np.arange(p)[None, None, :] < num[..., None])[..., None]
    cells = np.stack([rng.choice(32 * 32 - 1, v, replace=False) for _ in range(b)])
    coords = np.stack([np.zeros_like(cells), cells // 32, cells % 32], -1).astype(np.int32)
    coords[num == 0] = -1
    return voxels, num, coords


@pytest.fixture(scope="module")
def pfn():
    voxels, num, coords = _pillars()
    jmod = JPFN(**PFN_KW)
    args = tuple(jnp.asarray(a) for a in (voxels, num, coords))
    variables = rand_variables(lambda: jmod.init(jax.random.PRNGKey(0), *args), seed=3)
    jtrain, mutated = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True,
                                                        mutable=["batch_stats"]))(variables, *args)
    jeval = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(variables, *args)
    tmod = PillarFeatureNet(**PFN_KW)
    tmod.load_state_dict(from_flax(variables, tmod))
    targs = tuple(torch.from_numpy(a) for a in (voxels, num, coords))
    pre_max = []
    hook = tmod.pfn_1.norm.register_forward_hook(lambda m, a, out: pre_max.append(out))
    with torch.no_grad():
        tmod.eval()
        teval = tmod(*targs)
        tmod.train()
        ttrain = tmod(*targs)
    hook.remove()
    return dict(num=num, jtrain=np.asarray(jtrain), jeval=np.asarray(jeval), ttrain=ttrain,
                teval=teval, pre_max=pre_max, tmod=tmod,
                jstats=from_flax({"batch_stats": mutated["batch_stats"]}, tmod))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_pillar_feature_net_against_jax(pfn, mode):
    want, got = pfn["j" + mode], pfn["t" + mode].numpy()
    assert got.shape == want.shape == (2, 48, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1.0))
    # the max over points is unmasked: in some real pillar a padded point's
    # value wins a channel, as in the reference
    x = torch.relu(pfn["pre_max"][0 if mode == "eval" else 1])   # (B, V, P, C)
    num = torch.from_numpy(pfn["num"])
    padded = torch.arange(x.shape[2])[None, None, :] >= num[..., None]
    real_max = x.masked_fill(padded[..., None], -1.0).amax(2)
    pad_wins = (x.masked_fill(~padded[..., None], -1.0).amax(2) > real_max) & (num > 0)[..., None]
    assert int(pad_wins.sum()) > 0


def test_pillar_feature_net_running_statistics(pfn):
    stats = {k: v for k, v in pfn["tmod"].state_dict().items() if "running" in k}
    assert len(stats) == 4
    _compare_stats(stats, pfn["jstats"])


# ------------------------------------------------------- scatter, resize

def test_scatter_to_bev_against_jax():
    """Exact; padded pillars (coords -1) dropped, not written to the last
    cell; autograd sees the copy."""
    rng = np.random.RandomState(1)
    voxels, num, coords = _pillars(seed=1)
    feats = rng.randn(*coords.shape[:2], 6).astype(np.float32)
    want = np.asarray(jscatter(jnp.asarray(feats), jnp.asarray(coords), 32, 32))
    f = torch.from_numpy(feats).requires_grad_()
    got = scatter_to_bev(f, torch.from_numpy(coords), 32, 32)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert not got[:, -1, -1].any()
    w = torch.from_numpy(rng.randn(*got.shape).astype(np.float32))
    (got * w).sum().backward()
    c = torch.from_numpy(coords).long()
    real = (c >= 0).all(-1)
    expect = w[torch.arange(2)[:, None], c[..., 1].clamp(min=0), c[..., 2].clamp(min=0)]
    np.testing.assert_array_equal(f.grad.numpy(), (expect * real[..., None]).numpy())


@pytest.mark.parametrize("size_in,size_out", [(59, 117), (234, 468), (4, 8)])
def test_nearest_resize_against_jax(size_in, size_out):
    """The S2D scatter's resizes at the recipe's sizes (and the tiny
    model's): exact; torch's "nearest" would miss rows at 59 -> 117."""
    x = np.random.RandomState(size_in).randn(1, size_in, size_in, 2).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, size_out, size_out, 2), "nearest"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resize_nearest(t, (size_out, size_out)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if size_in == 59:
        plain = F.interpolate(t, size=(size_out,) * 2, mode="nearest").permute(0, 2, 3, 1)
        assert not np.array_equal(plain.numpy(), want)


# ------------------------------------------------------ the models, JAX side

@pytest.fixture(scope="module")
def models():
    return build_models()


def build_models():
    """The tiny pair in each package from one Flax tree; a distillation
    batch of 2 in each."""
    jcfg, tcfg = distill_cfg(Config.fromfile(CFG)), distill_cfg(ConfigDict.fromfile(CFG))
    kw = dict(test_cfg=jcfg.test_cfg, voxel_generator=jcfg.voxel_generator)
    jteacher, jstudent = (jax_build_detector(jcfg[k], **kw) for k in ("model", "S_model"))
    jbatch = jax_make_batch(jcfg, 2, distillation=True, **FRAME)
    tkw = dict(test_cfg=tcfg.test_cfg, voxel_generator=tcfg.voxel_generator, device="cpu")
    teacher, student = (build_detector(tcfg[k], **tkw) for k in ("model", "S_model"))
    t_vars = rand_variables(flax_shapes(teacher), seed=11)
    s_vars = rand_variables(flax_shapes(student, pcr=True), seed=12)
    teacher.load_state_dict(from_flax(t_vars, teacher))
    student.load_state_dict(from_flax(s_vars, student))
    batch = make_batch(tcfg, 2, device="cpu", with_targets=True, distillation=True, **FRAME)
    return dict(jcfg=jcfg, tcfg=tcfg, jteacher=jteacher, jstudent=jstudent, jbatch=jbatch,
                t_vars=t_vars, s_vars=s_vars, teacher=teacher, student=student, batch=batch)


def test_builder_sets_the_pillar_grid(models):
    teacher, student = models["teacher"], models["student"]
    assert teacher.backbone.grid_shape == student.backbone.grid_shape == (32, 32)
    assert teacher.backbone.bev_channels == student.backbone.bev_channels == 64
    assert student.pc_range_full == tuple(models["tcfg"].voxel_generator["range"])
    assert branch_of(models["tcfg"].model) == "pp"


@pytest.fixture(scope="module")
def teacher_run(models):
    jt = models["jteacher"]
    jpreds, jf_a, jf_b = jax.jit(lambda v, b: jt.apply(
        v, b, train=False, return_feature=True, return_recon_feature=True))(
        models["t_vars"], models["jbatch"])
    jdet = jax.jit(lambda p: jt.predict(p, models["jcfg"].test_cfg))(jpreds)
    teacher = models["teacher"].eval()
    with torch.no_grad():
        out = teacher(models["batch"], return_recon_feature=True)
        det = teacher.predict(out)
    return dict(jpreds=jpreds, jf=(jf_a, jf_b), jdet=jdet, out=out, det=det)


def test_point_pillars_inference_maps(teacher_run):
    """The teacher reads the dense stream; its canvas F_a and the
    reconstruction stream's F_b (the PFN's tolerance) and every head map."""
    out = teacher_run["out"]
    for got, want in zip((out["f_a"], out["f_b"]), teacher_run["jf"]):
        want = np.asarray(want)
        assert got.shape == (2, 32, 32, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))
    for pd, jpd in zip(out["preds"], teacher_run["jpreds"]):
        for k, v in jpd.items():
            v = np.asarray(v)
            np.testing.assert_allclose(pd[k].numpy(), v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1.0), err_msg=k)


def test_point_pillars_detections(teacher_run):
    want, got = teacher_run["jdet"], teacher_run["det"]
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["label_preds"].numpy(), np.asarray(want["label_preds"]))
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy()[valid], np.asarray(want[k])[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _ulp_perturbed(tree, seed=1):
    """``tree``'s float leaves times (1 + 2^-23 * N(0, 1)): about one float32
    rounding step of each weight."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 2.0 ** -23 * rng.randn(*np.shape(a)))).astype(np.float32),
        tree)


def _worst_scaled(got, want):
    """max over the tensors of ``got`` of max|got - want| / (largest |want|
    of its module)."""
    scale = {}
    for name in got:
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(np.abs(want[name]).max()))
    return max(float(np.abs(np.asarray(got[n]) - np.asarray(want[n])).max())
               / max(scale[n.rsplit(".", 1)[0]], 1e-30) for n in got)


@pytest.fixture(scope="module")
def student_run(models):
    js = models["jstudent"]
    jout, _ = jax.jit(lambda v, b: js.apply(v, b, train=True, mutable=["batch_stats"]))(
        models["s_vars"], models["jbatch"])
    jpcr = js.pcr_loss(jout, models["jbatch"])
    student = copy.deepcopy(models["student"]).train()
    with torch.no_grad():
        out = student(models["batch"])
        pcr = student.pcr_loss(out, models["batch"])
    return dict(jout=jout, jpcr=jpcr, out=out, pcr=pcr)


def test_kd_point_pillars_train_maps(student_run):
    """F_S_a, F_S_b NHWC; the PCR outputs NCDHW at depth 1 (JAX: NDHWC)."""
    out, jout = student_run["out"], student_run["jout"]
    assert out["gen_offset"].shape == (2, 3, 1, 32, 32)
    assert out["gen_mask"].shape == (2, 1, 1, 32, 32)
    for k in ("f_s_a", "f_s_b", "gen_offset", "gen_mask"):
        got = out[k] if k.startswith("f_") else out[k].permute(0, 2, 3, 4, 1)
        want = np.asarray(jout[k])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1.0), err_msg=k)
    for pd, jpd in zip(out["preds"], jout["preds"]):
        for k, v in jpd.items():
            v = np.asarray(v)
            np.testing.assert_allclose(pd[k].numpy(), v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1.0), err_msg=k)


def test_kd_point_pillars_pcr_loss(student_run):
    for got, want in zip(student_run["pcr"], student_run["jpcr"]):
        assert float(want) > 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_kd_point_pillars_eval_has_no_pcr(models):
    with torch.no_grad():
        out = models["student"].eval()(models["batch"])
    assert out["gen_offset"] is None and out["gen_mask"] is None
    assert out["f_s_a"].shape == (2, 32, 32, 64)


# ---------------------------------------------------- teacher-student step

def one_point_cfg(cfg):
    """``cfg`` with one point a pillar: no padded point slots."""
    cfg = copy.deepcopy(cfg)
    cfg["voxel_generator"]["max_points_in_voxel"] = 1
    return cfg


def ts_steps(models, jcfg, tcfg, batch_size=1):
    """One "pp" step in each package from the one Flax tree (JAX's gradients
    from ``optax.sgd(1.0)``), and JAX's step again on the student's weights
    perturbed by about one float32 rounding step: the reference's own
    float32 spread."""
    jbatch = jax_make_batch(jcfg, batch_size, distillation=True, **FRAME)
    s_vars = models["s_vars"]
    step = jax.jit(jax_ts_step(models["jteacher"], models["jstudent"], "pp"))
    jax_runs = []
    for params in (s_vars["params"], _ulp_perturbed(s_vars["params"])):
        state = TrainState.create(apply_fn=models["jstudent"].apply, params=params,
                                  batch_stats=s_vars["batch_stats"], tx=optax.sgd(1.0))
        state, jmetrics = step(models["t_vars"], state, jbatch)
        jax_runs.append(dict(
            metrics=jmetrics,
            grads=from_flax({"params": _sgd_grads(params, state.params)}, models["student"]),
            stats=from_flax({"batch_stats": state.batch_stats}, models["student"])))
    teacher, student = copy.deepcopy(models["teacher"]), copy.deepcopy(models["student"])
    trainer = TS_Trainer(teacher, student, OneCycleAdam(
        student.parameters(), tcfg.optimizer, tcfg.lr_config, 10,
        tcfg.optimizer_config["grad_clip"]), tcfg.model)
    batch = make_batch(tcfg, batch_size, device="cpu", with_targets=True, distillation=True,
                       **FRAME)
    metrics = trainer.step(batch)
    return dict(branch=trainer.branch, metrics=metrics, grads=_port_grads(student),
                stats={k: v.clone() for k, v in student.state_dict().items() if "running" in k},
                jax=jax_runs[0], jax_perturbed=jax_runs[1])


@pytest.fixture(scope="module")
def ts_run(models):
    """The step at batch 1 with one point a pillar. The tiny pp step is
    ill-conditioned (ReLUs, the max over points and the max-pools put kinks
    within float32 rounding of its data): at pp_tiny's 8 point slots, and
    at batch 2, the reference's own gradients move by a few percent of a
    module's largest value under one rounding step of its weights, and the
    port's distance from it is the same (``python -m tests.test_torch_pp``
    prints both); here the reference is reproducible, and a test says so."""
    return ts_steps(models, one_point_cfg(models["jcfg"]), one_point_cfg(models["tcfg"]))


def test_pp_ts_step_reference_is_reproducible_here(ts_run):
    """The judged fixture: JAX's step on ulp-perturbed weights moves its
    gradients by less than a tenth of the tolerance below."""
    spread = _worst_scaled({k: ts_run["jax_perturbed"]["grads"][k].numpy()
                            for k in ts_run["grads"]},
                           {k: v.numpy() for k, v in ts_run["jax"]["grads"].items()})
    assert spread < 1e-4, spread


def test_pp_ts_step_metrics(ts_run):
    got, want = ts_run["metrics"], ts_run["jax"]["metrics"]
    assert ts_run["branch"] == "pp"
    assert sorted(got) == sorted(want)
    for k in ("kd_hm_loss", "T_hm_loss", "sparse2dense_loss", "mask_loss",
              "reconstruction_loss"):
        assert float(want[k]) > 0, k
    assert "kd_reg_loss" not in got
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)


def test_pp_ts_step_gradients(ts_run):
    assert_grads_close(ts_run["grads"], ts_run["jax"]["grads"])
    for name in ("reader.pfn_0.linear.weight", "backbone.encoder_1a.conv.weight",
                 "backbone.generator_a.conv.weight", "backbone.fusion_sparse.conv.weight",
                 "neck.block_0.down.conv.weight", "bbox_head.task_0.hm_out.weight"):
        assert np.abs(ts_run["grads"][name]).max() > 0, name


def test_pp_ts_step_batchnorm_statistics(ts_run):
    assert any(k.startswith("backbone.generator_a") for k in ts_run["stats"])
    _compare_stats(ts_run["stats"], ts_run["jax"]["stats"])


def test_pillar_batchnorm_counts_pillars_as_the_reference(models):
    """The reference's pillar net sums its BatchNorm statistics over every
    point slot of the real pillars but divides by the number of pillars (its
    mask is one value a pillar), so its mean is P times the slot mean; the
    port copies it (the pillar net's statistics above equal JAX's)."""
    reader = copy.deepcopy(models["student"].reader).train()
    batch = models["batch"]
    norm = reader.pfn_0.norm
    seen = []
    hook = norm.register_forward_hook(lambda m, a, out: seen.append(a[0].detach()))
    before = norm.running_mean.clone()
    with torch.no_grad():
        reader(batch["voxels"], batch["num_points"], batch["coordinates"])
    hook.remove()
    x, real = seen[0], (batch["num_points"] > 0)[..., None, None].float()
    mean = (x * real).sum((0, 1, 2)) / real.sum()
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               (0.99 * before + 0.01 * mean).numpy(), rtol=1e-5, atol=1e-6)
    assert batch["voxels"].shape[2] == 8 and bool((mean.abs() > 0).all())


# -------------------------------------------------------------- from_flax

@pytest.mark.parametrize("train", [False, True], ids=["eval_tree", "train_tree"])
def test_from_flax_on_the_student(models, train):
    """An eval-mode tree lacks the S2D scatter's train-only PCR generators
    (they keep the model's own values); a train-mode tree maps every key.
    The PFN's Dense kernels (in, out) become Linear weights (out, in)."""
    js, student = models["jstudent"], models["student"]
    variables = rand_variables(
        lambda: js.init(jax.random.PRNGKey(2), models["jbatch"], train=train), seed=21)
    gens = {"generator_a", "generator_b", "gen_out", "gen_mask_a", "gen_mask_b"}
    assert (gens <= set(variables["params"]["backbone"])) == train
    sd = from_flax(variables, student)
    own = student.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        if k.startswith("backbone.") and k.split(".")[1] in gens:
            assert torch.equal(v, own[k]) != train, k
    kernel = variables["params"]["reader"]["pfn_0"]["linear"]["kernel"]
    np.testing.assert_array_equal(sd["reader.pfn_0.linear.weight"].numpy(),
                                  np.asarray(kernel).T)


# ---------------------------------------------------------------- configs

def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("variant,path", [("dense_interval_5", PP_DENSE),
                                          ("distill_interval_5", PP)])
def test_pp_recipe_configs_against_the_zoo(variant, path):
    """The port's two pillar configs are the reference zoo rows, key for
    key, the data layer's entries included; the one exemption is the
    distillation's teacher checkpoint, which is not in the repository. At
    full width they build the recipe's models."""
    want, got = zoo.waymo_pp(variant), ConfigDict.fromfile(path)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key != "load_from":
            assert repr(_plain(value)) == repr(_plain(want[key])), key
    assert got["load_from"] is None
    assert (variant == "distill_interval_5") == bool(got["distillation"])
    model = build_detector(got.S_model, test_cfg=got.test_cfg,
                           voxel_generator=got.voxel_generator, device="cpu")
    assert model.backbone.grid_shape == (468, 468)
    assert [getattr(model.reader, f"pfn_{i}").linear.weight.shape for i in (0, 1)] == \
        [(32, 10), (64, 64)]
    assert model.neck.block_2.down.conv.weight.shape == (256, 128, 3, 3)
    assert model.bbox_head.shared_conv.weight.shape[1] == 384


# ------------------------------------------------------------ training CLI

def test_cli_runs_the_pp_recipe_chain(tmp_path):
    """``tools/train.py`` on the tiny pair: the dense teacher writes
    ``epoch_1``, the distillation loads it (``--load_from``), trains and is
    resumed from ``latest``."""
    from sparse2dense_tpu_torch.tools import train as cli
    from sparse2dense_tpu_torch.training.checkpoint import load_checkpoint

    base = open(CFG).read()
    dense = tmp_path / "pp_dense.py"
    dense.write_text(base + "\nS_model['reader']['num_filters'] = [32, 64]\n"
                     "S_model['backbone']['num_input_features'] = 64\n"
                     "S_model['neck']['num_input_features'] = 64\n")
    distil = tmp_path / "pp_distill.py"
    distil.write_text(dense.read_text() + "\nimport copy\nmodel = copy.deepcopy(S_model)\n"
                      "S_model['type'] = 'KD_PointPillars'\n"
                      "S_model['backbone']['type'] = 'PointPillarsScatter_S2D'\n"
                      "distillation = True\n")
    common = ["--device", "cpu", "--max_voxels", "256", "--batch_size", "1"]
    trainer = cli.main([str(dense), "--work_dir", str(tmp_path / "d"), "--synthetic", "1",
                        "--epochs", "1"] + common)
    assert trainer.epoch == 1
    ckpt = str(tmp_path / "d" / "epoch_1")
    work = tmp_path / "s"
    trainer = cli.main([str(distil), "--work_dir", str(work), "--load_from", ckpt,
                        "--synthetic", "2", "--epochs", "1"] + common)
    assert trainer.branch == "pp" and trainer.global_iter == 2
    saved, teacher = load_checkpoint(ckpt)[0]["model"], trainer.teacher.state_dict()
    assert sorted(saved) == sorted(teacher)
    assert all(torch.equal(teacher[k], v) for k, v in saved.items())
    resumed = cli.main([str(distil), "--work_dir", str(work), "--load_from", ckpt,
                        "--synthetic", "2", "--epochs", "2",
                        "--resume_from", str(work / "latest")] + common)
    assert resumed.epoch == 2 and resumed.global_iter == 4
    assert os.readlink(work / "latest") == "epoch_2"


if __name__ == "__main__":
    # the reference's float32 spread on the tiny "pp" step against the
    # port's distance from it: with pp_tiny's 8 point slots a pillar and with
    # one, at batch 1 and 2 (JAX on CPU; ~1 min)
    fixture = build_models()
    for points in (8, 1):
        for b in (1, 2):
            jcfg, tcfg = fixture["jcfg"], fixture["tcfg"]
            if points == 1:
                jcfg, tcfg = one_point_cfg(jcfg), one_point_cfg(tcfg)
            run = ts_steps(fixture, jcfg, tcfg, b)
            ref = {k: v.numpy() for k, v in run["jax"]["grads"].items()}
            own = _worst_scaled({k: run["jax_perturbed"]["grads"][k].numpy()
                                 for k in run["grads"]}, ref)
            port = _worst_scaled(run["grads"], ref)
            print(f"points a pillar {points}, batch {b}: gradients, largest difference over "
                  f"the module's largest value: JAX on ulp-perturbed weights {own:.2e}, "
                  f"port {port:.2e}", flush=True)
