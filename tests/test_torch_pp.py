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
their module's largest, BN statistics 1e-5).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): PointPillars' inference and
KD_PointPillars in training, ``tests/test_torch_pp_models.py``; the teacher-
student step, ``tests/test_torch_pp_step.py``; the resize,
``tests/test_torch_pp_resize.py``; the student's builder and ``from_flax``,
``tests/test_torch_pp_student.py``; the pillar count, the zoo and the CLI
chain, ``tests/test_torch_pp_recipe.py``."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.models.backbones.scatter import scatter_to_bev as jscatter
from sparse2dense_tpu.models.readers.pillar_encoder import PillarFeatureNet as JPFN
from sparse2dense_tpu.training.distill import make_ts_train_step as jax_ts_step
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.training.train_state import TrainState
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scatter import scatter_to_bev
from sparse2dense_tpu_torch.models.readers.pillar_encoder import PillarFeatureNet
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import _compare_stats, _port_grads, _sgd_grads
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


# -------------------------------------------------------------- from_flax


# ---------------------------------------------------------------- configs

def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ------------------------------------------------------------ training CLI


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
