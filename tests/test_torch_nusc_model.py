"""The nuScenes families' models on the CPU: the tiny nuScenes VoxelNet
(``configs/tests/voxelnet_tiny.py`` with the six nuScenes tasks, the
velocity head, the nuScenes code weights, DCN heads and double flip) and
``configs/tests/nusc_pp_tiny.py`` with circle NMS; the dynamic voxelizer.

The backbone and neck run the port's gather engine, which earlier files
hold against JAX; JAX runs where the operator is new, the DCN heads with
their velocity maps, the double-flip merge and the decode, fed the port's
own neck output, eagerly (XLA's compile of the six DCN heads' unrolled
gathers is what a jitted reference would cost, ~12 CPU-s a head; eval and
train run at one batch shape, so JAX compiles each op once). The heads'
gradients are held against JAX in ``tests/test_torch_nusc_dcn.py`` (the
deformable conv's vjp); here every parameter's gradient must be finite and
the DCN and velocity parameters' nonzero. Tolerances: the DCN heads' maps
and BN statistics 1e-5 (the same input on both sides); detections equal
(valid, labels), boxes and scores 1e-5; loss terms 1e-4 relative; dynamic
voxelization 1e-6 (features), equal coords and masks."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.models.heads import center_head as jhead
from sparse2dense_tpu.ops import dynamic_voxelize as jdv
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.heads.center_head import post_process_task
from sparse2dense_tpu_torch.ops import dynamic_voxelize as tdv
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.train_state import make_train_step
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import eager_cache_fixture, flax_shapes, rand_variables

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached

TINY = "configs/tests/voxelnet_tiny.py"
NUSC_TASKS = [dict(num_class=1, class_names=["car"]),
              dict(num_class=2, class_names=["truck", "construction_vehicle"]),
              dict(num_class=2, class_names=["bus", "trailer"]),
              dict(num_class=1, class_names=["barrier"]),
              dict(num_class=2, class_names=["motorcycle", "bicycle"]),
              dict(num_class=2, class_names=["pedestrian", "traffic_cone"])]
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6)
OFFSET_GAIN = 0.5   # the offset convs' weights times this: offsets of ~2 cells here
TOL = dict(rtol=1e-5, atol=1e-5)


def nusc_tiny(cfg):
    """voxelnet_tiny as a nuScenes model: six tasks, the velocity head and
    code weights, DCN heads, double flip (score threshold 0: the random
    model's heatmaps sit near 0.1)."""
    head = cfg.S_model["bbox_head"]
    head.update(tasks=NUSC_TASKS, dataset="nuscenes", weight=0.25, dcn_head=True,
                code_weights=[1.0] * 6 + [0.2, 0.2, 1.0, 1.0],
                common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2),
                              "vel": (2, 2)})
    cfg.train_cfg["assigner"]["target_assigner"]["tasks"] = NUSC_TASKS
    cfg.test_cfg.update(double_flip=True, score_threshold=0.0)
    return cfg


def tiny_variables(model, seed=3):
    v = rand_variables(flax_shapes(model), seed=seed)
    for t in range(len(NUSC_TASKS)):
        for branch in ("feature_adapt_cls", "feature_adapt_reg"):
            v["params"]["bbox_head"][f"task_{t}"][branch]["conv_offset"]["kernel"] *= OFFSET_GAIN
    return v


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = nusc_tiny(Config.fromfile(TINY)), nusc_tiny(ConfigDict.fromfile(TINY))
    tcfg["class_names"] = [n for t in NUSC_TASKS for n in t["class_names"]]
    model = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                           voxel_generator=tcfg.voxel_generator, device="cpu")
    v = tiny_variables(model)
    model.load_state_dict(from_flax(v, model))
    jmodel = jax_build_detector(jcfg.S_model, test_cfg=jcfg.test_cfg,
                                voxel_generator=jcfg.voxel_generator)
    return dict(jcfg=jcfg, tcfg=tcfg, model=model, v=v, jmodel=jmodel)


def _capture_neck(model):
    seen = []
    handle = model.neck.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    return seen, handle


def _jax_heads(jmodel, v, x, train):
    fn = lambda m, x: m.bbox_head(x, train)   # noqa: E731
    if train:
        return jmodel.apply(v, jnp.asarray(x), method=fn, mutable=["batch_stats"])
    return jmodel.apply(v, jnp.asarray(x), method=fn)


def test_tiny_nusc_voxelnet_double_flip_eval_against_jax(tiny):
    """A frame as 4 views: the DCN heads' maps of every view in eval mode,
    then the merged, decoded frame and its detections (the JAX merge and
    decode on JAX's maps, through the port's NMS, which
    ``tests/test_torch_head_layers.py`` holds against JAX's) against the
    port's predict."""
    model, cfg = tiny["model"], tiny["tcfg"]
    batch = make_batch(cfg, 1, device="cpu", **FRAME)
    assert batch["voxels"].shape[0] == 4
    seen, handle = _capture_neck(model)
    with torch.no_grad():
        out = model(batch)
        det = model.predict(out)
    handle.remove()
    x = seen[0].numpy()   # the neck hands the head NHWC
    want = _jax_heads(tiny["jmodel"], tiny["v"], x, False)
    assert len(want) == len(out["preds"]) == 6
    for t, (jp, tp) in enumerate(zip(want, out["preds"])):
        assert sorted(jp) == sorted(tp) and tp["vel"].shape == (4, 4, 4, 2)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                       err_msg=f"task {t} {k}")
    decode = jax.jit(lambda pd: jhead.decode_preds(jhead.merge_double_flip(pd), cfg.test_cfg))
    rets, flag = [], 0
    for t, jp in enumerate(want):
        boxes, hm = decode(jp)
        r = post_process_task(torch.from_numpy(np.asarray(boxes)),
                              torch.from_numpy(np.asarray(hm)), cfg.test_cfg, t)
        r["label_preds"] = r["label_preds"] + flag
        flag += NUSC_TASKS[t]["num_class"]
        rets.append(r)
    ref = {k: torch.cat([r[k] for r in rets], 1) for k in det}
    assert det["box3d_lidar"].shape == (1, 6 * 8, 9)
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(det[k].numpy(), ref[k].numpy(), err_msg=k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(det[k].numpy(), ref[k].numpy(), **TOL, err_msg=k)
    assert int(det["valid"].sum()) > 20


def test_tiny_nusc_voxelnet_train_step_against_jax(tiny):
    """One ``make_train_step`` at batch 4 on frames with moving boxes: the
    DCN heads' train-mode maps against JAX's on the port's train-mode neck
    output, the loss and its terms against JAX's ``center_head_loss`` of
    them, the heads' BN statistics after the step against JAX's, and the
    gradients."""
    model, cfg = tiny["model"], tiny["tcfg"]
    batch = make_batch(cfg, 4, device="cpu", with_targets=True, **FRAME)
    maps = []
    hooks = [getattr(model.bbox_head, f"task_{t}").register_forward_hook(
        lambda m, i, o: maps.append({k: v.detach() for k, v in o.items()})) for t in range(6)]
    assert max(float(a[..., 6:8].abs().max()) for a in batch["anno_box"]) > 0.5
    seen, handle = _capture_neck(model)
    opt = OneCycleAdam(model.parameters(), cfg.optimizer, cfg.lr_config, 10,
                       cfg.optimizer_config["grad_clip"])
    metrics = make_train_step(model, opt)(batch)
    for h in hooks + [handle]:
        h.remove()
    model.eval()
    x = seen[0].numpy()   # the neck hands the head NHWC
    preds, upd = _jax_heads(tiny["jmodel"], tiny["v"], x, True)
    for t, (jp, tp) in enumerate(zip(preds, maps)):   # the task heads' NCHW maps
        for k in jp:
            np.testing.assert_allclose(tp[k].permute(0, 2, 3, 1).numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=f"task {t} {k}")
    example = {k: [jnp.asarray(a.numpy()) for a in v] for k, v in batch.items()
               if k in ("hm", "anno_box", "ind", "mask", "cat")}
    head = cfg.S_model["bbox_head"]
    total, logs = jax.jit(lambda p, e: jhead.center_head_loss(
        p, e, weight=head["weight"], code_weights=head["code_weights"]))(preds, example)
    want = dict({k: float(v) for k, v in logs.items()}, loss=float(total))
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, err_msg=k)
    assert sum(want[f"loc_loss_{t}"] > 0 for t in range(6)) >= 3
    stats = from_flax({"batch_stats": {"bbox_head": upd["batch_stats"]["bbox_head"]}}, model)
    assert len(stats) == 2 + 6 * 2 * 6
    state = model.state_dict()
    for k, s in stats.items():
        np.testing.assert_allclose(state[k].numpy(), s.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    # a task with no box in the batch has no regression loss: its reg
    # branch gets no gradient
    moving = [t for t in range(6) if want[f"loc_loss_{t}"] > 0]
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        task = int(name.split(".")[1][len("task_"):]) if ".task_" in name else None
        new = ".conv_offset." in name or ".conv_adaption." in name or ".vel_" in name
        if new and ("feature_adapt_cls" in name or task in moving):
            assert float(p.grad.abs().max()) > 0, name
    assert float(metrics["grad_norm"]) > 0


def test_nusc_pp_tiny_with_circle_nms():
    """The nuScenes pillar family (``nusc_pp_tiny``: six tasks, velocity
    head, circle NMS at each task's ``min_radius``), as
    ``tests/test_voxelnet.py:158`` runs it for JAX: maps, a finite loss,
    (2, 6 x 16, 9) boxes with labels offset by task; and the circle NMS
    keeps no two centres of a task within its radius."""
    cfg = ConfigDict.fromfile("configs/tests/nusc_pp_tiny.py")
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 2, device="cpu", with_targets=True, max_voxels=256, n_points=500,
                       n_obj=6)
    model.train()
    out = model(batch)
    assert len(out["preds"]) == 6 and out["preds"][0]["vel"].shape == (2, 16, 16, 2)
    total, _ = model.loss(out, batch)
    assert bool(torch.isfinite(total))
    model.eval()
    with torch.no_grad():
        det = model.predict(model(batch))
    assert det["box3d_lidar"].shape == (2, 96, 9)
    assert int(det["label_preds"].max()) <= 9 and int(det["valid"].sum()) > 6
    radius = cfg.test_cfg["min_radius"]
    for b in range(2):
        for t in range(6):
            sel = det["valid"][b, 16 * t:16 * (t + 1)]
            c = det["box3d_lidar"][b, 16 * t:16 * (t + 1), :2][sel]
            d2 = ((c[:, None] - c[None]) ** 2).sum(-1) + torch.eye(len(c)) * 1e9
            assert bool((d2 >= radius[t] ** 2).all()), (b, t)


def test_dynamic_voxelize_against_jax():
    """Mean voxels at a budget that holds every cell and at one that drops
    the highest; pillar features and the canvas max; invalid and
    out-of-range points."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-9, 9, (3000, 3)), rng.randn(3000, 2)], 1)
    pts[:1500, :3] = np.round(pts[:1500, :3] * 2) / 2 + 0.1   # shared cells
    pts = pts.astype(np.float32)
    valid = rng.rand(3000) > 0.1
    vs, pr, gs = (0.5, 0.5, 0.5), (-8, -8, -2, 8, 8, 4), (32, 32, 12)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    mean = jax.jit(jdv.dynamic_voxelize_mean, static_argnums=(2, 3, 4, 5))
    for budget in (2000, 300):
        want = mean(pts, valid, vs, pr, gs, budget)
        got = tdv.dynamic_voxelize_mean(tp, tv, vs, pr, gs, budget)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 300 <= int(got[2].sum()) <= budget
    want, want_canvas = jax.jit(lambda p, v: (lambda f: (f, jdv.scatter_max_to_canvas(
        f[0], f[1], 32, 32)))(jdv.dynamic_pillar_features(p, v, vs, pr, gs)))(pts, valid)
    got = tdv.dynamic_pillar_features(tp, tv, vs, pr, gs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    canvas = tdv.scatter_max_to_canvas(got[0], got[1], 32, 32)
    np.testing.assert_allclose(canvas.numpy(), np.asarray(want_canvas), rtol=1e-6, atol=1e-6)
