"""The tiny two-stage detector (``configs/tests/two_stage_tiny.py``: a
frozen PointPillars first stage, the BEV extractor at 5 points a box, the
RoI head) against JAX on the CPU, its dropout, and ``Trainer.val`` on it.

Both packages get the same batch and the same weights (one Flax tree
through ``from_flax``), with ``DP_RATIO`` 0 in both models (the draws of
the two packages' dropouts cannot match). Tolerances: eval mode, the RoI
head's ``rcnn_cls`` / ``rcnn_reg`` 1e-4, detections equal, boxes and scores
1e-5; training, with JAX's proposal draws given to the port, the sampled
RoIs 1e-5, the loss and its terms 1e-4 (relative), the RoI head's gradients 1e-3 of their module's
largest, the BatchNorm statistics 1e-5. The training batch's gt boxes are
the first stage's own detections, moved a little (a random first stage's
boxes never meet the synthetic objects), so that the sampled RoIs hold
foreground, hard and easy background and every loss term moves."""
import copy
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.roi_heads.roi_head import dropout
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import _compare_stats, _port_grads, assert_grads_close
from tests.test_torch_layers import flax_shapes, rand_variables
from tests.test_torch_val import _config, records  # noqa: F401 (fixture)

CFG = "configs/tests/two_stage_tiny.py"
FRAME = dict(max_voxels=256, n_points=500, n_obj=3)


def no_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["S_model"]["roi_head"]["model_cfg"]["DP_RATIO"] = 0.0
    return cfg


@pytest.fixture(scope="module")
def tiny():
    """Both models from one Flax tree, a batch of 2 in each, and both
    packages' eval-mode outputs and detections."""
    jcfg, tcfg = no_dropout(Config.fromfile(CFG)), no_dropout(ConfigDict.fromfile(CFG))
    jmodel = jax_build_detector(jcfg.S_model, train_cfg=jcfg.train_cfg, test_cfg=jcfg.test_cfg,
                                voxel_generator=jcfg.voxel_generator)
    model = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                           voxel_generator=tcfg.voxel_generator, device="cpu")
    variables = rand_variables(flax_shapes(model), seed=5)
    model.load_state_dict(from_flax(variables, model))
    jbatch = jax_make_batch(jcfg, 2, **FRAME)
    batch = make_batch(tcfg, 2, device="cpu", with_targets=True, **FRAME)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, jbatch)
    jdet = jax.jit(jmodel.predict)(jout)
    with torch.no_grad():
        out = model(batch)
        det = model.predict(out, example=batch)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, model=model, variables=variables,
                jbatch=jbatch, batch=batch, jout=jout, jdet=jdet, out=out, det=det)


def test_eval_forward_and_predict_against_jax(tiny):
    out, jout, det, jdet = tiny["out"], tiny["jout"], tiny["det"], tiny["jdet"]
    assert out["rcnn_cls"].shape == (2, 16, 1) and out["rcnn_reg"].shape == (2, 16, 7)
    for k in ("rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(out["batch"]["roi_features"].shape, (2, 16, 96 * 5))
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(det[k].numpy(), np.asarray(jdet[k]), err_msg=k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(det[k].numpy(), np.asarray(jdet[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    s = det["scores"].numpy()
    assert det["valid"].any() and ((s >= 0) & (s <= 1)).all()
    assert not (s[~det["valid"].numpy()]).any()


def _gt_from_detections(det, batch):
    """The batch with the first stage's first 4 valid detections a sample,
    moved along (0.6, 0.8) by 5 mm, 10 cm, 30 cm and 2 m, appended to its gt boxes (rows after
    the synthetic objects; columns x, y, z, w, l, h, yaw and the 1-based
    class)."""
    gt = batch["gt_boxes_and_cls"].clone()
    for b in range(gt.shape[0]):
        rows = torch.nonzero(det["valid"][b])[:4, 0]
        boxes = det["box3d_lidar"][b, rows].clone()
        scale = torch.tensor([[0.005], [0.1], [0.3], [2.0]])[:len(rows)]
        boxes[:, :2] += scale * torch.tensor([0.6, 0.8])
        n = int((gt[b, :, 3:6] > 0).any(-1).sum())
        gt[b, n:n + len(rows), :7] = boxes
        gt[b, n:n + len(rows), -1] = det["label_preds"][b, rows].float() + 1
    return dict(batch, gt_boxes_and_cls=gt)


def test_train_forward_and_loss_against_jax(tiny):
    """One train-mode forward, the loss and its gradients, JAX's proposal
    draws (``jax.random.uniform(key_b, (R,))`` on each sample's key) given
    to the port: the sampled RoIs (1e-5),
    the loss and its terms, the RoI head's gradients (the frozen first stage
    gets none in either) and every BatchNorm statistic (the first stage's
    unchanged)."""
    model, jmodel = copy.deepcopy(tiny["model"]), tiny["jmodel"]
    batch = _gt_from_detections(tiny["out"]["first_boxes"], tiny["batch"])
    jbatch = dict(tiny["jbatch"], gt_boxes_and_cls=jnp.asarray(batch["gt_boxes_and_cls"].numpy()))
    variables, key = tiny["variables"], jax.random.PRNGKey(3)

    def loss_fn(params):
        out, mutated = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jbatch, train=True, mutable=["batch_stats"],
                                    rngs={"proposal": key})
        loss, logs = jmodel.loss(out, jbatch)
        return loss, (logs, mutated["batch_stats"], out["targets"]["rois"])

    (jloss, (jlogs, jstats, jrois)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    # the key the reference's forward draws from: its first ``make_rng``
    # at the top scope (Flax folds the scope's path and a counter in)
    proposal = jmodel.apply(variables, rngs={"proposal": key},
                            method=lambda m: m.make_rng("proposal"))
    draws = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (16,)))
                                       for k in jax.random.split(proposal, 2)]))
    model.train()
    out = model(batch, rand=draws)
    loss, logs = model.loss(out, batch)
    loss.backward()
    labels = out["targets"]["rcnn_cls_labels"].numpy()
    assert (labels == 1).any() and (labels == 0).any() and (out["targets"]["reg_valid_mask"]
                                                            .sum() > 0)
    # the same RoIs sampled, in the same order (the boxes' tolerance)
    np.testing.assert_allclose(out["targets"]["rois"].detach().numpy(), np.asarray(jrois),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    assert sorted(logs) == sorted(jlogs)
    for k, v in logs.items():
        np.testing.assert_allclose(float(v.detach()), float(jlogs[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert float(logs["rcnn_loss_reg"]) > 0
    grads = _port_grads(model)
    assert not any(np.abs(g).max() for n, g in grads.items() if n.startswith("single_det."))
    roi = {n: g for n, g in grads.items() if n.startswith("roi_head.")}
    assert all(np.abs(g).max() > 0 for g in roi.values())
    assert_grads_close(roi, from_flax({"params": jgrads}, model))
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    _compare_stats(stats, from_flax({"batch_stats": jstats}, model))
    before = tiny["model"].state_dict()
    assert all(torch.equal(v, before[k]) for k, v in stats.items() if k.startswith("single_det."))
    assert not all(torch.equal(v, before[k]) for k, v in stats.items()
                   if k.startswith("roi_head."))


def test_dropout_rate_and_scale():
    """The port's dropout zeros about p of the units, scales the rest by
    1 / (1 - p), draws from the generator it is given (the same draws again
    from the same seed) and runs only in training; the recipe's RoI head
    drops on the shared layers but the last and on the first layer of each
    branch."""
    x = torch.full((400, 256), 2.0)
    y = dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(1 - float(kept.float().mean()) - 0.3) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 2.0 / 0.7, rtol=1e-6)
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(1)))
    cfg = ConfigDict.fromfile(CFG)
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.voxel_generator, device="cpu")
    head = model.roi_head
    feats = torch.randn(2, 16, head.shared_fc.fc_0.in_features,
                        generator=torch.Generator().manual_seed(2))
    acts, inputs = {}, {}
    for name in ("shared_fc", "cls_layers", "reg_layers"):
        stack = getattr(head, name)
        for k in range(2):
            getattr(stack, f"bn_{k}").register_forward_hook(
                lambda m, a, o, key=(name, k): acts.__setitem__(key, torch.relu(o)))
            nxt = getattr(stack, f"fc_{k + 1}") if k == 0 else (
                stack.out if stack.out is not None else head.cls_layers.fc_0)
            nxt.register_forward_pre_hook(
                lambda m, a, key=(name, k): inputs.__setitem__(key, a[0]))
    head.train()
    head(feats, torch.Generator().manual_seed(3))
    dropped = {}
    for key, x in inputs.items():
        act = acts[key]
        live = act != 0
        if torch.equal(x, act):
            dropped[key] = False
            continue
        zeroed = (x == 0) & live
        assert torch.allclose(x[live & ~zeroed], act[live & ~zeroed] / 0.7), key
        assert abs(float(zeroed.sum()) / float(live.sum()) - 0.3) < 0.05, key
        dropped[key] = True
    assert dropped == {("shared_fc", 0): True, ("shared_fc", 1): False,
                       ("cls_layers", 0): True, ("cls_layers", 1): False,
                       ("reg_layers", 0): True, ("reg_layers", 1): False}
    head.eval()
    a, b = head(feats), head(feats)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_trainer_val_equals_the_models_predict(records, tmp_path):  # noqa: F811
    """``Trainer.val`` on the tiny two-stage model over Waymo-layout
    records: the detections it writes are the model's own ``predict`` on
    the same batches, valid-masked and keyed by token."""
    cfg = ConfigDict.fromfile(_config(records, tmp_path, CFG, False))
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.voxel_generator, device="cpu")
    trainer = Trainer(model, OneCycleAdam([p for p in model.parameters() if p.requires_grad],
                                          cfg.optimizer, cfg.lr_config, 4),
                      work_dir=str(tmp_path), hooks=[])
    dataset = tloader.build_dataset(cfg.data["val"])
    loader = tloader.InputPipeline(dataset, 2, 256, shuffle=False, device="cpu")
    model.train()
    result, _ = trainer.val(loader, dataset, output_dir=str(tmp_path / "val"))
    assert model.training and not model.single_det.training
    with open(tmp_path / "val" / "detection_pred.pkl", "rb") as f:
        detections = pickle.load(f)
    model.eval()
    want = {}
    with torch.no_grad():
        for batch in loader:
            out = model.predict(model(batch))
            for b, meta in enumerate(batch["metadata"]):
                m = out["valid"][b]
                want[meta["token"]] = {k: out[k][b][m].numpy()
                                       for k in ("box3d_lidar", "scores", "label_preds")}
    assert sorted(detections) == sorted(want) and len(want) == 4
    for token, det in want.items():
        for k, v in det.items():
            np.testing.assert_array_equal(detections[token][k], v, err_msg=f"{token} {k}")
    assert sum(len(d["scores"]) for d in detections.values()) > 0
    assert 0.0 <= result["local_bev_mAP"] <= 1.0
    assert os.path.exists(tmp_path / "val" / "detection_pred.pkl")
