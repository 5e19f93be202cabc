"""The two-stage recipe's parts on the CPU: ``KD_VoxelNet.forward_two_stage``
(the flagship student as a first stage, on the window engine) against JAX,
the two recipe configs against their zoo rows, and the model-level
training step with a frozen first stage.

Tolerances: the first stage's BEV map and its boxes 1e-4 of JAX's (the
tiny student's head maps' tolerance); its boxes equal its own ``predict``."""
import copy

import numpy as np
import pytest
import torch

import jax

from sparse2dense_tpu import zoo
from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.train_state import make_train_step
from sparse2dense_tpu_torch.utils.config import PP_TWO_STAGE, TWO_STAGE, ConfigDict

from tests.test_torch_layers import flax_shapes, rand_variables
from tests.test_torch_pp import _plain

ENGINE = dict(engine="window", dense_from_stage=1, dense_compute_dtype=None)
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6, seed=0)


def test_kd_voxelnet_forward_two_stage_against_jax():
    """distill_tiny's student on the window engine: the BEV map it hands
    the second stage and its fixed-size boxes against JAX's
    ``forward_two_stage``, and its boxes equal its own ``predict``."""
    cfg_path = "configs/tests/distill_tiny.py"
    jcfg, tcfg = Config.fromfile(cfg_path), ConfigDict.fromfile(cfg_path)
    for cfg in (jcfg, tcfg):
        cfg.S_model["backbone"].update(ENGINE)
    jmodel = jax_build_detector(jcfg.S_model, test_cfg=jcfg.test_cfg,
                                voxel_generator=jcfg.voxel_generator)
    model = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                           voxel_generator=tcfg.voxel_generator, device="cpu")
    variables = rand_variables(flax_shapes(model), seed=7)
    model.load_state_dict(from_flax(variables, model))
    jboxes, jbev, _ = jax.jit(lambda v, b: jmodel.apply(
        v, b, False, method=jmodel.forward_two_stage, mutable=["telemetry"])[0])(
        variables, jax_make_batch(jcfg, 1, with_targets=False, **FRAME))
    batch = make_batch(tcfg, 1, device="cpu", **FRAME)
    with torch.no_grad():
        boxes, bev, preds, telemetry = model.forward_two_stage(batch)
        own = model.predict(model(batch))
    assert bev.shape == tuple(np.shape(jbev)) and not bev.is_contiguous()
    np.testing.assert_allclose(bev.numpy(), np.asarray(jbev), rtol=1e-4, atol=1e-4)
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(boxes[k].numpy(), np.asarray(jboxes[k]), err_msg=k)
        assert torch.equal(boxes[k], own[k]), k
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(boxes[k].numpy(), np.asarray(jboxes[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
        assert torch.equal(boxes[k], own[k]), k
    assert boxes["valid"].any() and "conv1" in telemetry


@pytest.mark.parametrize("row,path", [
    (lambda: zoo.waymo_voxelnet_two_stage("distill_interval_5"), TWO_STAGE),
    (lambda: zoo.waymo_pp_two_stage("distill_interval_5"), PP_TWO_STAGE)],
    ids=["voxelnet", "pp"])
def test_two_stage_configs_against_the_zoo(row, path):
    """The port's two two-stage configs are the zoo rows, key for key (the
    first stages' ``pretrained`` paths too, ignored at build), and build the
    recipe's models at full width."""
    want, got = row(), ConfigDict.fromfile(path)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        assert repr(_plain(value)) == repr(_plain(want[key])), key
    model = build_detector(got.S_model, test_cfg=got.test_cfg,
                           voxel_generator=got.voxel_generator, device="cpu")
    first = got.S_model["first_stage_cfg"]
    assert type(model.single_det).__name__ == first["type"] and model.freeze
    assert not any(p.requires_grad for p in model.single_det.parameters())
    roi = model.roi_head
    assert roi.shared_fc.fc_0.weight.shape == (256, got.S_model["roi_head"]["input_channels"])
    assert roi.cls_layers.out.weight.shape == (1, 256)
    assert roi.reg_layers.out.weight.shape == (7, 256)
    assert float(roi.reg_layers.out.weight.std()) < 2e-3   # normal(0.001)
    assert model.num_point == 5 and model.NMS_POST_MAXSIZE == 500
    assert got.data["samples_per_gpu"] == (6 if path == TWO_STAGE else 4)


def test_model_level_step_trains_the_roi_head_only():
    """``make_train_step`` on the tiny two-stage model with the recipe's
    dropout, the optimizer over the parameters that need a gradient: the
    frozen first stage's parameters and statistics do not move, the RoI
    head's do; every loss finite; the draws (proposals, dropout) come from
    the model's generator, so the same seed gives the same step."""
    cfg = ConfigDict.fromfile("configs/tests/two_stage_tiny.py")
    batch = make_batch(cfg, 2, max_voxels=256, n_points=500, n_obj=3, device="cpu",
                       with_targets=True)

    def one_step(seed):
        model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                               voxel_generator=cfg.voxel_generator, device="cpu")
        model.generator = torch.Generator().manual_seed(seed)
        before = copy.deepcopy(model.state_dict())
        opt = OneCycleAdam([p for p in model.parameters() if p.requires_grad], cfg.optimizer,
                           cfg.lr_config, 10, cfg.optimizer_config["grad_clip"])
        metrics = make_train_step(model, opt)(batch)
        return model, before, {k: float(v) for k, v in metrics.items()}

    model, before, metrics = one_step(4)
    assert {"loss", "grad_norm", "rcnn_loss_cls", "rcnn_loss_reg"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["grad_norm"] > 0
    after = model.state_dict()
    first = [k for k in after if k.startswith("single_det.")]
    roi = [k for k in after if k.startswith("roi_head.")]
    assert all(torch.equal(after[k], before[k]) for k in first)
    assert all(not torch.equal(after[k], before[k]) for k in roi if k.endswith("weight"))
    assert not model.single_det.training and model.roi_head.training
    assert one_step(4)[2] == metrics and one_step(5)[2] != metrics
