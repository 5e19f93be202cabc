"""SECOND's IoU, anchors and losses against the reference's on the same numpy
inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse2dense_tpu import zoo
from sparse2dense_tpu.core import anchors as janchors
from sparse2dense_tpu.core import box_np_ops as jbox
from sparse2dense_tpu.models.losses import second_losses as jloss
from sparse2dense_tpu_torch.core import anchors as tanchors
from sparse2dense_tpu_torch.core import box_np_ops as tbox
from sparse2dense_tpu_torch.models.losses import second_losses as tloss
from sparse2dense_tpu_torch.utils.config import ConfigDict, SECOND

from tests.test_torch_second import _loss_inputs


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
