"""The port's slice end to end against JAX: distill_tiny's KD_VoxelNet student
(window engine, dense from conv2, float32 dense stages on both sides) on the
same synthetic frame and the same (seeded random) weights. JAX runs init
shapes, apply and predict once for the module.

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the config loader,
``tests/test_torch_config_loader.py``."""
import numpy as np
import pytest

import jax
import torch

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.heads.center_head import decode_preds
from sparse2dense_tpu_torch.ops.nms_suppression import rotated_iou
from sparse2dense_tpu_torch.ops.topk import top_k
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import flax_shapes, rand_variables

CFG = "configs/tests/distill_tiny.py"
SEED = 0
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6, seed=SEED)
ENGINE = dict(engine="window", dense_from_stage=1, dense_compute_dtype=None)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = Config.fromfile(CFG), ConfigDict.fromfile(CFG)
    jcfg.S_model["backbone"].update(ENGINE)
    tcfg.S_model["backbone"].update(ENGINE)
    jmodel = jax_build_detector(jcfg.S_model, test_cfg=jcfg.test_cfg,
                                voxel_generator=jcfg.voxel_generator)
    jbatch = jax_make_batch(jcfg, 1, with_targets=False, **FRAME)
    tmodel = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                            voxel_generator=tcfg.voxel_generator, device="cpu")
    variables = rand_variables(flax_shapes(tmodel), seed=7)
    jout, coll = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, mutable=["telemetry"])
                         )(variables, jbatch)
    jdet = jax.jit(lambda o: jmodel.predict(o, jcfg.test_cfg))(jout)

    tmodel.load_state_dict(from_flax(variables, tmodel))
    tbatch = make_batch(tcfg, 1, device="cpu", **FRAME)
    with torch.no_grad():
        tout = tmodel(tbatch)
        tdet = tmodel.predict(tout)
    return dict(jcfg=jcfg, tcfg=tcfg, jbatch=jbatch, tbatch=tbatch, jout=jout,
                tele=coll["telemetry"]["backbone"], jdet=jdet, tout=tout, tdet=tdet)


def test_make_batch_bit_exact(run):
    for key in ("voxels", "coordinates", "num_points"):
        want = np.asarray(run["jbatch"][key])
        got = run["tbatch"][key].numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert (want > 0).sum() > 200  # a real frame, not all padding


def test_head_maps(run):
    for jp, tp in zip(run["jout"]["preds"], run["tout"]["preds"]):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(run["tout"]["f_s_a"].numpy(), np.asarray(run["jout"]["f_s_a"]),
                               **TOL)


def test_win_resid_telemetry(run):
    tele = run["tout"]["telemetry"]
    assert [int(x) for x in run["tele"]["win_resid"]] == [int(tele["conv1"][0].sum())]
    assert [int(x) for x in run["tele"]["conv2_down"]["win_resid"]] == \
        [int(tele["conv2_down"][0].sum())]
    for n_resid, budget in tele.values():
        assert int(n_resid.max()) <= budget  # the windowed result is exact


def test_predict(run):
    cfg = run["tcfg"].test_cfg
    # no near-ties among the NMS candidates: neither in score order nor in
    # IoU against the threshold, so both frameworks make the same choices
    boxes, hm = decode_preds(run["tout"]["preds"][0], cfg)
    scores, idx = top_k(hm.max(-1).values, cfg["nms"]["nms_pre_max_size"])
    gaps = -np.diff(scores[0].numpy())
    assert gaps.min() > 1e-4
    bev = boxes[0, idx[0]][:, [0, 1, 3, 4, 6]]
    iou = rotated_iou(bev, bev).numpy()
    assert np.abs(iou - cfg["nms"]["nms_iou_threshold"]).min() > 1e-3

    jdet, tdet = run["jdet"], run["tdet"]
    np.testing.assert_array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
    np.testing.assert_array_equal(tdet["label_preds"].numpy(), np.asarray(jdet["label_preds"]))
    np.testing.assert_allclose(tdet["scores"].numpy(), np.asarray(jdet["scores"]), **TOL)
    np.testing.assert_allclose(tdet["box3d_lidar"].numpy(), np.asarray(jdet["box3d_lidar"]),
                               **TOL)
    assert tdet["valid"].sum() > 0
