"""The plane-engine slice end to end against JAX: distill_tiny's KD_VoxelNet
student with ``engine="plane"`` (conv1 and conv2_down on the window engine,
conv2..conv4 as fused plane convs, float32) on the same synthetic frame and
the same (seeded random) weights. The budgets cover the whole key space of
every stage, so no plane, chunk or tile can drop and the windows cover every
neighbour: the reference is exact. JAX runs one jitted apply (its plane
kernel in interpret mode) and predict for the module (the variable shapes
read off the port's twin).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the backbone's parameters
against the window engine's and the plane block in training,
``tests/test_torch_plane_blocks.py``."""
import numpy as np
import pytest

import jax
import torch

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import flax_shapes, rand_variables

CFG = "configs/tests/distill_tiny.py"
FRAME = dict(max_voxels=512, n_points=3000, n_obj=6, seed=0)
# grid (41, 32, 32): conv2..conv4 planes (21, 16, 16) -> 336 keys, (11, 8, 8)
# -> 44, (5, 4, 4) -> 5; chunk tiles of tz 4 / 2 / 6 -> 96, 24, 1
ENGINE = dict(engine="plane", dense_compute_dtype=None, tile_budgets=(96, 96, 24, 4),
              plane_budgets=(336, 44, 5), plane_window=10 ** 6)
TOL = dict(rtol=1e-4, atol=1e-4)
COUNTERS = ("plane_drop", "planek_miss", "plane_chunk_drop", "down_drop")


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
    variables = rand_variables(flax_shapes(tmodel), seed=11)
    jout, coll = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, mutable=["telemetry"])
                         )(variables, jbatch)
    jdet = jax.jit(lambda o: jmodel.predict(o, jcfg.test_cfg))(jout)

    tmodel.load_state_dict(from_flax(variables, tmodel))
    with torch.no_grad():
        tout = tmodel(make_batch(tcfg, 1, device="cpu", **FRAME))
        tdet = tmodel.predict(tout)
    return dict(tcfg=tcfg, jout=jout, tele=coll["telemetry"]["backbone"], jdet=jdet,
                tout=tout, tdet=tdet, tmodel=tmodel)


def test_head_maps_and_features(run):
    for jp, tp in zip(run["jout"]["preds"], run["tout"]["preds"]):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(run["tout"]["f_s_a"].numpy(), np.asarray(run["jout"]["f_s_a"]),
                               **TOL)


def test_plane_telemetry_equal_and_zero(run):
    tele, jt = run["tout"]["telemetry"], run["tele"]
    want = {k: sum(int(x) for x in jt[k]) for k in COUNTERS[:3]}
    want["down_drop"] = sum(int(jt[f"conv{i}_down"]["down_drop"][0]) for i in (3, 4))
    for k in COUNTERS:
        counts, budget = tele[k]
        assert (int(counts.sum()), budget) == (want[k], 0), k
        assert want[k] == 0, k
    assert [int(x) for x in jt["win_resid"]] == [int(tele["conv1"][0].sum())]


def test_predict(run):
    jdet, tdet = run["jdet"], run["tdet"]
    np.testing.assert_array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
    np.testing.assert_array_equal(tdet["label_preds"].numpy(), np.asarray(jdet["label_preds"]))
    np.testing.assert_allclose(tdet["scores"].numpy(), np.asarray(jdet["scores"]), **TOL)
    np.testing.assert_allclose(tdet["box3d_lidar"].numpy(), np.asarray(jdet["box3d_lidar"]),
                               **TOL)
    assert tdet["valid"].sum() > 0


