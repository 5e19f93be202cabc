"""The tile-engine slice end to end against JAX: distill_tiny's KD_VoxelNet
student with ``engine="tile"`` and the reference's default backend
``tile_backend="xla"`` at the reference bench's ``dense_from_stage=2``
(conv1 and conv2 as tile convs, the conv2_down and conv3_down strided convs
in the chunk-planes layout, dense from conv3; float32) on the same
synthetic frame and the same (seeded random) weights. The budgets cover the
whole key space of every stage, so no tile drops and no tap is missed: the
reference is exact. JAX runs one jitted apply and predict for the module
(the variable shapes read off the port's twin). The fused backend
(``"pallas"``) is held against the reference at every stage by
``tests/test_torch_tile_backbone.py`` and ``tests/test_torch_tile_kernel.py``.

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the backbone's parameters
against the window engine's and the tile block in training,
``tests/test_torch_tile_blocks.py``."""
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
# grid (41, 32, 32): chunk tiles of tz 8 / 4 / 2 / 6 on the conv1..conv4
# grids (41, 32, 32), (21, 16, 16), (11, 8, 8), (5, 4, 4) -> 384, 96, 24, 1 keys
ENGINE = dict(engine="tile", tile_backend="xla", dense_from_stage=2,
              dense_compute_dtype=None, tile_budgets=(384, 96, 24, 4), tilek_window=10 ** 6)
TOL = dict(rtol=1e-4, atol=1e-4)
COUNTERS = ("conv1_tile_drop", "tilek_miss", "down_drop")


def counter_sum(tree, name):
    """Sum of every value sowed under ``name`` anywhere in a telemetry tree."""
    total = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            total += counter_sum(v, name)
        elif k == name:
            total += sum(int(x) for x in v)
    return total


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
    variables = rand_variables(flax_shapes(tmodel), seed=13)
    jout, coll = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, mutable=["telemetry"])
                         )(variables, jbatch)
    jdet = jax.jit(lambda o: jmodel.predict(o, jcfg.test_cfg))(jout)

    tmodel.load_state_dict(from_flax(variables, tmodel))
    with torch.no_grad():
        tout = tmodel(make_batch(tcfg, 1, device="cpu", **FRAME))
        tdet = tmodel.predict(tout)
    return dict(jout=jout, tele=coll["telemetry"]["backbone"], jdet=jdet, tout=tout, tdet=tdet,
                tmodel=tmodel)


def test_head_maps_and_features(run):
    for jp, tp in zip(run["jout"]["preds"], run["tout"]["preds"]):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(run["tout"]["f_s_a"].numpy(), np.asarray(run["jout"]["f_s_a"]),
                               **TOL)


def test_tile_telemetry_equal_and_zero(run):
    tele = run["tout"]["telemetry"]
    assert sorted(tele) == sorted(COUNTERS)
    for k in COUNTERS:
        counts, budget = tele[k]
        want = counter_sum(run["tele"], k)
        assert (int(counts.sum()), budget) == (want, 0), k
        assert want == 0, k


def test_predict(run):
    jdet, tdet = run["jdet"], run["tdet"]
    np.testing.assert_array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
    np.testing.assert_array_equal(tdet["label_preds"].numpy(), np.asarray(jdet["label_preds"]))
    np.testing.assert_allclose(tdet["scores"].numpy(), np.asarray(jdet["scores"]), **TOL)
    np.testing.assert_allclose(tdet["box3d_lidar"].numpy(), np.asarray(jdet["box3d_lidar"]),
                               **TOL)
    assert tdet["valid"].sum() > 0


