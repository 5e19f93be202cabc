"""The tile-engine slice end to end against JAX: distill_tiny's KD_VoxelNet
student with ``engine="tile"`` and the reference's default backend
``tile_backend="xla"`` at the reference bench's ``dense_from_stage=2``
(conv1 and conv2 as tile convs, the conv2_down and conv3_down strided convs
in the chunk-planes layout, dense from conv3; float32) on the same
synthetic frame and the same (seeded random) weights. The budgets cover the
whole key space of every stage, so no tile drops and no tap is missed: the
reference is exact. JAX runs init shapes, apply and predict once for the
module. The fused backend (``"pallas"``, the reference's tile kernel in
interpret mode) is held against JAX at every stage by
``tests/test_torch_tile_backbone.py``."""
import numpy as np
import pytest

import jax
import torch

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD, TileKBlock
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import rand_variables

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
    variables = rand_variables(lambda: jmodel.init(jax.random.PRNGKey(0), jbatch, train=False),
                               seed=13)
    jout, coll = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, mutable=["telemetry"])
                         )(variables, jbatch)
    jdet = jmodel.predict(jout, jcfg.test_cfg)

    tmodel = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                            voxel_generator=tcfg.voxel_generator, device="cpu")
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


def test_tile_parameters_match_the_window_engine(run):
    """Checkpoints interchange across engines: same names, same shapes."""
    tile = run["tmodel"].backbone.state_dict()
    kw = dict(num_input_features=5, sparse_shape=(41, 32, 32))
    window = SpMiddleResNetFHD(engine="window", dense_from_stage=1, **kw).state_dict()
    assert {k: tuple(v.shape) for k, v in tile.items()} == \
        {k: tuple(v.shape) for k, v in window.items()}


def test_tile_blocks_are_inference_only(run):
    """The tile block of the detector trains: batch statistics and a
    gradient on its weights (its state restored after)."""
    from sparse2dense_tpu_torch.ops import tile_conv as TTC
    from sparse2dense_tpu_torch.ops import tile_kernel as TTK

    block = run["tmodel"].backbone.conv2_0
    assert isinstance(block, TileKBlock)
    saved = {k: v.clone() for k, v in block.state_dict().items()}
    block.train()
    try:
        coords = torch.tensor([[0, 0, 0], [0, 0, 1], [1, 0, 4], [5, 9, 9]])
        sets = [TTC.build_tile_set(coords, (8, 16, 16), 4, 4, 4, 10)[0]]
        plan = TTK.make_block_plan_batched(sets, 128, 128, 128)
        state, mask = TTK.build_state_batched(torch.randn(1, 4, 32), coords[None], sets,
                                              (8, 16, 16), 4, 4, 4, 128)
        out = block(state.requires_grad_(True), mask, plan)
        out.sum().backward()
        assert out.shape == (4, 128, 512) and block.conv1_weight.grad.abs().max() > 0
        assert not torch.equal(block.bn1.running_mean, saved["bn1.running_mean"])
    finally:
        block.eval()
        block.load_state_dict(saved)
        block.zero_grad(set_to_none=True)
