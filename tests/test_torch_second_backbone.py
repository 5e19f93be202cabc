"""SpMiddleFHD (SECOND's backbone) in train mode on the gather engine
against JAX's: the BEV map within 1e-4 of its largest value, the BN running
statistics within 1e-5, the telemetry (moved from
``tests/test_torch_second.py``; the window engine's run of these tests is
``tests/test_torch_second_window.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparse2dense_tpu.models.backbones.scn import SpMiddleFHD as JSpMiddleFHD
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleFHD

from tests.test_torch_distill import _compare_stats
from tests.test_torch_layers import flax_shapes, rand_variables
from tests.test_torch_second import CFG, FRAME


@pytest.fixture(scope="module", params=[("gather", 2)], ids=["gather"])
def backbone(request):
    """The gather engine's (the window engine's:
    ``tests/test_torch_second_window.py``)."""
    return make_backbone(*request.param)


def make_backbone(engine, dfs):
    """SpMiddleFHD in train mode on ``second_tiny``'s (25, 32, 32) grid: the
    gather engine at the reference's default ``dense_from_stage`` 2, the
    window engine at the shipped 1; dense stages in float32."""
    grid = (25, 32, 32)
    coords = np.asarray(jax_make_batch(Config.fromfile(CFG), 2, **FRAME)["coordinates"])
    feats = np.random.RandomState(7).randn(*coords.shape[:2], 5).astype(np.float32)
    jmod = JSpMiddleFHD(num_input_features=5, sparse_shape=grid, engine=engine,
                        dense_from_stage=dfs)
    tmod = SpMiddleFHD(num_input_features=5, sparse_shape=grid, engine=engine,
                       dense_from_stage=dfs)
    variables = rand_variables(flax_shapes(tmod), seed=9)
    apply = (jax.jit(lambda v, f, c: jmod.apply(v, f, c, train=True,
                                                mutable=["batch_stats", "telemetry"]))
             if engine == "window" else
             lambda v, f, c: jmod.apply(v, f, c, train=True,
                                        mutable=["batch_stats", "telemetry"]))
    (jbev, _), mutated = apply(variables, jnp.asarray(feats), jnp.asarray(coords))
    tmod.load_state_dict(from_flax(variables, tmod))
    tmod.train()
    bev, conv4, telemetry = tmod(torch.from_numpy(feats), torch.from_numpy(coords))
    return dict(engine=engine, jbev=np.asarray(jbev), bev=bev.detach().numpy(),
                jstats=from_flax({"batch_stats": mutated["batch_stats"]}, tmod),
                stats={k: v for k, v in tmod.state_dict().items() if "running" in k},
                jtelemetry=jax.tree_util.tree_map(np.asarray, mutated.get("telemetry", {})),
                telemetry=telemetry, conv4=conv4)


def test_spmiddlefhd_train_bev(backbone):
    want, got = backbone["jbev"], backbone["bev"]
    assert got.shape == want.shape == (2, 4, 4, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_spmiddlefhd_train_batchnorm_statistics(backbone):
    _compare_stats(backbone["stats"], backbone["jstats"])


def test_spmiddlefhd_telemetry(backbone):
    """Window engine: the residual rows of subm0's and down1's plans, as the
    reference sows them, each within its budget; the gather engine has
    none."""
    tele, jtele = backbone["telemetry"], backbone["jtelemetry"]
    if backbone["engine"] == "gather":
        assert tele == {} and jtele == {}
        return
    assert sorted(tele) == ["down1", "subm0"]
    assert int(tele["subm0"][0].sum()) == int(jtele["win_resid"][0])
    assert int(tele["down1"][0].sum()) == int(jtele["down1"]["win_resid"][0])
    for name, (count, budget) in tele.items():
        assert int(count.max()) <= budget, name
