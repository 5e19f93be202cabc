"""The gather engine (the reference's default: ``engine="gather"``,
``SubMStage``, ``SparseBasicBlock``, ``SparseDownsample`` over the gather
oracle) against JAX: SpMiddleResNetFHD at ``voxelnet_tiny``'s (25, 32, 32)
grid with ``dense_from_stage`` 0 (here), 2 (the default) and 99 (every
stage sparse, ``extra_conv`` too; ``tests/test_torch_gather_engine_dfs2.py``
and ``_dfs99.py`` run these tests on their own ``backbone``), in eval and in
train mode; and one ``distill_tiny`` teacher-student step with both
backbones on the engine's defaults, as JAX's own training tests run it
(``run``; its tests are in ``tests/test_torch_gather_engine_step.py``).

The backbone gets seeded random voxel features and the coordinates of a
synthetic frame; both packages the same Flax tree (``from_flax``). JAX runs
op by op here (no jit: its gather convs compile slower than they run), the
three ``dense_from_stage`` values' references in one process once a test
session (``jax_refs``: the three share most of their ops' compiles), the
ops' compiles kept in the persistent cache (``eager_compiles_cached``).
Tolerances: the BEV map within 1e-4 of its largest value (float32 sums in
other orders), BN running statistics 1e-5; the step as
``tests/test_torch_distill.py``."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones.scn import SpMiddleResNetFHD as JSpMiddleResNetFHD
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.backbones.scn import (SparseBasicBlock, SparseDownsample,
                                                         SpMiddleResNetFHD, SubMStage)

from tests.test_torch_distill import _compare_stats, ts_and_teacher_steps
from tests.test_torch_layers import (eager_compiles_cached, flax_shapes, rand_variables,
                                     session_shared, to_numpy)

GRID = (25, 32, 32)
DFS = (0, 2, 99)   # this file's, ``_dfs2.py``'s and ``_dfs99.py``'s


@pytest.fixture(scope="module")
def frame():
    coords = np.asarray(jax_make_batch(Config.fromfile("configs/tests/voxelnet_tiny.py"), 2,
                                       max_voxels=512, n_points=3000, n_obj=6)["coordinates"])
    feats = np.random.RandomState(5).randn(*coords.shape[:2], 5).astype(np.float32)
    return feats, coords


@pytest.fixture(scope="module", params=[0], ids=lambda d: f"dfs{d}")
def backbone(request):
    """(dense_from_stage, the JAX module, its variables, the port's twin);
    ``dense_from_stage`` 2 and 99 in ``tests/test_torch_gather_engine_dfs{2,99}.py``."""
    return make_backbone(request.param)


def make_backbone(dfs):
    """(dense_from_stage, the JAX module, its variables, the port's twin)."""
    jmod = JSpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, dense_from_stage=dfs)
    tmod = SpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, dense_from_stage=dfs)
    variables = rand_variables(flax_shapes(tmod), seed=20 + dfs)
    tmod.load_state_dict(from_flax(variables, tmod))
    return dfs, jmod, variables, tmod


def _jax_backbone_refs(frame):
    """JAX's BEV maps of the backbone at each of ``DFS``: in eval mode, and
    in train mode with its BN running statistics."""
    feats, coords = (jnp.asarray(a) for a in frame)
    refs = {}
    with eager_compiles_cached():
        for dfs in DFS:
            _, jmod, variables, _ = make_backbone(dfs)
            bev, _ = jmod.apply(variables, feats, coords, train=False)
            (train_bev, _), mutated = jmod.apply(variables, feats, coords, train=True,
                                                 mutable=["batch_stats"])
            refs[dfs] = dict(eval=np.asarray(bev), train=np.asarray(train_bev),
                             stats=to_numpy(mutated["batch_stats"]))
    return refs


@pytest.fixture(scope="module")
def jax_refs(frame, tmp_path_factory):
    """``_jax_backbone_refs``, once a test session."""
    return session_shared(tmp_path_factory, "gather_backbones",
                          lambda: _jax_backbone_refs(frame))


def test_gather_modules_by_stage(backbone):
    """The stages before ``dense_from_stage`` are the gather engine's."""
    dfs, _, _, tmod = backbone
    assert tmod.engine == "gather"
    assert isinstance(tmod.conv_input, SubMStage) == (dfs > 0)
    assert isinstance(tmod.conv2_down, SparseDownsample) == (dfs >= 1)
    assert isinstance(tmod.conv3_0, SparseBasicBlock) == (dfs > 2)
    assert isinstance(tmod.extra_conv, SparseDownsample) == (dfs > 4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gather_backbone_against_jax(backbone, frame, jax_refs, train):
    dfs, jmod, variables, tmod = backbone
    feats, coords = frame
    ref = jax_refs[dfs]
    jbev = ref["train" if train else "eval"]
    tmod.load_state_dict(from_flax(variables, tmod))
    tmod.train(train)
    with torch.set_grad_enabled(train):
        bev, multi_scale, telemetry = tmod(torch.from_numpy(feats), torch.from_numpy(coords))
    want = np.asarray(jbev)
    assert bev.shape == want.shape == (2, 4, 4, 128) and telemetry == {}
    assert sorted(multi_scale) == ["conv1", "conv2", "conv3", "conv4"]
    np.testing.assert_allclose(bev.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0
    if train:
        _compare_stats({k: v for k, v in tmod.state_dict().items() if "running" in k},
                       from_flax({"batch_stats": ref["stats"]}, tmod))
        bev.square().sum().backward()   # plain autograd through gather_conv
        assert tmod.conv_input.conv_0_weight.grad.abs().max() > 0


@pytest.fixture(scope="module")
def run():
    """``distill_tiny``'s teacher-student step on the configs' own engine
    (gather, ``dense_from_stage`` 2) in each package."""
    return ts_and_teacher_steps({}, teacher_step=False)


