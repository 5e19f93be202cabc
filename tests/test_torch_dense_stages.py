"""The sparse stages' dense counterparts (``tests/test_torch_layers.py``'s
scenes and variables): the subm stage, the basic block and the strided
downsamples against the reference's, float32 within its tolerance."""
import numpy as np
import pytest
import torch

import jax

from sparse2dense_tpu.models.backbones import scn as jscn
from sparse2dense_tpu_torch.models.backbones import scn as tscn

from tests.test_torch_layers import TOL, _dense_scene, load, nhwc, rand_variables


@pytest.mark.parametrize("kind", ["subm_stage", "basic_block", "down", "down_z"])
def test_dense_stages(kind):
    """dense_subm_conv / dense_strided_conv through the stage modules."""
    rng = np.random.RandomState(2)
    x, mask = _dense_scene(rng)
    if kind == "subm_stage":
        jm, tm = jscn.DenseSubMStage((6,)), tscn.DenseSubMStage(4, (6,))
    elif kind == "basic_block":
        jm, tm = jscn.DenseBasicBlock(4), tscn.DenseBasicBlock(4, 4)
    elif kind == "down":
        jm = jscn.DenseDownsample(6, (2, 2, 2), (1, 1, 1))
        tm = tscn.DenseDownsample(4, 6, (2, 2, 2), (1, 1, 1))
    else:
        jm = jscn.DenseDownsample(6, (2, 1, 1), (0, 0, 0), ksize=(3, 1, 1))
        tm = tscn.DenseDownsample(4, 6, (2, 1, 1), (0, 0, 0), (3, 1, 1))
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), x, mask, False))
    tm = load(tm, v)
    want = jm.apply(v, x, mask, False)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
                 torch.from_numpy(np.moveaxis(mask, -1, 1).copy()))
    if kind.startswith("down"):
        np.testing.assert_array_equal(nhwc(got[1]), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
