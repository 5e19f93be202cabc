"""The gather oracle's strided active sets bit-exact against JAX within
their budget (``tests/test_torch_gather_oracle.py``'s scenes), and the
synthetic scene ``training.synthetic.synth_voxels`` equal to the
reference's."""
import numpy as np
import pytest

from sparse2dense_tpu.tools.profile_model import synth_voxels as jax_synth_voxels
from sparse2dense_tpu_torch.training.synthetic import synth_voxels

from tests.test_torch_gather_oracle import STRIDED, check_downsample
from tests.test_torch_layers import eager_cache_fixture

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


@pytest.mark.parametrize("stride,padding,ksize", STRIDED)
@pytest.mark.parametrize("budget", [400])
def test_downsample_bit_exact(stride, padding, ksize, budget):
    check_downsample(stride, padding, ksize, budget)


def test_synth_voxels_equal():
    jf, jc = jax_synth_voxels(2000, seed=1)
    tf, tc = synth_voxels(2000, seed=1)
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jc, tc)
    assert tc.shape == (1, 2000, 3) and (tc[0, :, 0] >= 0).sum() > 1500
