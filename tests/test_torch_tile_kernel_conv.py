"""The plain tile conv against the reference's tile kernel in interpret mode
within 1e-4 (float32, summation order only), with and without window misses
(moved from ``tests/test_torch_tile_kernel.py``, whose ``_conv_case`` builds
the case)."""
import numpy as np
import pytest

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_tile_kernel import TOL, _conv_case

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


@pytest.mark.parametrize("tz,c,co,relu,residual,window,budget,seed,v", [
    (4, 16, 16, False, False, None, 60, 0, 500),
    (4, 16, 16, True, True, None, 60, 0, 500),
    (2, 32, 16, True, False, None, 100, 1, 500),
    (2, 16, 16, True, True, 16, 124, 7, 800),     # tight windows: the plan drops taps
])
def test_plain_tile_conv_matches_jax_kernel(tz, c, co, relu, residual, window, budget, seed,
                                            v):
    got, want, plan, _ = _conv_case(tz, c, co, relu, residual, window, budget, seed, v)
    assert (int(plan.n_miss) > 0) == (window == 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
