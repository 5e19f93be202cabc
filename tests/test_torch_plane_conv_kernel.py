"""The plain plane conv against the reference's plane kernel in interpret
mode within 2e-5 (float32, summation order only), also where the plan's
windows drop taps (moved from ``tests/test_torch_plane_conv.py``, whose
``_conv_case`` builds the case)."""
import numpy as np
import pytest

from tests.test_torch_plane_conv import TOL, _conv_case


@pytest.mark.parametrize("c,co,relu,residual,window", [
    (16, 16, True, True, None),
    (32, 32, True, True, None),
    (16, 32, False, False, None),
    (16, 16, True, True, 16),     # tight windows: the plan drops taps
])
def test_plain_plane_conv_matches_jax_kernel(c, co, relu, residual, window):
    got, want, plan, _ = _conv_case(2, c, co, relu, residual, window)
    assert (int(plan.n_miss) > 0) == (window == 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
