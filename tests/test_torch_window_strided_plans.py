"""The window engine's strided plans against JAX's, bit for bit (moved from
``tests/test_torch_window_conv.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import window_conv as TWC

from tests.test_torch_window_conv import GRID, _assert_plans_equal, _scene, _sorted_both


@pytest.mark.parametrize("stride,padding,ksize", [
    ((2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ((2, 1, 1), (0, 0, 0), (3, 1, 1)),
])
def test_strided_plan_bit_exact(stride, padding, ksize):
    feats, coords = _scene(1)
    (_, jc, jl), (_, tc, tl) = _sorted_both(feats, coords)
    g_out = TWC_grid = tuple((g + 2 * p - k) // s + 1
                             for g, s, p, k in zip(GRID, stride, padding, ksize))
    joc, jol = JWC.downsample_active_set_yxz(jc, jnp.all(jc >= 0, -1), GRID, g_out,
                                             stride, padding, ksize, 400)
    toc, tol = TWC.downsample_active_set_yxz(tc, (tc >= 0).all(-1), GRID, TWC_grid,
                                             stride, padding, ksize, 400)
    np.testing.assert_array_equal(np.asarray(joc), toc.numpy())
    np.testing.assert_array_equal(np.asarray(jol), tol.numpy())
    jp = JWC.make_strided_plan(jl, jol, joc, GRID, g_out, stride, padding, ksize,
                               block=128, window=256, resid_budget=256)
    tp = TWC.make_strided_plan(tl, tol, toc, GRID, g_out, stride, padding, ksize,
                               block=128, window=256, resid_budget=256)
    _assert_plans_equal(jp, tp)
