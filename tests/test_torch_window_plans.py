"""The window engine's subm plans against JAX's, bit for bit
(moved from ``tests/test_torch_window_conv.py``)."""
import numpy as np
import pytest


from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import window_conv as TWC

from tests.test_torch_window_conv import GRID, _assert_plans_equal, _scene, _sorted_both


@pytest.mark.parametrize("block,window,budget", [
    (128, 128, 512),   # tight window: rows go to the residual pass
    (128, 256, 512),
    (16, 48, 64),      # 16-rank granule, residual rows over budget
])
def test_subm_plan_bit_exact(block, window, budget):
    feats, coords = _scene()
    (jf, jc, jl), (tf, tc, tl) = _sorted_both(feats, coords)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(JWC.build_rank_table(jl, GRID)),
                                  TWC.build_rank_table(tl, GRID).numpy())
    jp = JWC.make_subm_plan_presorted(jl, jc, GRID, block=block, window=window,
                                      resid_budget=budget)
    tp = TWC.make_subm_plan_presorted(tl, tc, GRID, block=block, window=window,
                                      resid_budget=budget)
    _assert_plans_equal(jp, tp)
    if window == 128:
        assert 0 < int(tp.n_resid) <= budget


