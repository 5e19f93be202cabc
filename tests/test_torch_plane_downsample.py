"""The plane engine's chunk-planes downsample and z conv against the JAX
reference within 1e-5, with the budget-drop counts equal (moved from
``tests/test_torch_plane_conv.py``, whose scenes they use)."""
import numpy as np
import pytest

import jax.numpy as jnp

from sparse2dense_tpu.ops import tile_planes
from sparse2dense_tpu_torch.ops import tile_planes as TTP

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_plane_conv import JTP, _assert_ts, _chunk_scene, _t, _ts_torch

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


@pytest.mark.parametrize("grid,tz,tz_out,pad,budget_out", [
    ((9, 32, 32), 4, 2, (1, 1, 1), 200),   # halving chunks (conv3_down)
    ((9, 32, 32), 4, 2, (1, 1, 1), 40),    # output tiles over budget: drops
    ((11, 16, 16), 2, 6, (0, 1, 1), 40),   # one output chunk (conv4_down)
])
def test_downsample_matches_jax(grid, tz, tz_out, pad, budget_out):
    c, co = 8, 12
    y, mask, ts = _chunk_scene(5, grid, tz, 400, c)
    w = (np.random.RandomState(6).randn(27, c, co) * 0.2).astype(np.float32)
    # eager: jitted, the (tz 2 -> 6) case compiles for ~40 s
    jy, jm, jts, jg, _ = tile_planes.downsample(y, mask, ts, grid, jnp.asarray(w), (3, 3, 3),
                                                pad, tz, tz_out, budget_out)
    ty_, tm, tts, tg = TTP.downsample(_t(y), _t(mask), _ts_torch(ts), grid, _t(w), (3, 3, 3),
                                      pad, tz, tz_out, budget_out)
    assert tg == tuple(jg)
    _assert_ts(jts, tts)
    assert (int(tts.n_drop) > 0) == (budget_out == 40 and tz_out == 2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ty_.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_zconv_matches_jax():
    c, co, d, tz = 8, 12, 5, 6
    y, mask, _ = _chunk_scene(7, (d, 16, 16), tz, 40, c)
    w = (np.random.RandomState(8).randn(3, c, co) * 0.3).astype(np.float32)
    jy, jm = JTP.zconv(y, mask, jnp.asarray(w), d, tz)
    ty_, tm = TTP.zconv(_t(y), _t(mask), _t(w), d, tz)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ty_.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
