"""The gather oracle's batched forms and the window engine's subm plan
against JAX, bit for bit (moved from ``tests/test_torch_gather_oracle.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse2dense_tpu.ops import sparse_conv as JSC
from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import sparse_conv as TSC
from sparse2dense_tpu_torch.ops import window_conv as TWC

from tests.test_torch_gather_oracle import GRID, PLAN_INTS, STRIDED, TOL, _eq, _scene
from tests.test_torch_layers import eager_cache_fixture

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_batched_forms_match():
    scenes = [_scene(4), _scene(5)]
    feats = np.stack([s[0] for s in scenes])
    coords = np.stack([s[1] for s in scenes])
    valid = np.stack([s[2] for s in scenes])
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    tc, tv = torch.from_numpy(coords), torch.from_numpy(valid)
    jt = JSC.build_index_grid_batched(jc, jv, GRID)
    tt = TSC.build_index_grid_batched(tc, tv, GRID)
    _eq(jt, tt, "index grids")
    jn = JSC.subm_neighbor_table_batched(jc, jv, jt, GRID)
    tn = TSC.subm_neighbor_table_batched(tc, tv, tt, GRID)
    _eq(jn, tn, "subm tables")
    stride, padding, ksize = STRIDED[0]
    g_out = TSC.conv_out_grid(GRID, stride, padding, ksize)
    joc, jov = JSC.downsample_active_set_batched(jc, jv, GRID, g_out, stride, padding, ksize, 300)
    toc, tov = TSC.downsample_active_set_batched(tc, tv, GRID, g_out, stride, padding, ksize, 300)
    _eq(joc, toc, "out coords")
    _eq(jov, tov, "out valid")
    jd = JSC.downsample_neighbor_table_batched(joc, jov, jt, GRID, stride, padding, ksize)
    td = TSC.downsample_neighbor_table_batched(toc, tov, tt, GRID, stride, padding, ksize)
    _eq(jd, td, "downsample tables")
    w = np.random.RandomState(6).randn(27, feats.shape[2], 8).astype(np.float32) * 0.2
    for jtab, ttab in ((jn, tn), (jd, td)):
        want = JSC.gather_conv_batched(jnp.asarray(feats), jtab, jnp.asarray(w))
        got = TSC.gather_conv_batched(torch.from_numpy(feats), ttab, torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for b in range(2):   # the batched form is the per-sample form
            np.testing.assert_allclose(
                got[b].numpy(), TSC.gather_conv(torch.from_numpy(feats[b]), ttab[b],
                                                torch.from_numpy(w)).numpy(), **TOL)


@pytest.mark.parametrize("block,window,budget", [(128, 128, 64), (16, 32, 8)])
def test_make_subm_plan_bit_exact(block, window, budget):
    feats, coords, _ = _scene(7)
    jf, jc, jp = JWC.make_subm_plan(jnp.asarray(feats), jnp.asarray(coords), GRID, block=block,
                                    window=window, resid_budget=budget)
    tf, tc, tp = TWC.make_subm_plan(torch.from_numpy(feats), torch.from_numpy(coords), GRID,
                                    block=block, window=window, resid_budget=budget)
    _eq(jf, tf, "sorted features")
    _eq(jc, tc, "sorted coords")
    for name in PLAN_INTS:
        _eq(getattr(jp, name), getattr(tp, name), name)
    assert (tp.window, tp.block) == (jp.window_size(), jp.block_size())
    assert int(tp.n_resid) > 0
    # the presorted plan of the sorted rows is the same plan
    tp2 = TWC.make_subm_plan_presorted(TWC.yxz_lin(tc, GRID), tc, GRID, block=block,
                                       window=window, resid_budget=budget)
    for name in PLAN_INTS:
        assert torch.equal(getattr(tp, name), getattr(tp2, name)), name
