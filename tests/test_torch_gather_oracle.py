"""Port of the gather oracle (sparse2dense_tpu_torch/ops/sparse_conv.py),
``window_conv.make_subm_plan`` and ``training.synthetic.synth_voxels``
against the JAX reference on the same seeded numpy scenes: index grids,
neighbour tables, active sets and plans bit-exact; the gather conv within
rtol = atol = 1e-5 (float32, summation order only); the synthetic scene
equal."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sparse2dense_tpu.ops import sparse_conv as JSC
from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu.tools.profile_model import synth_voxels as jax_synth_voxels
from sparse2dense_tpu_torch.ops import sparse_conv as TSC
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.training.synthetic import synth_voxels

GRID = (9, 24, 24)
TOL = dict(rtol=1e-5, atol=1e-5)
PLAN_INTS = ("lin", "out_lin", "base", "tap_ok", "ws", "windowed", "resid_rows",
             "resid_nbr", "n_resid", "offsets", "kbase")
STRIDED = [((2, 2, 2), (1, 1, 1), (3, 3, 3)), ((2, 2, 2), (0, 1, 1), (3, 3, 3)),
           ((2, 1, 1), (0, 0, 0), (3, 1, 1))]


def _scene(seed, n=200, pad=40, cin=8):
    """n unique voxels, most of them in a dense box so that neighbours
    exist, and ``pad`` padding rows (-1) interleaved."""
    rng = np.random.RandomState(seed)
    d, h, w = GRID
    z, y, x = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    weight = np.where((y >= 4) & (y < 14) & (x >= 6) & (x < 16), 8.0, 1.0).reshape(-1)
    lin = rng.choice(d * h * w, size=n, replace=False, p=weight / weight.sum())
    coords = np.stack([lin // (h * w), (lin // w) % h, lin % w], -1).astype(np.int32)
    coords = np.concatenate([coords, np.full((pad, 3), -1, np.int32)])[rng.permutation(n + pad)]
    valid = (coords >= 0).all(-1)
    feats = rng.randn(n + pad, cin).astype(np.float32) * valid[:, None]
    return feats, coords, valid


def _eq(j, t, msg=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=msg)


@pytest.mark.parametrize("ksize", [(3, 3, 3), (3, 1, 1)])
def test_index_grid_and_subm_table_bit_exact(ksize):
    _, coords, valid = _scene(0)
    _eq(JSC.ravel_coords(jnp.asarray(coords), GRID), TSC.ravel_coords(torch.from_numpy(coords), GRID))
    jt = JSC.build_index_grid(jnp.asarray(coords), jnp.asarray(valid), GRID)
    tt = TSC.build_index_grid(torch.from_numpy(coords), torch.from_numpy(valid), GRID)
    _eq(jt, tt, "index grid")
    jn = JSC.subm_neighbor_table(jnp.asarray(coords), jnp.asarray(valid), jt, GRID, ksize)
    tn = TSC.subm_neighbor_table(torch.from_numpy(coords), torch.from_numpy(valid), tt, GRID,
                                 ksize)
    _eq(jn, tn, "neighbour table")
    assert int((tn >= 0).sum()) > int(valid.sum()) + 20   # neighbours beside the centre tap


@pytest.mark.parametrize("stride,padding,ksize", STRIDED)
@pytest.mark.parametrize("budget", [400, 60])   # 60: the active set overflows
def test_downsample_bit_exact(stride, padding, ksize, budget):
    _, coords, valid = _scene(1)
    g_out = TSC.conv_out_grid(GRID, stride, padding, ksize)
    joc, jov = JSC.downsample_active_set(jnp.asarray(coords), jnp.asarray(valid), GRID, g_out,
                                         stride, padding, ksize, budget)
    toc, tov = TSC.downsample_active_set(torch.from_numpy(coords), torch.from_numpy(valid),
                                         GRID, g_out, stride, padding, ksize, budget)
    _eq(joc, toc, "out coords")
    _eq(jov, tov, "out valid")
    full, _ = TSC.downsample_active_set(torch.from_numpy(coords), torch.from_numpy(valid),
                                        GRID, g_out, stride, padding, ksize, 10 ** 4)
    n_out = int((full[:, 0] >= 0).sum())
    assert (n_out > budget) == (budget == 60), n_out
    jt = JSC.build_index_grid(jnp.asarray(coords), jnp.asarray(valid), GRID)
    tt = TSC.build_index_grid(torch.from_numpy(coords), torch.from_numpy(valid), GRID)
    jn = JSC.downsample_neighbor_table(joc, jov, jt, GRID, stride, padding, ksize)
    tn = TSC.downsample_neighbor_table(toc, tov, tt, GRID, stride, padding, ksize)
    _eq(jn, tn, "downsample neighbour table")


@pytest.mark.parametrize("strided", [False, True])
def test_gather_conv_matches(strided):
    feats, coords, valid = _scene(2)
    rng = np.random.RandomState(3)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    table = JSC.build_index_grid(jc, jv, GRID)
    if strided:
        stride, padding, ksize = STRIDED[0]
        g_out = TSC.conv_out_grid(GRID, stride, padding, ksize)
        oc, ov = JSC.downsample_active_set(jc, jv, GRID, g_out, stride, padding, ksize, 400)
        nbr = JSC.downsample_neighbor_table(oc, ov, table, GRID, stride, padding, ksize)
    else:
        nbr = JSC.subm_neighbor_table(jc, jv, table, GRID)
    w = rng.randn(27, feats.shape[1], 16).astype(np.float32) * 0.2
    bias = rng.randn(16).astype(np.float32)
    want = JSC.gather_conv(jnp.asarray(feats), nbr, jnp.asarray(w), jnp.asarray(bias))
    got = TSC.gather_conv(torch.from_numpy(feats), torch.from_numpy(np.array(nbr)),
                          torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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


def test_synth_voxels_equal():
    jf, jc = jax_synth_voxels(2000, seed=1)
    tf, tc = synth_voxels(2000, seed=1)
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jc, tc)
    assert tc.shape == (1, 2000, 3) and (tc[0, :, 0] >= 0).sum() > 1500
