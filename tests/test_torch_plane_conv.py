"""Port of the plane engine (sparse2dense_tpu_torch/ops/plane_conv.py,
tile_conv.py, tile_planes.py) against the JAX reference on the same numpy
scenes: plane sets, block plans and layout permutations integer bit-exact;
the plain plane conv against the reference's kernel in interpret mode
within 2e-5 (float32, summation order only), also where the plan's windows
drop taps (the chunk-planes downsample and z conv:
``tests/test_torch_plane_downsample.py``).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the plans,
``tests/test_torch_plane_plans.py`` and
``tests/test_torch_plane_chunk_sets.py``; the plain conv,
``tests/test_torch_plane_conv_kernel.py``; B2 on the card,
``tests/test_torch_plane_kernel_cuda.py``."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sparse2dense_tpu.ops import plane_conv as JPK
from sparse2dense_tpu.ops import tile_conv
from sparse2dense_tpu.ops import tile_planes
from sparse2dense_tpu_torch.ops import plane_conv as TPK
from sparse2dense_tpu_torch.ops import plane_kernel as TPKK
from sparse2dense_tpu_torch.ops import tile_conv as TTC
from tests.test_torch_plane_sets import JitModule

GRID = (8, 32, 32)
TOL = dict(rtol=2e-5, atol=2e-5)
# the reference's chunk-layout functions, jitted one by one
JTC, JTP = JitModule(tile_conv), JitModule(tile_planes)


def _scene(seed, v=500, n_pad=20, grid=GRID):
    rng = np.random.RandomState(seed)
    lin = rng.choice(int(np.prod(grid)), v, replace=False)
    coords = np.stack(np.unravel_index(lin, grid), -1).astype(np.int32)
    coords[-n_pad:] = -1
    return coords


def _t(x):
    return torch.from_numpy(np.array(x))


def _ts_torch(jts):
    return TTC.TileSet(*(_t(a) for a in jts))


def _assert_ts(jts, tts):
    for name, a, b in zip(jts._fields, jts, tts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _plane_sets(seed, budget):
    coords = _scene(seed)
    jts, jin = JPK.build_plane_set(jnp.asarray(coords), GRID, budget)
    tts, tin = TPK.build_plane_set(_t(coords), GRID, budget)
    return coords, jts, jin, tts, tin


@pytest.mark.parametrize("budget", [512, 300])   # drop-free, and over budget
def test_plane_set_bit_exact(budget):
    _, jts, jin, tts, tin = _plane_sets(0, budget)
    _assert_ts(jts, tts)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert (int(tts.n_drop) > 0) == (budget == 300)


def _conv_case(seed, c, co, relu, residual, window=None):
    budget = 512
    coords, jts, _, tts, _ = _plane_sets(seed, budget)
    t1p = TPK.t1p_of(budget)
    rng = np.random.RandomState(seed + 7)
    feats = rng.randn(len(coords), c).astype(np.float32)
    w = (rng.randn(27, c, co) * 0.2).astype(np.float32)
    bias, bn_s, bn_b, bn_m = (rng.randn(co).astype(np.float32) for _ in range(4))
    bn_v = rng.uniform(0.5, 1.5, co).astype(np.float32)
    jst, jmk = JPK.build_plane_state(jnp.asarray(feats), jnp.asarray(coords), jts, GRID, t1p)
    window = window or t1p
    jplan = JPK.make_plane_plan(jts, t1p, w0=window, wy=window)
    jsc, jsh = JPK.fold_epilogue(co, *(jnp.asarray(a) for a in (bias, bn_s, bn_b, bn_m, bn_v)),
                                 eps=1e-3)
    jm16 = JPK.expand_mask(jmk, co)
    want, _ = JPK.pk_subm_conv(jst, JPK.make_plane_exports(jst, c), jplan, jnp.asarray(w),
                               jsc, jsh, jm16, residual=jst if residual else None, relu=relu,
                               w0=window, wy=window, interpret=True)

    tst, tmk = TPK.build_plane_state(_t(feats), _t(coords), tts, GRID, t1p)
    tplan = TPK.make_plane_plan(tts, t1p, w0=window, wy=window)
    tsc, tsh = TPK.fold_epilogue(co, *(_t(a) for a in (bias, bn_s, bn_b, bn_m, bn_v)), eps=1e-3)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh), rtol=1e-6, atol=1e-6)
    got = TPK.pk_subm_conv(tst, tplan, _t(w), tsc, tsh, TPK.expand_mask(tmk, co),
                           residual=tst if residual else None, relu=relu)
    return got, want, tplan, (tst, tmk, tsc, tsh, _t(w))


def test_plane_kernel_wrapper_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        TPKK.plane_subm_cuda(torch.zeros(128, 256), torch.zeros(1, 32, 128, dtype=torch.int32),
                             torch.zeros(27, 16, 16), torch.ones(1, 256), torch.zeros(1, 256),
                             torch.ones(128, 256))


def _chunk_scene(seed, grid, tz, budget, c):
    coords = _scene(seed, v=400, grid=grid)
    cj = jnp.asarray(coords)
    ts, _ = JTC.build_tile_set(cj, grid, 4, 4, tz, budget)
    slot, _ = JTP.row_slots(cj, ts, grid, 4, 4, tz)
    feats = np.random.RandomState(seed).randn(len(coords), c).astype(np.float32)
    y = JTP.scatter_rows(jnp.asarray(feats), slot, ts, tz, 4, 4)
    return y, JTP.build_mask(slot, ts, tz, 4, 4), ts


