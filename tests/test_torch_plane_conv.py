"""Port of the plane engine (sparse2dense_tpu_torch/ops/plane_conv.py,
tile_conv.py, tile_planes.py) against the JAX reference on the same numpy
scenes: plane sets, block plans and layout permutations integer bit-exact;
the plain plane conv against the reference's kernel in interpret mode
within 2e-5 (float32, summation order only), also where the plan's windows
drop taps; the chunk-planes downsample and z conv within 1e-5, with the
budget-drop counts equal."""
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
from sparse2dense_tpu_torch.ops import tile_planes as TTP
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


@pytest.mark.parametrize("w", [None, 128, 16])   # full windows, 128 rows, misses
def test_plane_plan_bit_exact(w):
    _, jts, _, tts, _ = _plane_sets(1, 512)
    t1p = TPK.t1p_of(512)
    w = w or t1p
    jp = JPK.make_plane_plan(jts, t1p, w0=w, wy=w)
    tp = TPK.make_plane_plan(tts, t1p, w0=w, wy=w)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert (int(tp.n_miss) > 0) == (w == 16)


def test_batched_plan_bit_exact():
    budget, t1p = 300, TPK.t1p_of(300)
    coords = np.stack([_scene(0), _scene(1)])
    jts = [JPK.build_plane_set(jnp.asarray(c), GRID, budget)[0] for c in coords]
    jstack = JTC.TileSet(*(jnp.stack(f) for f in zip(*jts)))
    jp = JPK.make_plane_plan_batched(jstack, t1p, w0=128, wy=128)
    tp = TPK.make_plane_plan_batched([_ts_torch(j) for j in jts], t1p, 128, 128)
    np.testing.assert_array_equal(tp.ws.numpy(), np.asarray(jp.ws))
    np.testing.assert_array_equal(tp.tgt.numpy(), np.asarray(jp.tgt))
    assert int(tp.n_miss.sum()) == int(jp.n_miss)


def test_chunk_sets_and_permutations_bit_exact():
    """plane set -> covering chunk set -> plane rank of every chunk row and
    chunk row of every plane, plane state <-> chunk planes, and the plane
    set read back from a chunk-planes mask."""
    c, tz, tbud, pbud = 8, 4, 128, 512
    coords, jts, _, tts, _ = _plane_sets(4, pbud)
    t1p = TPK.t1p_of(pbud)
    feats = np.random.RandomState(3).randn(len(coords), c).astype(np.float32)
    jst, jmk = JPK.build_plane_state(jnp.asarray(feats), jnp.asarray(coords), jts, GRID, t1p)
    tst, tmk = TPK.build_plane_state(_t(feats), _t(coords), tts, GRID, t1p)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))

    jct = JPK.chunk_set_of_planes(jts, GRID, tz, tbud)
    tct = TPK.chunk_set_of_planes(tts, GRID, tz, tbud)
    _assert_ts(jct, tct)
    jpo = JPK.plane_ranks_of_chunks(jct, jts, GRID, tz, t1p - 1)
    tpo = TPK.plane_ranks_of_chunks(tct, tts, GRID, tz, t1p - 1)
    np.testing.assert_array_equal(tpo.numpy(), np.asarray(jpo))
    jpl = JPK.plane_state_to_planes(jst, jpo, tz)
    tpl = TPK.plane_state_to_planes(tst, tpo, tz)
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    jml = JPK.plane_state_to_planes(jmk, jpo, tz)                  # (N, 4, 4, 1)

    jcr = JPK.chunk_ranks_of_planes(jts, jct, GRID, tz, tbud)
    tcr = TPK.chunk_ranks_of_planes(tts, tct, GRID, tz, tbud)
    np.testing.assert_array_equal(tcr.numpy(), np.asarray(jcr))
    np.testing.assert_array_equal(TPK.planes_to_plane_state(tpl, tcr, t1p).numpy(),
                                  np.asarray(JPK.planes_to_plane_state(jpl, jcr, t1p)))

    mask4 = np.asarray(jml)
    jps = JPK.plane_set_from_chunk_mask(jnp.asarray(mask4), jct, GRID, tz, pbud)
    tps = TPK.plane_set_from_chunk_mask(_t(mask4), tct, GRID, tz, pbud)
    _assert_ts(jps, tps)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plane_kernel_cuda_matches_plain(dtype):
    """The CUDA kernel against its plain version on the same (rounded)
    inputs; bf16 within one bf16 rounding step of the f32 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, _, plan, (st, mk, sc, sh, w) = _conv_case(3, 16, 16, True, False, 16)
    dt = getattr(torch, dtype)
    st, mk, w = st.to(dt).cuda(), mk.to(dt).cuda(), w.to(dt).cuda()
    args = (st, plan.tgt.cuda(), w, sc.cuda(), sh.cuda(), TPK.expand_mask(mk, 16))
    got = TPKK.plane_subm(*args, residual=st, relu=True).float()
    want = TPK.plane_subm_plain(*args, residual=st, relu=True).float()
    if dt == torch.float32:
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        tol = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all())
