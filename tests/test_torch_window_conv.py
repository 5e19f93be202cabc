"""Port of the windowed sparse conv (sparse2dense_tpu_torch/ops/window_conv.py)
against the JAX reference on the same numpy scenes: plan integers bit-exact,
the plain window pass against ``_window_pass_reference`` and the Pallas
kernel in interpret mode (both residencies), residual and full conv within
rtol = atol = 1e-5 (float32, summation order only)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu.ops.pallas.window_kernel import window_pass_pallas
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops import window_kernel as TWK

from tests.test_window_conv import _clustered_scene, _pad

GRID = (8, 24, 24)
TOL = dict(rtol=1e-5, atol=1e-5)
PLAN_INTS = ("lin", "out_lin", "base", "tap_ok", "ws", "windowed", "resid_rows",
             "resid_nbr", "n_resid", "offsets", "kbase")


def _scene(seed=0):
    feats, coords = _clustered_scene(np.random.RandomState(seed), GRID, 300)
    feats, coords = _pad(feats, coords, 384)
    return feats * (coords >= 0).all(-1, keepdims=True), coords


def _sorted_both(feats, coords):
    jf, jc, jl = JWC.sort_rows(jnp.asarray(feats), jnp.asarray(coords), GRID)
    tf, tc, tl = TWC.sort_rows(torch.from_numpy(feats), torch.from_numpy(coords), GRID)
    return (jf, jc, jl), (tf, tc, tl)


def _assert_plans_equal(jp, tp):
    for name in PLAN_INTS:
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy(), err_msg=name)
    assert (tp.window, tp.block) == (jp.window_size(), jp.block_size())


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


@pytest.mark.parametrize("ksize", [(3, 3, 3), (3, 1, 1)])
def test_taps_zyx_to_dyx(ksize):
    k = int(np.prod(ksize))
    w = np.random.RandomState(2).randn(k, 8, 6).astype(np.float32)
    want = np.asarray(JWC.taps_zyx_to_dyx(jnp.asarray(w), ksize))
    wt = torch.from_numpy(w.reshape(ksize + (8, 6))).permute(4, 3, 0, 1, 2)
    np.testing.assert_array_equal(TWC.taps_zyx_to_dyx(wt).numpy(), want)


def _plans_for(ksize, window):
    feats, coords = _scene(3)
    (jf, jc, jl), (tf, tc, tl) = _sorted_both(feats, coords)
    if ksize == (3, 3, 3):
        jp = JWC.make_subm_plan_presorted(jl, jc, GRID, window=window, resid_budget=512)
        tp = TWC.make_subm_plan_presorted(tl, tc, GRID, window=window, resid_budget=512)
    else:  # z-only strided conv, the extra_conv shape
        args = ((2, 1, 1), (0, 0, 0), ksize)
        g_out = (3,) + GRID[1:]
        joc, jol = JWC.downsample_active_set_yxz(jc, jnp.all(jc >= 0, -1), GRID, g_out,
                                                 *args, 384)
        toc, tol = TWC.downsample_active_set_yxz(tc, (tc >= 0).all(-1), GRID, g_out,
                                                 *args, 384)
        jp = JWC.make_strided_plan(jl, jol, joc, GRID, g_out, *args, window=window,
                                   resid_budget=512)
        tp = TWC.make_strided_plan(tl, tol, toc, GRID, g_out, *args, window=window,
                                   resid_budget=512)
    wz = np.random.RandomState(4).randn(*((6, 8) + ksize)).astype(np.float32) * 0.2
    wt = TWC.taps_zyx_to_dyx(torch.from_numpy(wz))
    return jf, jp, tf, tp, jnp.asarray(wt.numpy()), wt


@pytest.mark.parametrize("ksize,window", [((3, 3, 3), 128), ((3, 3, 3), 256),
                                          ((3, 1, 1), 128)])
def test_window_pass_plain_matches_jax(ksize, window):
    """The plain window pass against the reference's formula and, for the
    z-only strided plan, against its interpret-mode Pallas kernel in both
    residencies; for the 3x3x3 subm plans at windows 128 and 256 the
    reference holds that kernel equal to its formula itself
    (``tests/test_window_kernel.py``, both residencies)."""
    jf, jp, tf, tp, jw, tw = _plans_for(ksize, window)
    got = TWK.window_pass(tf, tp, tw, ksize=ksize).numpy()  # CPU: plain version
    np.testing.assert_allclose(got, np.asarray(JWC._window_pass_reference(jf, jp, jw)), **TOL)
    for residency in ("vmem", "hbm") if ksize == (3, 1, 1) else ():
        want = window_pass_pallas(jf, jp, jw, ksize=ksize, interpret=True,
                                  compute_dtype=jnp.float32, residency=residency)
        np.testing.assert_allclose(got, np.asarray(want), **TOL, err_msg=residency)


def test_residual_and_full_window_conv():
    jf, jp, tf, tp, jw, tw = _plans_for((3, 3, 3), 128)
    assert int(tp.n_resid) > 0  # the residual pass has work
    np.testing.assert_allclose(TWC.residual_conv(tf, tp, tw).numpy(),
                               np.asarray(JWC.residual_conv(jf, jp, jw)), **TOL)
    bias = np.random.RandomState(5).randn(6).astype(np.float32)
    want = JWC.window_conv_reference(jf, jp, jw, jnp.asarray(bias))
    got = TWC.window_conv(tf, tp, tw, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_window_pass_rejects_what_the_kernel_does_not_take():
    _, _, tf, tp, _, tw = _plans_for((3, 3, 3), 128)
    with pytest.raises(ValueError, match="CUDA"):
        TWK.window_pass_cuda(tf, tp, tw)


@pytest.mark.cuda
def test_window_pass_cuda_matches_plain():
    """The CUDA kernel against its plain version on bf16-rounded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, _, tf, tp, _, tw = _plans_for((3, 3, 3), 128)
    tp = TWC.ConvPlan(*(x.cuda() if torch.is_tensor(x) else x for x in tp))
    w = torch.cat([tw, tw, tw], -1)[..., :16].to(torch.bfloat16).cuda()  # Cout 16
    f = tf.to(torch.bfloat16).cuda()
    got = TWK.window_pass(f, tp, w)
    want = TWC.window_pass_plain(f.float(), tp, w.float())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
