"""Port of the windowed sparse conv (sparse2dense_tpu_torch/ops/window_conv.py)
against the JAX reference on the same numpy scenes: plan integers bit-exact,
the plain window pass against ``_window_pass_reference`` and the Pallas
kernel in interpret mode (both residencies), residual and full conv within
rtol = atol = 1e-5 (float32, summation order only).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the plans,
``tests/test_torch_window_plans.py`` (subm) and
``tests/test_torch_window_strided_plans.py``; the window pass, the residual and
the full conv, ``tests/test_torch_window_pass.py``."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops import window_kernel as TWK

from tests.test_torch_layers import eager_cache_fixture
from tests.test_window_conv import _clustered_scene, _pad

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached

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
