"""B1's plain version at the widths of the window engine's stages past
conv3_down against JAX's plain reference (``_window_pass_reference``) on
``tests/test_torch_window_conv.py``'s scene: the subm plan at 64->128 and
128->128 and the z-only (3,1,1) strided plan (extra_conv's) at 128->128;
and the CUDA kernel against its plain version at the streamed widths on
the card. The reference reads the port's plan, which is bit-exact with its
own (``tests/test_torch_window_plans.py``,
``tests/test_torch_window_strided_plans.py``): building the reference's
plans eagerly would compile each of their ops again."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops import window_kernel as TWK

from tests.test_torch_window_conv import GRID, TOL, _scene


@functools.lru_cache(maxsize=None)
def _plan(ksize, window):
    """The scene's sorted coords and the port's plan at ``ksize``: the subm
    plan, or the z-only strided one (stride (2, 1, 1), extra_conv's)."""
    feats, coords = _scene(3)
    _, tc, tl = TWC.sort_rows(torch.from_numpy(feats), torch.from_numpy(coords), GRID)
    if ksize == (3, 3, 3):
        return tc, TWC.make_subm_plan_presorted(tl, tc, GRID, window=window, resid_budget=512)
    args = ((2, 1, 1), (0, 0, 0), ksize)
    g_out = (3,) + GRID[1:]
    oc, ol = TWC.downsample_active_set_yxz(tc, (tc >= 0).all(-1), GRID, g_out, *args, 384)
    return tc, TWC.make_strided_plan(tl, ol, oc, GRID, g_out, *args, window=window,
                                     resid_budget=512)


def _case(ksize, window, cin, cout):
    """(features (V, cin), plan, taps (27, cin, cout)) from seeds."""
    coords, plan = _plan(ksize, window)
    valid = (coords >= 0).all(-1, keepdim=True).float()
    feats = torch.from_numpy(np.random.RandomState(cin).randn(len(coords), cin)
                             .astype(np.float32)) * valid
    wz = np.random.RandomState(4).randn(*((cout, cin) + ksize)).astype(np.float32) * 0.2
    return feats, plan, TWC.taps_zyx_to_dyx(torch.from_numpy(wz))


def _jax_plan(plan):
    fields = {f: jnp.asarray(getattr(plan, f).numpy()) for f in JWC.ConvPlan._fields
              if f != "win_sentinel"}
    return JWC.ConvPlan(**fields, win_sentinel=jnp.zeros((plan.window, plan.block)))


@pytest.mark.parametrize("ksize,cin,cout", [((3, 3, 3), 64, 128), ((3, 3, 3), 128, 128),
                                            ((3, 1, 1), 128, 128)])
def test_window_pass_plain_wide_matches_jax(ksize, cin, cout):
    feats, plan, taps = _case(ksize, 128, cin, cout)
    assert int((plan.kbase != TWC.GATE).sum()) and int(plan.n_resid)  # both passes have work
    got = TWK.window_pass(feats, plan, taps, ksize=ksize).numpy()  # CPU: plain version
    want = np.asarray(jax.jit(JWC._window_pass_reference)(
        jnp.asarray(feats.numpy()), _jax_plan(plan), jnp.asarray(taps.numpy())))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.cuda
def test_window_pass_cuda_streamed_widths_match_plain():
    """The CUDA kernel at 64->64, 64->128 and 128->128 (subm and z-only,
    with two window buffers and with one) against its plain version on
    bf16-rounded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for ksize, cin, cout, window in (((3, 3, 3), 64, 64, 128), ((3, 3, 3), 64, 128, 256),
                                     ((3, 3, 3), 128, 128, 128), ((3, 3, 3), 128, 128, 384),
                                     ((3, 1, 1), 128, 128, 128), ((3, 1, 1), 64, 64, 256)):
        feats, plan, taps = _case(ksize, window, cin, cout)
        plan = TWC.ConvPlan(*(x.cuda() if torch.is_tensor(x) else x for x in plan))
        f, w = feats.to(torch.bfloat16).cuda(), taps.to(torch.bfloat16).cuda()
        got = TWK.window_pass(f, plan, w, ksize=ksize)
        want = TWC.window_pass_plain(f.float(), plan, w.float())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
