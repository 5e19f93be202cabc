"""The window pass under autograd (``window_kernel.WindowPass``) against
autograd through its plain formula (``window_pass_plain`` + ``residual_conv``)
and against ``jax.grad`` of the reference's ``window_conv(impl="reference")``
on the same numpy scenes and plans: subm plans with dy groups left to the
residual pass (GATE) and without, a strided plan whose last block is
padding, and the z-only (3,1,1) plan. float32; summation order only, so
within 1e-5."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops.window_kernel import WindowPass

from tests.test_window_conv import _clustered_scene, _pad

GRID = (8, 24, 24)
TOL = dict(rtol=1e-5, atol=1e-5)
# (name, ksize, stride, padding, window, out budget); subm when stride is None
CASES = [
    ("subm, GATE groups and residual rows", (3, 3, 3), None, None, 128, None),
    ("subm, every group windowed", (3, 3, 3), None, None, 384, None),
    ("strided, padded last block", (3, 3, 3), (2, 2, 2), (1, 1, 1), 256, 500),
    ("z-only (3,1,1)", (3, 1, 1), (2, 1, 1), (0, 0, 0), 128, 300),
]


def _case(name, ksize, stride, padding, window, budget):
    """(JAX and port sorted features, plans, Conv3d weights, cotangent)."""
    rng = np.random.RandomState([c[0] for c in CASES].index(name))
    feats, coords = _clustered_scene(np.random.RandomState(5), GRID, 300)
    feats, coords = _pad(feats, coords, 384)
    feats = feats * (coords >= 0).all(-1, keepdims=True)
    jf, jc, jl = JWC.sort_rows(jnp.asarray(feats), jnp.asarray(coords), GRID)
    tf, tc, tl = TWC.sort_rows(torch.from_numpy(feats), torch.from_numpy(coords), GRID)
    if stride is None:
        jp = JWC.make_subm_plan_presorted(jl, jc, GRID, window=window, resid_budget=384)
        tp = TWC.make_subm_plan_presorted(tl, tc, GRID, window=window, resid_budget=384)
    else:
        g_out = tuple((g + 2 * p - k) // s + 1 for g, s, p, k in zip(GRID, stride, padding, ksize))
        args = (stride, padding, ksize)
        joc, jol = JWC.downsample_active_set_yxz(jc, jnp.all(jc >= 0, -1), GRID, g_out, *args,
                                                 budget)
        toc, tol = TWC.downsample_active_set_yxz(tc, (tc >= 0).all(-1), GRID, g_out, *args,
                                                 budget)
        jp = JWC.make_strided_plan(jl, jol, joc, GRID, g_out, *args, window=window,
                                   resid_budget=budget)
        tp = TWC.make_strided_plan(tl, tol, toc, GRID, g_out, *args, window=window,
                                   resid_budget=budget)
    w = (rng.randn(*((6, 8) + ksize)) * 0.2).astype(np.float32)
    cot = rng.randn(tp.out_lin.shape[0], 6).astype(np.float32)
    return jf, jp, tf, tp, w, cot


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return request.param, _case(*request.param)


def _port_grads(tf, tp, w, cot, through_function):
    f = tf.clone().requires_grad_(True)
    w5 = torch.from_numpy(w).requires_grad_(True)
    wd = TWC.taps_zyx_to_dyx(w5)
    if through_function:
        main = WindowPass.apply(f, wd, TWC.with_readers(tp), tuple(w.shape[2:]))
    else:
        main = TWC.window_pass_plain(f, tp, wd)
    out = main + TWC.residual_conv(f, tp, wd)
    (out * torch.from_numpy(cot)).sum().backward()
    return f.grad.numpy(), w5.grad.numpy()


def test_the_case_reaches_its_edge(case):
    (name, *_), (_, _, _, tp, _, _) = case
    nb = tp.ws.shape[0]
    if "GATE" in name:
        assert int(tp.n_resid) > 0 and bool((tp.kbase == TWC.GATE).any())
    if "padded" in name:
        assert tp.out_lin.shape[0] < nb * tp.block and int((tp.out_lin == TWC.MISS).sum()) > 0
    assert int(tp.n_resid) <= tp.resid_rows.shape[0]


def test_hits_lie_in_their_windows(case):
    _, (_, _, _, tp, _, _) = case
    hits = TWC.hit_table(tp)
    assert int((hits >= 0).sum()) > 0
    row = torch.arange(hits.shape[0])
    start = tp.ws[row // tp.block].repeat_interleave(9, dim=1)    # (Vo, 27) per dy group
    live = hits >= 0
    assert bool(((hits >= start) & (hits < start + tp.window))[live].all())
    assert bool((tp.lin[hits.clamp(min=0).long()][live] < TWC.MISS).all())


def test_function_matches_autograd_through_the_plain_formula(case):
    _, (_, _, tf, tp, w, cot) = case
    df, dw = _port_grads(tf, tp, w, cot, through_function=True)
    want_df, want_dw = _port_grads(tf, tp, w, cot, through_function=False)
    np.testing.assert_allclose(df, want_df, **TOL)
    np.testing.assert_allclose(dw, want_dw, **TOL)
    assert np.abs(dw).max() > 0 and np.abs(df).max() > 0


def test_window_conv_grad_matches_jax(case):
    (_, ksize, *_), (jf, jp, tf, tp, w, cot) = case
    bias = np.linspace(-0.1, 0.1, 6).astype(np.float32)
    # Conv3d (Cout, Cin, kz, ky, kx) -> the reference's z-major (K, Cin, Cout)
    wz = np.transpose(w, (2, 3, 4, 1, 0)).reshape(-1, 8, 6)

    def jloss(f, wk, b):
        out = JWC.window_conv(f, jp, JWC.taps_zyx_to_dyx(wk, ksize), b, impl="reference",
                              ksize=ksize)
        return jnp.sum(out * cot)

    jdf, jdw, jdb = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jf, jnp.asarray(wz),
                                                                 jnp.asarray(bias))
    f = tf.clone().requires_grad_(True)
    w5 = torch.from_numpy(w).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    out = TWC.window_conv(f, TWC.with_readers(tp), TWC.taps_zyx_to_dyx(w5), b, ksize=ksize)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jdf), **TOL)
    dwz = np.transpose(w5.grad.numpy(), (2, 3, 4, 1, 0)).reshape(-1, 8, 6)
    np.testing.assert_allclose(dwz, np.asarray(jdw), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jdb), **TOL)


def test_reader_table_inverts_the_hit_table(case):
    _, (_, _, _, tp, _, _) = case
    hits, readers = TWC.hit_table(tp), TWC.reader_table(tp)
    assert int((readers >= 0).sum()) == int((hits >= 0).sum())
    o, k = torch.nonzero(hits >= 0, as_tuple=True)
    assert bool((readers[hits[o, k].long(), k] == o).all())


def test_plan_without_a_table_builds_one():
    jf, jp, tf, tp, w, cot = _case(*CASES[0])
    f = tf.clone().requires_grad_(True)
    wd = TWC.taps_zyx_to_dyx(torch.from_numpy(w))
    assert tp.readers is None
    (WindowPass.apply(f, wd, tp, (3, 3, 3)) * torch.from_numpy(cot)).sum().backward()
    g_with = f.grad.clone()
    f.grad = None
    (WindowPass.apply(f, wd, TWC.with_readers(tp), (3, 3, 3)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy(), g_with.numpy())
