"""The window pass under autograd on the subm plan with dy groups left to
the residual pass (GATE) (``tests/test_torch_window_grad.py``'s cases): the
case reaches its edge, every hit lies in its window, ``WindowPass``
against autograd through its plain formula, and both against ``jax.grad``
of the reference's ``window_conv``, within 1e-5. The other three cases
import these checks:
``tests/test_torch_window_grad_{windowed,strided,zonly}.py``."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.ops import window_conv as TWC

from tests.test_torch_window_grad import CASES, TOL, _port_grads, case_fixture

case = case_fixture(CASES[0:1])


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
