"""The plain window pass against the reference's window kernel in interpret
mode, and the residual pass and the full window conv against JAX (moved
from ``tests/test_torch_window_conv.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu.ops.pallas.window_kernel import window_pass_pallas
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops import window_kernel as TWK

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_window_conv import TOL, _plans_for

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


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
