"""The run-gather probe's plain version against its interpret-mode Pallas
kernel at three run lengths."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse2dense_tpu_torch.ops import gather_probes as GP

from tests.test_torch_microbench import _pallas_dma, _run_starts, _table


@pytest.mark.parametrize("run_len", [1, 8, 64])
def test_run_gather_plain_equals_pallas_kernel(run_len):
    feat = _table()
    idx = _run_starts(np.random.RandomState(3), run_len)
    want = np.asarray(_pallas_dma(jnp.asarray(feat), jnp.asarray(idx), run_len))
    got = GP.run_gather_plain(torch.from_numpy(feat), torch.from_numpy(idx), run_len)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(                                # microbench.py:398-399
        got.numpy(), np.concatenate([feat[i:i + run_len] for i in idx]))
    assert torch.equal(GP.run_gather(torch.from_numpy(feat), torch.from_numpy(idx), run_len), got)
