"""The pillar scatter's nearest resize (torch's "nearest-exact") against
``jax.image.resize(..., "nearest")`` at the pillar recipe's sizes."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sparse2dense_tpu_torch.models.backbones.scatter import resize_nearest


@pytest.mark.parametrize("size_in,size_out", [(59, 117), (234, 468), (4, 8)])
def test_nearest_resize_against_jax(size_in, size_out):
    """The S2D scatter's resizes at the recipe's sizes (and the tiny
    model's): exact; torch's "nearest" would miss rows at 59 -> 117."""
    x = np.random.RandomState(size_in).randn(1, size_in, size_in, 2).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, size_out, size_out, 2), "nearest"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resize_nearest(t, (size_out, size_out)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if size_in == 59:
        plain = F.interpolate(t, size=(size_out,) * 2, mode="nearest").permute(0, 2, 3, 1)
        assert not np.array_equal(plain.numpy(), want)
