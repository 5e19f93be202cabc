"""The window-take probe's rows at any block size and offset, and what its
window starts and CUDA wrapper refuse."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import gather_probes as GP


@pytest.mark.parametrize("blk,offset", [(100, 0), (256, 1), (6, 3)])
def test_window_take_rows_are_the_windows_rows_at_any_blk_and_offset(blk, offset):
    """window_take on the CPU picks row ``min(b*blk, V - w) +
    local[b*blk + r]`` for any blk and for indices that start anywhere in
    their buffer (the card's kernel asks blk a multiple of 4 and aligned
    indices; its rows are chip_smoke.py's to check)."""
    v, c, w, n = 1000, 8, 3 * blk, 1200 if blk == 100 else 16 * blk
    rng = np.random.RandomState(blk)
    feat = torch.from_numpy(rng.randn(v, c).astype(np.float32))
    local = torch.from_numpy(rng.randint(0, w, size=(n + offset,)).astype(np.int32))[offset:]
    got = GP.window_take(feat, local, blk, w)
    want = torch.stack([feat[min(k // blk * blk, v - w) + int(local[k])] for k in range(n)])
    assert torch.equal(got, want)


def test_window_starts_and_the_cuda_wrapper_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of blk"):
        GP.window_starts(1024, 1000, 64, 128)
    with pytest.raises(ValueError, match="0 < w"):
        GP.window_starts(1024, 1024, 64, 2048)
    with pytest.raises(ValueError, match="CUDA"):
        GP.window_take_cuda(torch.zeros(1024, 16), torch.zeros(1024, dtype=torch.int32), 64, 128)
