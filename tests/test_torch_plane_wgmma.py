"""Host side of the bfloat16 plane and tile subm kernels (csrc/plane_subm.cu,
csrc/tile_subm.cu): the weights in the B-operand layout of their wgmma
(plane_kernel.wgmma_weights) hold every weight once, where the kernels'
shared-memory descriptors read it, and go back to (27, C, Co) bit for bit."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import plane_kernel as TPKK
from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK


@pytest.mark.parametrize("c,co", TPKK.CHANNELS)
def test_wgmma_weights_round_trip_and_layout(c, co):
    w = torch.from_numpy(np.random.RandomState(c).randn(27, c, co).astype(np.float32))
    w = w.to(torch.bfloat16)
    wb = TPKK.wgmma_weights(w)
    assert wb.shape == (27, c // 8, co // 8, 8, 8) and wb.is_contiguous()
    back = wb.permute(0, 1, 4, 2, 3).reshape(27, c, co)
    assert torch.equal(back, w)
    # the kernel's address of weight (k, ci, n): per tap C x Co elements;
    # core matrices (8 n x 8 ci, 128 B) Co / 8 * 128 B apart along ci
    # (LBO) and 128 B apart along n (SBO)
    k, ci, n = np.meshgrid(np.arange(27), np.arange(c), np.arange(co), indexing="ij")
    at = k * c * co + ((ci // 8) * (co // 8) + n // 8) * 64 + (n % 8) * 8 + ci % 8
    flat = wb.reshape(-1)
    assert torch.equal(flat[torch.from_numpy(at.reshape(-1))], w.reshape(-1))


def test_tile_kernel_weights_round_trip():
    """The bf16 tile kernel (csrc/tile_subm.cu, B2's wgmma core) reads its
    weights in the same host-built layout, and every (C, Co) it is built for
    is a case of the plane test above."""
    assert TBK.wgmma_weights is TPKK.wgmma_weights
    assert set(TBK.CHANNELS) <= set(TPKK.CHANNELS)
