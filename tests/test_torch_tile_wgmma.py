"""B3's host-built wgmma weight layout round trip."""
from sparse2dense_tpu_torch.ops import plane_kernel as TPKK
from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK


def test_tile_kernel_weights_round_trip():
    """The bf16 tile kernel (csrc/tile_subm.cu, B2's wgmma core) reads its
    weights in the same host-built layout, and every (C, Co) it is built for
    is a case of the plane test above."""
    assert TBK.wgmma_weights is TPKK.wgmma_weights
    assert set(TBK.CHANNELS) <= set(TPKK.CHANNELS)
