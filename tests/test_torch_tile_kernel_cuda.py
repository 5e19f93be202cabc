"""The tile kernel's wrapper refuses what B3 does not take, and B3
(``csrc/tile_subm.cu``) against its plain version on the card (skipped
without a GPU)."""
import pytest

from tests.test_torch_tile_kernel import _conv_case


def test_tile_kernel_wrapper_rejects_what_it_does_not_take():
    import torch

    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK

    with pytest.raises(ValueError, match="CUDA"):
        TBK.tile_subm_cuda(torch.zeros(2, 128, 256), torch.zeros(1, 32, 128, dtype=torch.int32),
                           torch.zeros(27, 16, 16), torch.ones(1, 256), torch.zeros(1, 256),
                           torch.ones(2, 128, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_kernel_cuda_matches_plain(dtype):
    """The CUDA kernel against its plain version on the same (rounded)
    inputs, on a plan with window misses; bf16 within one bf16 rounding step
    of the f32 sums."""
    import torch

    from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
    from sparse2dense_tpu_torch.ops import tile_kernel as TTK

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, _, plan, (st, mk, sc, sh, w) = _conv_case(2, 16, 16, True, False, 16, 124, 7, 800)
    dt = getattr(torch, dtype)
    st, mk, w = st.to(dt).cuda(), mk.to(dt).cuda(), w.to(dt).cuda()
    args = (st, plan.tgt.cuda(), w, sc.cuda(), sh.cuda(), TTK.expand_mask(mk, 16))
    got = TBK.tile_subm(*args, residual=st, relu=True).float()
    want = TTK.tile_subm_plain(*args, residual=st, relu=True).float()
    if dt == torch.float32:
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        tol = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all())
