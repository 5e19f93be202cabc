"""B2 (``csrc/plane_subm.cu``) against its plain version on the card, in
float32 and bf16 (skipped without a GPU)."""
import pytest
import torch

from sparse2dense_tpu_torch.ops import plane_conv as TPK
from sparse2dense_tpu_torch.ops import plane_kernel as TPKK

from tests.test_torch_plane_conv import _conv_case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plane_kernel_cuda_matches_plain(dtype):
    """The CUDA kernel against its plain version on the same (rounded)
    inputs; bf16 within one bf16 rounding step of the f32 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, _, plan, (st, mk, sc, sh, w) = _conv_case(3, 16, 16, True, False, 16)
    dt = getattr(torch, dtype)
    st, mk, w = st.to(dt).cuda(), mk.to(dt).cuda(), w.to(dt).cuda()
    args = (st, plan.tgt.cuda(), w, sc.cuda(), sh.cuda(), TPK.expand_mask(mk, 16))
    got = TPKK.plane_subm(*args, residual=st, relu=True).float()
    want = TPK.plane_subm_plain(*args, residual=st, relu=True).float()
    if dt == torch.float32:
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        tol = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all())
