"""A train-mode PlaneKBlock trains (batch statistics, gradients) and the tile
blocks of the inference engine do not (moved from
``tests/test_torch_plane_train.py``, whose ``conv_case`` it uses)."""
import torch

from sparse2dense_tpu_torch.models.backbones.scn import PlaneKBlock, TileKBlock, TileKStage
from sparse2dense_tpu_torch.ops import tile_kernel as TTK

from tests.test_torch_plane_train import conv_case  # noqa: F401 (fixtures)


def test_plane_block_trains_and_the_tile_blocks_do_not(conv_case):
    """Train-mode PlaneKBlock: batch statistics, a gradient on every weight;
    TileKBlock and TileKStage train too (an output, a weight gradient and
    moved BN statistics)."""
    torch.manual_seed(0)
    block = PlaneKBlock(16, 16).train()
    for name in ("conv1_weight", "conv2_weight"):
        torch.nn.init.normal_(getattr(block, name), std=0.05)
    state = conv_case["state"].clone().requires_grad_(True)
    out = block(state, conv_case["mask"], conv_case["plan"])
    out.square().sum().backward()
    assert out.shape == state.shape and bool((out[conv_case["mask"].repeat_interleave(
        16, -1) == 0] == 0).all())
    assert float(block.bn1.running_mean.abs().max()) > 0
    for name, p in block.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    tmask = (torch.rand(4, 128, 16, generator=torch.Generator().manual_seed(1)) < 0.3).float()
    tstate = torch.randn(4, 128, 256) * tmask.repeat_interleave(16, -1)
    tplan = TTK.TKPlan(torch.zeros(1, 9, dtype=torch.int32),
                       torch.full((1, 32, 128), TTK.SENTINEL, dtype=torch.int32),
                       torch.zeros((), dtype=torch.int32))
    for mod in (TileKBlock(16, 16), TileKStage(16, (16,))):
        mod.train()
        convs = [p for p in mod.parameters() if p.dim() == 5]
        for weight in convs:
            torch.nn.init.normal_(weight, std=0.05)
        out = mod(tstate.clone().requires_grad_(True), tmask, tplan)
        out.square().sum().backward()
        assert out.shape == tstate.shape
        assert all(float(weight.grad.abs().max()) > 0 for weight in convs)
        stats = [b for n, b in mod.named_buffers() if n.endswith("running_mean")]
        assert float(stats[0].abs().max()) > 0
