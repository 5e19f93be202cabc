"""The plane engine's detector in the port alone (moved from
``tests/test_torch_plane_detector.py``, whose ``run`` fixture also runs the
reference): its backbone's state has the window engine's names and shapes
(checkpoints interchange), and its plane block trains (batch statistics, a gradient
on its weights). Here ``run`` builds only the port's model, with the same
config and seeded weights."""
import pytest
import torch

from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD, TileKBlock
from sparse2dense_tpu_torch.ops import plane_conv as PK
from sparse2dense_tpu_torch.ops import tile_kernel as TTK
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import flax_shapes, rand_variables
from tests.test_torch_plane_detector import CFG, ENGINE


@pytest.fixture(scope="module")
def run():
    tcfg = ConfigDict.fromfile(CFG)
    tcfg.S_model["backbone"].update(ENGINE)
    tmodel = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                            voxel_generator=tcfg.voxel_generator, device="cpu")
    tmodel.load_state_dict(from_flax(rand_variables(flax_shapes(tmodel), seed=11), tmodel))
    return dict(tmodel=tmodel)


def test_plane_parameters_match_the_window_engine(run):
    """Checkpoints interchange across engines: same names, same shapes."""
    plane = run["tmodel"].backbone.state_dict()
    kw = dict(num_input_features=5, sparse_shape=(41, 32, 32))
    window = SpMiddleResNetFHD(engine="window", dense_from_stage=1, **kw).state_dict()
    assert {k: tuple(v.shape) for k, v in plane.items()} == \
        {k: tuple(v.shape) for k, v in window.items()}


def test_plane_blocks_are_inference_only(run):
    """The plane block trains (batch statistics, a gradient on its weights);
    so does the tile block, which shares its code."""
    block = run["tmodel"].backbone.conv2_0
    saved = {k: v.clone() for k, v in block.state_dict().items()}
    block.train()
    try:
        sets = [PK.build_plane_set(torch.tensor([[0, 0, 0], [0, 0, 1], [1, 0, 4]]),
                                   (21, 16, 16), 10)[0]]
        plan = PK.make_plane_plan_batched(sets, 128, 128, 128)._replace(
            nbr=PK.flat_neighbor_ranks(sets, 128))
        mask = torch.zeros(128, 16)
        mask[:2, 0] = 1
        state = (torch.randn(128, 512) * mask.repeat_interleave(32, -1)).requires_grad_(True)
        out = block(state, mask, plan)
        out.sum().backward()
        assert out.shape == (128, 512) and block.conv1_weight.grad.abs().max() > 0
        assert not torch.equal(block.bn1.running_mean, saved["bn1.running_mean"])
    finally:
        block.eval()
        block.load_state_dict(saved)
        block.zero_grad(set_to_none=True)
    tile = TileKBlock(32, 32).train()
    for weight in (tile.conv1_weight, tile.conv2_weight):
        torch.nn.init.normal_(weight, std=0.05, generator=torch.Generator().manual_seed(2))
    tmask = torch.zeros(4, 128, 16)
    tmask[:, :2, 0] = 1
    tstate = (torch.randn(4, 128, 512) * tmask.repeat_interleave(32, -1)).requires_grad_(True)
    tplan = TTK.TKPlan(torch.zeros(1, 9, dtype=torch.int32),
                       torch.full((1, 32, 128), TTK.SENTINEL, dtype=torch.int32),
                       torch.zeros((), dtype=torch.int32))
    tout = tile(tstate, tmask, tplan)
    tout.sum().backward()
    assert tout.shape == (4, 128, 512) and tile.conv2_weight.grad.abs().max() > 0
    assert float(tile.bn2.running_mean.abs().max()) > 0
