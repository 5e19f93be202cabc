"""The tile engine's detector in the port alone (moved from
``tests/test_torch_tile_detector.py``, whose ``run`` fixture also runs the
reference): its backbone's state has the window engine's names and shapes
(checkpoints interchange), and its tile block trains (batch statistics, a gradient
on its weights). Here ``run`` builds only the port's model, with the same
config and seeded weights."""
import pytest
import torch

from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD, TileKBlock
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import flax_shapes, rand_variables
from tests.test_torch_tile_detector import CFG, ENGINE


@pytest.fixture(scope="module")
def run():
    tcfg = ConfigDict.fromfile(CFG)
    tcfg.S_model["backbone"].update(ENGINE)
    tmodel = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                            voxel_generator=tcfg.voxel_generator, device="cpu")
    tmodel.load_state_dict(from_flax(rand_variables(flax_shapes(tmodel), seed=13), tmodel))
    return dict(tmodel=tmodel)


def test_tile_parameters_match_the_window_engine(run):
    """Checkpoints interchange across engines: same names, same shapes."""
    tile = run["tmodel"].backbone.state_dict()
    kw = dict(num_input_features=5, sparse_shape=(41, 32, 32))
    window = SpMiddleResNetFHD(engine="window", dense_from_stage=1, **kw).state_dict()
    assert {k: tuple(v.shape) for k, v in tile.items()} == \
        {k: tuple(v.shape) for k, v in window.items()}


def test_tile_blocks_are_inference_only(run):
    """The tile block of the detector trains: batch statistics and a
    gradient on its weights (its state restored after)."""
    from sparse2dense_tpu_torch.ops import tile_conv as TTC
    from sparse2dense_tpu_torch.ops import tile_kernel as TTK

    block = run["tmodel"].backbone.conv2_0
    assert isinstance(block, TileKBlock)
    saved = {k: v.clone() for k, v in block.state_dict().items()}
    block.train()
    try:
        coords = torch.tensor([[0, 0, 0], [0, 0, 1], [1, 0, 4], [5, 9, 9]])
        sets = [TTC.build_tile_set(coords, (8, 16, 16), 4, 4, 4, 10)[0]]
        plan = TTK.make_block_plan_batched(sets, 128, 128, 128)
        state, mask = TTK.build_state_batched(torch.randn(1, 4, 32), coords[None], sets,
                                              (8, 16, 16), 4, 4, 4, 128)
        out = block(state.requires_grad_(True), mask, plan)
        out.sum().backward()
        assert out.shape == (4, 128, 512) and block.conv1_weight.grad.abs().max() > 0
        assert not torch.equal(block.bn1.running_mean, saved["bn1.running_mean"])
    finally:
        block.eval()
        block.load_state_dict(saved)
        block.zero_grad(set_to_none=True)
