"""The window engine at ``dense_from_stage=2`` against the gather engine
with the same weights (``tests/test_torch_window_dfs2.py``'s frame and
runs), SpMiddleResNetFHD in eval mode: the conv2 stage and the strided conv
after it on windowed convs, every plan's residual rows within its budget,
the BEV within 1e-4 of its largest value, BN running statistics within
1e-5. The other three cases import these checks:
``tests/test_torch_window_dfs2_{resnet_train,second_eval,second_train}.py``."""
import numpy as np

from sparse2dense_tpu_torch.models.backbones.scn import (WinBasicBlock, WinDownsample,
                                                         WinSubMStage)

from tests.test_torch_window_dfs2 import (  # noqa: F401 (fixtures)
    engines_fixture, frame, one_thread, runs)

engines = engines_fixture("resnet", False)


def test_dfs2_modules(engines):
    """The conv2 stage and the strided conv after it are the window engine's."""
    name, _, mod, _, _ = engines
    if name == "resnet":
        assert isinstance(mod.conv2_0, WinBasicBlock) and isinstance(mod.conv3_down,
                                                                     WinDownsample)
        assert not isinstance(mod.conv3_0, WinBasicBlock)
    else:
        assert isinstance(mod.subm1, WinSubMStage) and isinstance(mod.down2, WinDownsample)
        assert not isinstance(mod.subm2, WinSubMStage)


def test_dfs2_residual_rows_within_budget(engines):
    name, _, _, win, _ = engines
    tele = win["telemetry"]
    want = ({"conv1", "conv2_down", "conv2", "conv3_down"} if name == "resnet"
            else {"subm0", "down1", "subm1", "down2"})
    assert set(tele) == want
    for key, (counts, budget) in tele.items():
        assert int(counts.max()) <= budget, key


def test_dfs2_bev_matches_gather(engines):
    _, _, _, win, gather = engines
    want = gather["bev"]
    assert win["bev"].shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(win["bev"], want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_dfs2_batchnorm_statistics_match_gather(engines):
    _, _, _, win, gather = engines
    for k, v in gather["stats"].items():
        np.testing.assert_allclose(win["stats"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
