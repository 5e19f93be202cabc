"""The window engine at ``dense_from_stage`` 3 and 99 against the gather
engine with the same weights (``tests/test_torch_window_dfs3.py``'s frame
and runs), SpMiddleResNetFHD in eval mode: the stages past conv3_down on
windowed convs, every plan's residual rows within its budget, the BEV
within 1e-4 of its largest value, BN running statistics within 1e-5. The
other three cases import these checks:
``tests/test_torch_window_dfs3_{resnet_train,second_eval,second_train}.py``."""
import numpy as np

from tests.test_torch_window_dfs3 import (  # noqa: F401 (fixtures)
    engines_fixture, frame, one_thread, runs)

engines = engines_fixture("resnet", False)

# per backbone: the window modules of the stages dense_from_stage 3 adds, of
# those 99 adds, and the plan groups of the telemetry at 3 (99 adds the last
# stage's subm plans and extra_conv)
WINDOWED = {
    "resnet": ({"conv3_0": "WinBasicBlock", "conv3_1": "WinBasicBlock",
                "conv4_down": "WinDownsample"},
               {"conv4_0": "WinBasicBlock", "conv4_1": "WinBasicBlock",
                "extra_conv": "WinDownsample"},
               {"conv1", "conv2_down", "conv2", "conv3_down", "conv3", "conv4_down"},
               {"conv4", "extra_conv"}),
    "second": ({"subm2": "WinSubMStage", "down3": "WinDownsample"},
               {"subm3": "WinSubMStage", "extra_conv": "WinDownsample"},
               {"subm0", "down1", "subm1", "down2", "subm2", "down3"},
               {"subm3", "extra_conv"}),
}


def test_deep_modules_and_residual_rows(engines):
    """The stages ``dense_from_stage`` adds are the window engine's (at 3 the
    last stage's blocks and extra_conv stay dense), and every plan's
    residual rows are within its budget."""
    name, dfs, _, win, _ = engines
    at3, at99, tele3, tele99 = WINDOWED[name]
    for mod, cls in at3.items():
        assert win["modules"][mod] == cls, mod
    for mod, cls in at99.items():
        assert (win["modules"][mod] == cls) == (dfs > 4), mod
    tele = win["telemetry"]
    assert set(tele) == (tele3 | tele99 if dfs > 4 else tele3)
    for key, (counts, budget) in tele.items():
        assert int(counts.max()) <= budget, key


def test_deep_bev_and_statistics_match_gather(engines):
    assert_bev_and_statistics_match(*engines[3:])


def assert_bev_and_statistics_match(win, gather):
    """The BEV within 1e-4 of its largest value, BN running statistics
    within 1e-5."""
    want = gather["bev"]
    assert win["bev"].shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(win["bev"], want, rtol=0, atol=1e-4 * np.abs(want).max())
    for k, v in gather["stats"].items():
        np.testing.assert_allclose(win["stats"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
