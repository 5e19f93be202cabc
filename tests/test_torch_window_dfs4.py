"""The window engine at ``dense_from_stage=4``: every stage sparse through
the conv4 blocks (SpMiddleResNetFHD's at 128->128, SpMiddleFHD's subm3 at
64->64), the rows densified before the dense ``extra_conv``; against the
port's gather engine at the same setting with the same weights, on
``tests/test_torch_window_dfs2.py``'s frame, in eval and in train mode,
with the tolerances of ``tests/test_torch_window_dfs3.py``: the BEV within
1e-4 of its largest value, BN running statistics within 1e-5, the
gradients of sum(BEV^2) within 1e-3 of their module's largest, every
plan's residual rows within its budget."""
import pytest

from tests.test_torch_window_dfs2 import (  # noqa: F401 (fixtures)
    BACKBONES, GRID, frame, one_thread, seeded_weights)
from tests.test_torch_window_dfs3 import assert_gradients_match, run_backbone
from tests.test_torch_window_dfs3_resnet_eval import assert_bev_and_statistics_match

# the last windowed stage's modules and the dense extra_conv
MODULES = {"resnet": {"conv4_0": "WinBasicBlock", "conv4_1": "WinBasicBlock",
                      "extra_conv": "DenseDownsample"},
           "second": {"subm3": "WinSubMStage", "extra_conv": "DenseDownsample"}}


@pytest.mark.parametrize("train", (False, True), ids=("eval", "train"))
@pytest.mark.parametrize("name", list(BACKBONES))
def test_dfs4_matches_gather(frame, name, train):
    cls = BACKBONES[name]
    weights = seeded_weights(cls(num_input_features=5, sparse_shape=GRID), 40)
    win, gather = (run_backbone(cls, engine, 4, weights, *frame, train)
                   for engine in ("window", "gather"))
    for mod, kind in MODULES[name].items():
        assert win["modules"][mod] == kind, mod
    for key, (counts, budget) in win["telemetry"].items():
        assert int(counts.max()) <= budget, key
    assert_bev_and_statistics_match(win, gather)
    if train:
        assert_gradients_match(win["grads"], gather["grads"])
