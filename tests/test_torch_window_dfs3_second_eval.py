"""The window engine at ``dense_from_stage`` 3 and 99 against the gather
engine with the same weights, SpMiddleFHD in eval mode: the checks of
``tests/test_torch_window_dfs3_resnet_eval.py`` on this case."""
from tests.test_torch_window_dfs3 import (  # noqa: F401 (fixtures)
    engines_fixture, frame, one_thread, runs)
from tests.test_torch_window_dfs3_resnet_eval import (  # noqa: F401 (the checks)
    test_deep_bev_and_statistics_match_gather, test_deep_modules_and_residual_rows)

engines = engines_fixture("second", False)
