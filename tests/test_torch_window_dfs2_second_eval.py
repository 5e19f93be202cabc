"""The window engine at ``dense_from_stage=2`` against the gather engine
with the same weights, SECOND's SpMiddleFHD in eval mode: the checks of
``tests/test_torch_window_dfs2_resnet_eval.py`` on this case."""
from tests.test_torch_window_dfs2 import (  # noqa: F401 (fixtures)
    engines_fixture, frame, one_thread, runs)
from tests.test_torch_window_dfs2_resnet_eval import (  # noqa: F401 (the checks)
    test_dfs2_batchnorm_statistics_match_gather, test_dfs2_bev_matches_gather,
    test_dfs2_modules, test_dfs2_residual_rows_within_budget)

engines = engines_fixture("second", False)
