"""The window pass under autograd on the z-only (3,1,1) plan
(``tests/test_torch_window_grad.py``'s cases): the checks of
``tests/test_torch_window_grad_gate.py`` on this case."""
from tests.test_torch_window_grad import CASES, case_fixture
from tests.test_torch_window_grad_gate import (  # noqa: F401 (the checks)
    test_function_matches_autograd_through_the_plain_formula, test_hits_lie_in_their_windows,
    test_the_case_reaches_its_edge, test_window_conv_grad_matches_jax)

case = case_fixture(CASES[3:4])
