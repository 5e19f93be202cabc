"""The tile engine's block plans and states against JAX
(``tests/test_torch_tile_kernel.py``'s scenes): the plan, the state, its
mask and its plane layouts integer bit-exact at tz 8/4/2/6."""
import pytest

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_tile_kernel import PLAN_CASES, check_block_plan_and_state

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


@pytest.mark.parametrize("tz,budget,seed,v,w", PLAN_CASES[:4])
def test_block_plan_and_state_bit_exact(tz, budget, seed, v, w):
    check_block_plan_and_state(tz, budget, seed, v, w)
