"""The tile engine's sets and plans at their edges against JAX
(``tests/test_torch_tile_kernel.py``'s scenes): a tile budget that drops
the last key, and plan windows narrower than the targets' span, so the
plan misses targets."""
import pytest

from tests.test_torch_tile_kernel import (PLAN_CASES, SET_CASES, check_block_plan_and_state,
                                          check_tile_set_and_row_slots)


@pytest.mark.parametrize("tz,budget", SET_CASES[4:])
def test_tile_set_and_row_slots_bit_exact(tz, budget):
    check_tile_set_and_row_slots(tz, budget)


@pytest.mark.parametrize("tz,budget,seed,v,w", PLAN_CASES[4:])
def test_block_plan_and_state_bit_exact(tz, budget, seed, v, w):
    check_block_plan_and_state(tz, budget, seed, v, w)
