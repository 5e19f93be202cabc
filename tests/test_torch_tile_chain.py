"""The tile engine's set chain against JAX (moved from
``tests/test_torch_tile_kernel.py``, whose ``chain`` it runs): conv1's tiles,
the chunk-layout downsamples and the plans, every set size and drop count
equal to the reference's at budgets and a window under which each counter
fires."""
import numpy as np

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_tile_kernel import _Jax, _Torch, chain

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_tile_chain_matches_jax_with_drops():
    """Every set size and drop count of the chain equal to the reference's,
    at budgets and a window under which each counter fires."""
    grid = (41, 48, 48)
    rng = np.random.RandomState(0)
    coords = np.stack(np.unravel_index(rng.choice(int(np.prod(grid)), 2000, replace=False),
                                       grid), -1).astype(np.int32)
    coords[-50:] = -1
    args = (coords, grid, (700, 120, 15, 3), 16)
    got = chain(_Torch(), *args)
    assert got == chain(_Jax(), *args)
    fired = {name for name, _, _, drops in got if drops}
    assert {"conv1 tiles (tz 8)", "conv1 plan", "conv2_down out tiles (tz 4)", "conv2 plan",
            "conv3_down out tiles (tz 2)"} <= fired, got
