"""Weights carried across engines at ``dense_from_stage`` 3 and 99: the
reference's window and gather engines share one parameter tree, and so do
the port's, so ``convert.from_flax`` needs no rule for the window engine.
One seeded Flax tree of the reference's shapes (``flax_shapes`` of the
gather-engine twin) converts into the gather and the window engine's
backbones alike, on both backbones: every Flax leaf has its counterpart
(``from_flax`` raises otherwise) and every entry of each module is filled,
nothing left over; the two state dicts are equal."""
import jax
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.convert import from_flax

from tests.test_torch_layers import flax_shapes
from tests.test_torch_window_dfs2 import BACKBONES, GRID


@pytest.mark.parametrize("dfs", (3, 99))
@pytest.mark.parametrize("name", list(BACKBONES))
def test_one_flax_tree_loads_into_both_engines(name, dfs):
    cls = BACKBONES[name]
    mods = {engine: cls(num_input_features=5, sparse_shape=GRID, engine=engine,
                        dense_from_stage=dfs) for engine in ("gather", "window")}
    rng = np.random.RandomState(dfs)
    variables = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32),
                                       flax_shapes(mods["gather"]))
    states = {}
    for engine, mod in mods.items():
        state = from_flax(variables, mod)
        missing, unexpected = mod.load_state_dict(state, strict=False)
        assert not unexpected, (engine, unexpected)
        assert all(k.endswith("num_batches_tracked") for k in missing), (engine, missing)
        states[engine] = state
    assert states["gather"].keys() == states["window"].keys()
    for k, v in states["gather"].items():
        assert torch.equal(v, states["window"][k]), k
