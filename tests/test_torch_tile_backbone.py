"""The tile engine with every stage on tiles (``dense_from_stage=99``: the
four tile stages, the three chunk-layout strided convs and the tile z conv
for ``extra_conv``) against JAX at the backbone level: SpMiddleResNetFHD
with ``engine="tile", tile_backend="pallas"`` on distill_tiny's (41, 32, 32)
grid, a batch of two random scenes (the batch-flattened tile state and
plans), float32, the same (seeded random) weights. Budgets cover every key
and the plan window every tile, so the reference is exact.

The JAX side runs the reference's XLA tile backend, one jitted apply (its
Pallas backend lowers 17 interpret-mode tile kernels: ~40 s more of trace
and compile). The reference holds its Pallas backend equal to its XLA one
on this backbone at ``dense_from_stage=99``, with the same tile geometry
and widths (16 to 128) and an uncut window
(``tests/test_tilek_backbone.py::test_tilek_matches_tile_engine``), so the
port's fused backend is held against the reference's kernel through it;
``tests/test_torch_tile_kernel.py`` holds B3's plain version against the
interpret-mode kernel directly at 16 and 32 channels. The Flax variable
shapes are read off the port's twin (``flax_shapes``).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): each stage's planes,
``tests/test_torch_tile_backbone_stages.py`` (its own ``run``, the
reference's results computed once a session for both files)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones.scn import SpMiddleResNetFHD as JaxFHD
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD

from tests.test_torch_layers import flax_shapes, load, rand_variables, session_shared, to_numpy
from tests.test_torch_tile_detector import COUNTERS, counter_sum

GRID = (41, 32, 32)
KW = dict(num_input_features=5, sparse_shape=GRID, engine="tile", tile_backend="pallas",
          dense_from_stage=99, tile_budgets=(384, 96, 24, 4), tilek_window=10 ** 6)
TOL = dict(rtol=1e-4, atol=1e-4)


def _scene(seed=0, v=400, b=2):
    rng = np.random.RandomState(seed)
    coords, feats = [], []
    for _ in range(b):
        lin = rng.choice(int(np.prod(GRID)), v, replace=False)
        c = np.stack(np.unravel_index(lin, GRID), -1).astype(np.int32)
        c[-20:] = -1
        f = rng.randn(v, 5).astype(np.float32)
        f[-20:] = 0
        coords.append(c)
        feats.append(f)
    return np.stack(feats), np.stack(coords)


def _reference(variables, feats, coords):
    """The reference backbone's BEV, stage planes and telemetry (NumPy)."""
    jbb = JaxFHD(**dict(KW, tile_backend="xla"))
    (jbev, jms), coll = jax.jit(lambda v, f, c: jbb.apply(v, f, c, False, mutable=["telemetry"])
                                )(variables, jnp.asarray(feats), jnp.asarray(coords))
    return to_numpy(dict(jbev=jbev, jms=jms, jtele=coll["telemetry"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages' backbone on the scene; the reference's results are
    computed once a session (``session_shared``: this file and
    ``tests/test_torch_tile_backbone_stages.py`` both check them)."""
    feats, coords = _scene()
    tbb = SpMiddleResNetFHD(**KW)
    variables = rand_variables(flax_shapes(tbb), seed=17)
    ref = session_shared(tmp_path_factory, "tile_backbone_dfs99",
                         lambda: _reference(variables, feats, coords))
    tbb = load(tbb, variables)
    with torch.no_grad():
        tbev, tms, tele = tbb(torch.from_numpy(feats), torch.from_numpy(coords))
    return dict(ref, tbev=tbev, tms=tms, tele=tele, tbb=tbb)


def test_bev_matches_jax(run):
    assert tuple(run["tbev"].shape) == tuple(run["jbev"].shape)
    np.testing.assert_allclose(run["tbev"].numpy(), np.asarray(run["jbev"]), **TOL)


def test_tile_telemetry_equal_and_zero(run):
    for k in COUNTERS:
        counts, budget = run["tele"][k]
        want = counter_sum(run["jtele"], k)
        assert (int(counts.sum()), budget) == (want, 0), k
        assert want == 0, k


def test_every_stage_runs_on_tiles(run):
    from sparse2dense_tpu_torch.models.backbones.scn import TileDownsample, TileKBlock, TileZConv

    bb = run["tbb"]
    assert all(isinstance(getattr(bb, f"conv{k}_{i}"), TileKBlock)
               for k in (1, 2, 3, 4) for i in (0, 1))
    assert all(isinstance(getattr(bb, f"conv{k}_down"), TileDownsample) for k in (2, 3, 4))
    assert isinstance(bb.extra_conv, TileZConv)
