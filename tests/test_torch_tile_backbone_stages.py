"""Each stage's tile planes of the tile backbone against JAX's (moved from
``tests/test_torch_tile_backbone.py``, whose ``run`` fixture, the backbone on the
same scene in each package, runs again here: the port's side again, the
reference's read from the session's shared results)."""
import numpy as np
import pytest

from tests.test_torch_tile_backbone import TOL, run  # noqa: F401 (fixtures)


@pytest.mark.parametrize("stage", ["conv1", "conv2", "conv3", "conv4"])
def test_stage_planes_match_jax(run, stage):
    """Chunk planes and masks of every tile stage (the phantom tile included)."""
    (jp, jm, _), jg = run["jms"][stage]
    (tp, tm, _), tg = run["tms"][stage]
    assert tuple(tg) == tuple(jg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
