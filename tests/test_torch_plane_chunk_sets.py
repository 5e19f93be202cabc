"""The plane engine's chunk sets and layout permutations against JAX's,
integer bit-exact (moved from ``tests/test_torch_plane_conv.py``)."""
import numpy as np

import jax.numpy as jnp

from sparse2dense_tpu.ops import plane_conv as JPK
from sparse2dense_tpu_torch.ops import plane_conv as TPK

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_plane_conv import GRID, _assert_ts, _plane_sets, _t

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_chunk_sets_and_permutations_bit_exact():
    """plane set -> covering chunk set -> plane rank of every chunk row and
    chunk row of every plane, plane state <-> chunk planes, and the plane
    set read back from a chunk-planes mask."""
    c, tz, tbud, pbud = 8, 4, 128, 512
    coords, jts, _, tts, _ = _plane_sets(4, pbud)
    t1p = TPK.t1p_of(pbud)
    feats = np.random.RandomState(3).randn(len(coords), c).astype(np.float32)
    jst, jmk = JPK.build_plane_state(jnp.asarray(feats), jnp.asarray(coords), jts, GRID, t1p)
    tst, tmk = TPK.build_plane_state(_t(feats), _t(coords), tts, GRID, t1p)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))

    jct = JPK.chunk_set_of_planes(jts, GRID, tz, tbud)
    tct = TPK.chunk_set_of_planes(tts, GRID, tz, tbud)
    _assert_ts(jct, tct)
    jpo = JPK.plane_ranks_of_chunks(jct, jts, GRID, tz, t1p - 1)
    tpo = TPK.plane_ranks_of_chunks(tct, tts, GRID, tz, t1p - 1)
    np.testing.assert_array_equal(tpo.numpy(), np.asarray(jpo))
    jpl = JPK.plane_state_to_planes(jst, jpo, tz)
    tpl = TPK.plane_state_to_planes(tst, tpo, tz)
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    jml = JPK.plane_state_to_planes(jmk, jpo, tz)                  # (N, 4, 4, 1)

    jcr = JPK.chunk_ranks_of_planes(jts, jct, GRID, tz, tbud)
    tcr = TPK.chunk_ranks_of_planes(tts, tct, GRID, tz, tbud)
    np.testing.assert_array_equal(tcr.numpy(), np.asarray(jcr))
    np.testing.assert_array_equal(TPK.planes_to_plane_state(tpl, tcr, t1p).numpy(),
                                  np.asarray(JPK.planes_to_plane_state(jpl, jcr, t1p)))

    mask4 = np.asarray(jml)
    jps = JPK.plane_set_from_chunk_mask(jnp.asarray(mask4), jct, GRID, tz, pbud)
    tps = TPK.plane_set_from_chunk_mask(_t(mask4), tct, GRID, tz, pbud)
    _assert_ts(jps, tps)
