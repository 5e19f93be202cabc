"""The tile engine's batched plans, states and layouts bit for bit, and
``to_dense``, against the JAX reference (moved from
``tests/test_torch_tile_kernel.py``)."""
import numpy as np

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_tile_kernel import GRID, _scene, _sets, _t

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_batched_plan_state_and_layouts_bit_exact():
    import jax
    import jax.numpy as jnp

    from sparse2dense_tpu.ops import tile_conv as JTC
    from sparse2dense_tpu.ops import tile_kernel as JTK
    from sparse2dense_tpu_torch.ops import tile_kernel as TTK

    tz, budget, c = 2, 60, 3
    t1p = TTK.t1p_of(budget)
    coords = np.stack([_scene(0), _scene(1)])
    feats = np.random.RandomState(2).randn(*coords.shape[:2], c).astype(np.float32)
    jts = jax.vmap(lambda cc: JTC.build_tile_set(cc, GRID, 4, 4, tz, budget)[0])(
        jnp.asarray(coords))
    tts = [_sets(cc, tz, budget)[2] for cc in coords]
    jp = JTK.make_block_plan_batched(jts, t1p, w0=32, wz=32)
    tp = TTK.make_block_plan_batched(tts, t1p, 32, 32)
    np.testing.assert_array_equal(tp.ws.numpy(), np.asarray(jp.ws))
    np.testing.assert_array_equal(tp.tgt.numpy(), np.asarray(jp.tgt))
    assert int(tp.n_miss.sum()) == int(jp.n_miss) > 0

    jst, jmk = JTK.build_state_batched(jnp.asarray(feats), jnp.asarray(coords), jts, GRID,
                                       4, 4, tz, t1p)
    tst, tmk = TTK.build_state_batched(_t(feats), _t(coords), tts, GRID, 4, 4, tz, t1p)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    jpl = JTK.state_to_planes_batched(jst, 2, t1p, tz, budget + 1)
    tpl = TTK.state_to_planes_batched(tst, 2, t1p, tz, budget + 1)
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    np.testing.assert_array_equal(TTK.planes_to_state_batched(tpl, tz, t1p).numpy(),
                                  np.asarray(JTK.planes_to_state_batched(jpl, tz, t1p)))


def test_to_dense_matches_jax():
    import jax.numpy as jnp

    from sparse2dense_tpu.ops import tile_kernel as JTK
    from sparse2dense_tpu.ops import tile_planes as JTP
    from sparse2dense_tpu_torch.ops import tile_planes as TTP

    tz, budget = 4, 100
    coords = _scene(3)
    jts, _, tts, _ = _sets(coords, tz, budget)
    t1p = JTK.t1p_of(budget)
    feats = np.random.RandomState(3).randn(len(coords), 5).astype(np.float32)
    jst, _ = JTK.build_state(jnp.asarray(feats), jnp.asarray(coords), jts, GRID, 4, 4, tz, t1p)
    p = np.asarray(JTK.state_to_planes(jst, tz, 5))[:(budget + 1) * tz]
    np.testing.assert_array_equal(TTP.to_dense(_t(p), tts, GRID, tz).numpy(),
                                  np.asarray(JTP.to_dense(jnp.asarray(p), jts, GRID, tz)))
