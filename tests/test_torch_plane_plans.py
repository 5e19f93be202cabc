"""The plane engine's plans and batched plans against JAX's, integer
bit-exact (moved from
``tests/test_torch_plane_conv.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp

from sparse2dense_tpu.ops import plane_conv as JPK
from sparse2dense_tpu_torch.ops import plane_conv as TPK

from tests.test_torch_plane_conv import GRID, JTC, _plane_sets, _scene, _ts_torch


@pytest.mark.parametrize("w", [None, 128, 16])   # full windows, 128 rows, misses
def test_plane_plan_bit_exact(w):
    _, jts, _, tts, _ = _plane_sets(1, 512)
    t1p = TPK.t1p_of(512)
    w = w or t1p
    jp = JPK.make_plane_plan(jts, t1p, w0=w, wy=w)
    tp = TPK.make_plane_plan(tts, t1p, w0=w, wy=w)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert (int(tp.n_miss) > 0) == (w == 16)


def test_batched_plan_bit_exact():
    budget, t1p = 300, TPK.t1p_of(300)
    coords = np.stack([_scene(0), _scene(1)])
    jts = [JPK.build_plane_set(jnp.asarray(c), GRID, budget)[0] for c in coords]
    jstack = JTC.TileSet(*(jnp.stack(f) for f in zip(*jts)))
    jp = JPK.make_plane_plan_batched(jstack, t1p, w0=128, wy=128)
    tp = TPK.make_plane_plan_batched([_ts_torch(j) for j in jts], t1p, 128, 128)
    np.testing.assert_array_equal(tp.ws.numpy(), np.asarray(jp.ws))
    np.testing.assert_array_equal(tp.tgt.numpy(), np.asarray(jp.tgt))
    assert int(tp.n_miss.sum()) == int(jp.n_miss)


