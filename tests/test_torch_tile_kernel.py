"""Port of the tile engine's sets, plans and state (sparse2dense_tpu_torch/
ops/tile_conv.py, tile_kernel.py, tile_planes.py) against the JAX reference
on the same numpy scenes: tile sets, block plans, states and layouts integer
bit-exact at tz 8/4/2/6, also where the plan's windows miss targets; the
plain tile conv against the reference's kernel in interpret mode within 1e-4
(float32, summation order only), with and without window misses; the set
chain of the tile engine (conv1 tiles, the chunk-layout downsamples, plans)
with every drop counter firing.

    JAX_PLATFORMS=cpu python tests/test_torch_tile_kernel.py

runs the chain on the CPU on the synthetic flagship frame
(``make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32)``, the
reference bench's frame) through JAX's set functions and the port's, at the
reference's default tile budgets and window, at
``sparse2dense_tpu_torch.utils.config.TILE_FRAME_BUDGETS``, and at those
budgets with the default window of 256 tiles, and prints one JSON line per
setting: for every set its size, its budget and its drop or miss count,
JAX's beside the port's. It exits non-zero if they differ.

Split into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the tile sets' last case
and the plan with misses, ``tests/test_torch_tile_set_edges.py``; the block
plans and states, ``tests/test_torch_tile_block_plans.py``; the plain tile
conv, ``tests/test_torch_tile_kernel_conv.py``; the wrapper and the kernel
on the card, ``tests/test_torch_tile_kernel_cuda.py``; the set chain,
``tests/test_torch_tile_chain.py``; the batched plans, states and layouts and
``to_dense``, ``tests/test_torch_tile_layouts.py``."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

GRID = (8, 32, 32)
TOL = dict(rtol=1e-4, atol=1e-4)
# (name, padding) of the strided convs conv2_down..conv4_down: ksize (3, 3, 3), stride 2
DOWNS = (("conv2", (1, 1, 1)), ("conv3", (1, 1, 1)), ("conv4", (0, 1, 1)))
TILE_TZ = (8, 4, 2, 6)


def _scene(seed=0, v=500, n_pad=20, grid=GRID):
    rng = np.random.RandomState(seed)
    lin = rng.choice(int(np.prod(grid)), v, replace=False)
    coords = np.stack(np.unravel_index(lin, grid), -1).astype(np.int32)
    coords[-n_pad:] = -1
    return coords


def _t(x):
    import torch

    return torch.from_numpy(np.array(x))


def _assert_ts(jts, tts):
    for name, a, b in zip(jts._fields, jts, tts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _sets(coords, tz, budget):
    import jax.numpy as jnp

    from sparse2dense_tpu.ops import tile_conv as JTC
    from sparse2dense_tpu_torch.ops import tile_conv as TTC

    jts, jslot = JTC.build_tile_set(jnp.asarray(coords), GRID, 4, 4, tz, budget)
    tts, tslot = TTC.build_tile_set(_t(coords), GRID, 4, 4, tz, budget)
    return jts, jslot, tts, tslot


SET_CASES = [(8, 70), (4, 130), (2, 260), (6, 130), (4, 60)]   # (tz, budget)


@pytest.mark.parametrize("tz,budget", SET_CASES[:4])
def test_tile_set_and_row_slots_bit_exact(tz, budget):
    check_tile_set_and_row_slots(tz, budget)


def check_tile_set_and_row_slots(tz, budget):
    """Tile set, row slots and the drop count bit-exact against JAX."""
    import jax.numpy as jnp

    from sparse2dense_tpu.ops import tile_conv as JTC
    from sparse2dense_tpu_torch.ops import tile_conv as TTC

    coords = _scene(0)
    jts, jslot, tts, tslot = _sets(coords, tz, budget)
    _assert_ts(jts, tts)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert (int(tts.n_drop) > 0) == (budget == 60)   # budgets cover every key but the last
    js, jin = JTC.row_slots(jnp.asarray(coords), jts, GRID, 4, 4, tz)
    ts_, tin = TTC.row_slots(_t(coords), tts, GRID, 4, 4, tz)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))


PLAN_CASES = [   # (tz, budget, seed, v, w)
    (8, 70, 1, 500, None), (4, 130, 1, 500, None), (2, 124, 7, 800, None),
    (6, 130, 1, 500, None),
    (2, 124, 7, 800, 16),       # windows narrower than the targets' span: misses
]


def check_block_plan_and_state(tz, budget, seed, v, w):
    """Block plan, state, mask and plane layouts bit-exact against JAX."""
    import jax.numpy as jnp

    from sparse2dense_tpu.ops import tile_kernel as JTK
    from sparse2dense_tpu_torch.ops import tile_kernel as TTK

    coords = _scene(seed, v=v, n_pad=10)
    jts, _, tts, _ = _sets(coords, tz, budget)
    t1p = TTK.t1p_of(budget)
    assert t1p == JTK.t1p_of(budget)
    w = w or t1p
    jp = JTK.make_block_plan(jts, t1p, w0=w, wz=w)
    tp = TTK.make_block_plan(tts, t1p, w0=w, wz=w)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert (int(tp.n_miss) > 0) == (w == 16)

    feats = np.random.RandomState(seed).randn(len(coords), 3).astype(np.float32)
    jst, jmk = JTK.build_state(jnp.asarray(feats), jnp.asarray(coords), jts, GRID, 4, 4, tz, t1p)
    tst, tmk = TTK.build_state(_t(feats), _t(coords), tts, GRID, 4, 4, tz, t1p)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(TTK.expand_mask(tmk, 3).numpy(),
                                  np.asarray(JTK.expand_mask(jmk, 3)))
    jpl = JTK.state_to_planes(jst, tz, 3)
    tpl = TTK.state_to_planes(tst, tz, 3)
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    t1 = budget + 1
    np.testing.assert_array_equal(TTK.planes_to_state(tpl[:t1 * tz], tz).numpy(),
                                  np.asarray(JTK.planes_to_state(jpl[:t1 * tz], tz)))


def _conv_case(tz, c, co, relu, residual, window=None, budget=60, seed=0, v=500):
    """The same state, plan, taps and folded epilogue through the
    reference's interpret-mode kernel and the port's plain version."""
    import jax.numpy as jnp

    from sparse2dense_tpu.ops import tile_kernel as JTK
    from sparse2dense_tpu_torch.ops import plane_conv as TPK
    from sparse2dense_tpu_torch.ops import tile_kernel as TTK

    coords = _scene(seed, v=v, n_pad=10)
    jts, _, tts, _ = _sets(coords, tz, budget)
    t1p = TTK.t1p_of(budget)
    window = window or t1p
    rng = np.random.RandomState(seed + 7)
    feats = rng.randn(len(coords), c).astype(np.float32)
    w = (rng.randn(27, c, co) * 0.2).astype(np.float32)
    bias, bn_s, bn_b, bn_m = (rng.randn(co).astype(np.float32) for _ in range(4))
    bn_v = rng.uniform(0.5, 1.5, co).astype(np.float32)
    jst, jmk = JTK.build_state(jnp.asarray(feats), jnp.asarray(coords), jts, GRID, 4, 4, tz,
                               t1p)
    jplan = JTK.make_block_plan(jts, t1p, w0=window, wz=window)
    jsc, jsh = JTK.fold_epilogue(co, *(jnp.asarray(a) for a in (bias, bn_s, bn_b, bn_m, bn_v)),
                                 eps=1e-3)
    want, _ = JTK.tk_subm_conv(jst, JTK.make_exports(jst, tz, c), jplan, jnp.asarray(w), jsc,
                               jsh, JTK.expand_mask(jmk, co),
                               residual=jst if residual else None, relu=relu, w0=window,
                               wz=window, interpret=True)

    tst, tmk = TTK.build_state(_t(feats), _t(coords), tts, GRID, 4, 4, tz, t1p)
    tplan = TTK.make_block_plan(tts, t1p, w0=window, wz=window)
    tsc, tsh = TPK.fold_epilogue(co, *(_t(a) for a in (bias, bn_s, bn_b, bn_m, bn_v)), eps=1e-3)
    got = TTK.tk_subm_conv(tst, tplan, _t(w), tsc, tsh, TTK.expand_mask(tmk, co),
                           residual=tst if residual else None, relu=relu)
    return got, want, tplan, (tst, tmk, tsc, tsh, _t(w))


# ---------------------------------------------------------------------------
# the set chain of the tile engine, JAX beside the port
# ---------------------------------------------------------------------------

class _Jax:
    """The reference's set functions, eager on the CPU."""

    def __init__(self):
        import jax.numpy as jnp

        from sparse2dense_tpu.ops import tile_conv, tile_kernel, tile_planes

        self.np, self.TC, self.TK, self.TP = jnp, tile_conv, tile_kernel, tile_planes

    def arr(self, a):
        return self.np.asarray(a)

    def ones(self, n):
        return self.np.ones((n, 1), self.np.float32)

    def zeros(self, shape):
        return self.np.zeros(shape, self.np.float32)

    def downsample(self, *args):
        _, mo, tso, grid_out, _ = self.TP.downsample(*args)
        return mo, tso, tuple(int(g) for g in grid_out)


class _Torch:
    """The port's set functions on the CPU."""

    def __init__(self):
        import torch

        from sparse2dense_tpu_torch.ops import tile_conv, tile_kernel, tile_planes

        self.torch, self.TC, self.TK, self.TP = torch, tile_conv, tile_kernel, tile_planes

    def arr(self, a):
        return self.torch.from_numpy(np.array(a))

    def ones(self, n):
        return self.torch.ones((n, 1))

    def zeros(self, shape):
        return self.torch.zeros(shape)

    def downsample(self, *args):
        _, mo, tso, grid_out = self.TP.downsample(*args)
        return mo, tso, tuple(grid_out)


def chain(be, coords: np.ndarray, grid, tile_budgets, window):
    """[(set, size, budget, drops)] of one sample's tile-engine chain with
    every stage on tiles; ``drops`` is what the engine reports for that set:
    ``conv1_tile_drop``, ``down_drop``, or for a plan ``tilek_miss``."""
    TC, TK = be.TC, be.TK
    c = be.arr(coords)
    ts = TC.build_tile_set(c, grid, 4, 4, TILE_TZ[0], tile_budgets[0])[0]
    out = [(f"conv1 tiles (tz {TILE_TZ[0]})", int(ts.n_tiles), tile_budgets[0], int(ts.n_drop))]
    t1p = TK.t1p_of(tile_budgets[0])
    _, mask = TK.build_state(be.ones(c.shape[0]), c, ts, grid, 4, 4, TILE_TZ[0], t1p)
    mask = TK.state_to_planes(mask, TILE_TZ[0], 1)[:(tile_budgets[0] + 1) * TILE_TZ[0]]
    out.append(("conv1 plan", int(ts.n_tiles), t1p,
                int(TK.make_block_plan(ts, t1p, window, window).n_miss)))
    for k, (name, pad) in enumerate(DOWNS, start=1):
        mask, ts, grid = be.downsample(be.zeros(mask.shape), mask, ts, grid,
                                       be.zeros((27, 1, 1)), (3, 3, 3), pad, TILE_TZ[k - 1],
                                       TILE_TZ[k], tile_budgets[k])
        out.append((f"{name}_down out tiles (tz {TILE_TZ[k]})", int(ts.n_tiles),
                    tile_budgets[k], int(ts.n_drop)))
        t1p = TK.t1p_of(tile_budgets[k])
        out.append((f"{name} plan", int(ts.n_tiles), t1p,
                    int(TK.make_block_plan(ts, t1p, window, window).n_miss)))
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sparse2dense_tpu.models.backbones.scn import SpMiddleResNetFHD as JaxFHD
    from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
    from sparse2dense_tpu_torch.models.builder import sparse_shape_from_voxel_cfg
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import TILE_FRAME_BUDGETS, flagship

    cfg = flagship("tile")
    frame = dict(max_voxels=150000, n_points=170000, n_obj=32)
    coords = make_batch(cfg, 1, device="cpu", **frame)["coordinates"][0].numpy()
    jcoords = np.asarray(jax_make_batch(cfg, 1, with_targets=False, **frame)["coordinates"][0])
    if not np.array_equal(coords, jcoords):
        print("make_batch coordinates differ between JAX and the port", file=sys.stderr)
        return 1
    grid = tuple(sparse_shape_from_voxel_cfg(cfg["voxel_generator"]))
    frame_budgets = TILE_FRAME_BUDGETS["tile_budgets"]
    ok = True
    for label, budgets, window in (
            ("reference defaults", JaxFHD.tile_budgets, JaxFHD.tilek_window),
            ("TILE_FRAME_BUDGETS", frame_budgets, TILE_FRAME_BUDGETS["tilek_window"]),
            ("TILE_FRAME_BUDGETS, default window", frame_budgets, JaxFHD.tilek_window)):
        sets = {name: chain(be(), coords, grid, budgets, window)
                for name, be in (("jax", _Jax), ("port", _Torch))}
        same = sets["jax"] == sets["port"]
        ok &= same
        print(json.dumps(dict(setting=label, voxels=int((coords[:, 0] >= 0).sum()),
                              equal=same, tile_budgets=budgets, tilek_window=window,
                              sets={k: [list(r) for r in v] for k, v in sets.items()})),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
