"""Set sizes and budget drops of the plane engine's chain, on the JAX
reference and on the port, from the same voxel coordinates.

The chain is what the plane engine's forward does to the sets (the strided
conv2_down's active set, the conv2 plane set and plan, then per transition
the covering chunk set, the chunk-layout downsample's output chunk set, the
next plane set and plan, and extra_conv's chunk set), with the feature
convolutions left out: every set and count depends on the coordinates and
masks only. The test runs it on a small scene whose budgets are tight enough
that every drop counter fires.

    JAX_PLATFORMS=cpu python tests/test_torch_plane_sets.py

runs both chains on the CPU on the synthetic flagship frame
(``make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32)``, the
reference bench's frame; about 2 minutes and 4.3 GB of host memory) at the reference's default
plane and chunk budgets and at
``sparse2dense_tpu_torch.utils.config.FRAME_BUDGETS``, and prints one JSON
line per budget setting: for every set its size, its budget and its drop
count, JAX's beside the port's. It exits non-zero if they differ.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

TILE_TZ = (8, 4, 2, 6)
# (name, padding) of conv3_down and conv4_down: ksize (3, 3, 3), stride 2
DOWNS = (("conv3", (1, 1, 1)), ("conv4", (0, 1, 1)))


class JitModule:
    """A module's functions, each jitted on its first call with every int and
    tuple-of-int argument static (one compile a function and static
    arguments instead of one a primitive, eager); a call with no array
    argument, a class and a constant are the module's own."""

    def __init__(self, module):
        self.module, self.cache = module, {}

    def __getattr__(self, name):
        import jax

        fn = getattr(self.module, name)
        if not callable(fn) or isinstance(fn, type):   # constants, classes
            return fn

        def call(*args):
            static = tuple(i for i, a in enumerate(args) if isinstance(a, (int, np.integer))
                           or (type(a) is tuple and all(isinstance(x, (int, np.integer))
                                                        for x in a)))
            if len(static) == len(args):
                return fn(*args)
            if (name, static) not in self.cache:
                self.cache[name, static] = jax.jit(fn, static_argnums=static)
            return self.cache[name, static](*args)

        return call


class _Jax:
    """The reference's set functions on the CPU, jitted one by one."""

    def __init__(self):
        import jax.numpy as jnp

        from sparse2dense_tpu.ops import plane_conv, tile_planes, window_conv
        from sparse2dense_tpu.ops.sparse_conv import conv_out_grid

        self.np, self.PK, self.TP, self.WC = (jnp, JitModule(plane_conv), JitModule(tile_planes),
                                              JitModule(window_conv))
        self.conv_out_grid = conv_out_grid

    def arr(self, a):
        return self.np.asarray(a)

    def f32(self, x):
        return x.astype(self.np.float32)

    def zeros(self, shape):
        return self.np.zeros(shape, self.np.float32)

    def downsample(self, *args):
        _, mo, tso, grid_out, _ = self.TP.downsample(*args)
        return mo, tso, tuple(int(g) for g in grid_out)


class _Torch:
    """The port's set functions on the CPU."""

    def __init__(self):
        import torch

        from sparse2dense_tpu_torch.ops import plane_conv, tile_planes, window_conv
        from sparse2dense_tpu_torch.ops.sparse_conv import conv_out_grid

        self.torch, self.PK, self.TP, self.WC = torch, plane_conv, tile_planes, window_conv
        self.conv_out_grid = conv_out_grid

    def arr(self, a):
        return self.torch.from_numpy(np.array(a))

    def f32(self, x):
        return x.to(self.torch.float32)

    def zeros(self, shape):
        return self.torch.zeros(shape)

    def downsample(self, *args):
        _, mo, tso, grid_out = self.TP.downsample(*args)
        return mo, tso, grid_out


def chain(be, coords: np.ndarray, grid, down_budget: int, tile_budgets, plane_budgets,
          window: int = 128):
    """[(set, size, budget, drops)] of one sample's plane-engine chain;
    ``drops`` is the count the engine reports for that set (``plane_drop``,
    ``plane_chunk_drop``, ``down_drop``; ``planek_miss`` for a plan)."""
    PK, WC = be.PK, be.WC
    c = be.arr(coords)
    g = tuple(be.conv_out_grid(grid, (2, 2, 2), (1, 1, 1), (3, 3, 3)))
    oc, _ = WC.downsample_active_set_yxz(c, c[:, 0] >= 0, grid, g, (2, 2, 2), (1, 1, 1),
                                         (3, 3, 3), down_budget)
    out = [("conv2_down rows", int((oc[:, 0] >= 0).sum()), down_budget, 0)]
    ts = PK.build_plane_set(oc, g, plane_budgets[0])[0]
    t1p = PK.t1p_of(plane_budgets[0])
    mask = PK.build_plane_state(be.zeros((oc.shape[0], 1)) + 1, oc, ts, g, t1p)[1]

    def planes(name, ts, budget, t1p):
        out.append((f"{name} planes", int(ts.n_tiles), budget, int(ts.n_drop)))
        out.append((f"{name} plan", int(ts.n_tiles), t1p,
                    int(PK.make_plane_plan(ts, t1p, window, window).n_miss)))

    def chunks(name, ts, grid, tz, budget):
        ct = PK.chunk_set_of_planes(ts, grid, tz, budget)
        out.append((f"{name} chunk tiles (tz {tz})", int(ct.n_tiles), budget, int(ct.n_drop)))
        return ct

    planes("conv2", ts, plane_budgets[0], t1p)
    for k, (name, pad) in enumerate(DOWNS, start=1):
        tz, tz_out = TILE_TZ[k], TILE_TZ[k + 1]
        ct = chunks(f"{name}_down in", ts, g, tz, tile_budgets[k])
        po = PK.plane_ranks_of_chunks(ct, ts, g, tz, t1p - 1)
        mch = PK.plane_state_to_planes(mask, po, tz)
        mo, tso, g = be.downsample(be.zeros(mch.shape), mch, ct, g, be.zeros((27, 1, 1)),
                                   (3, 3, 3), pad, tz, tz_out, tile_budgets[k + 1])
        out.append((f"{name}_down out chunk tiles (tz {tz_out})", int(tso.n_tiles),
                    tile_budgets[k + 1], int(tso.n_drop)))
        ts = PK.plane_set_from_chunk_mask(mo, tso, g, tz_out, plane_budgets[k])
        t1p = PK.t1p_of(plane_budgets[k])
        cr = PK.chunk_ranks_of_planes(ts, tso, g, tz_out, tile_budgets[k + 1])
        mask = PK.planes_to_plane_state(mo, cr, t1p)
        planes(name, ts, plane_budgets[k], t1p)
    chunks("extra_conv", ts, g, TILE_TZ[3], tile_budgets[3])
    return out


def test_set_chain_matches_jax_with_drops():
    """Every set size and drop count of the chain equal to the reference's,
    at budgets and windows under which each counter drops something."""
    grid = (41, 48, 48)
    rng = np.random.RandomState(0)
    coords = np.stack(np.unravel_index(rng.choice(int(np.prod(grid)), 2000, replace=False),
                                       grid), -1).astype(np.int32)
    coords[-50:] = -1
    budgets = dict(tile_budgets=(999, 150, 40, 3), plane_budgets=(600, 90, 12), window=16)
    want = chain(_Jax(), coords, grid, 20000, **budgets)
    got = chain(_Torch(), coords, grid, 20000, **budgets)
    assert got == want
    fired = {name for name, _, _, drops in got if drops}
    assert {"conv2 planes", "conv2 plan", "conv3_down in chunk tiles (tz 4)",
            "conv3_down out chunk tiles (tz 2)"} <= fired, got


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sparse2dense_tpu.models.backbones.scn import SpMiddleResNetFHD as JaxFHD
    from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
    from sparse2dense_tpu_torch.models.builder import sparse_shape_from_voxel_cfg
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import FRAME_BUDGETS, flagship

    cfg = flagship("plane")
    frame = dict(max_voxels=150000, n_points=170000, n_obj=32)
    coords = make_batch(cfg, 1, device="cpu", **frame)["coordinates"][0].numpy()
    jcoords = np.asarray(jax_make_batch(cfg, 1, with_targets=False, **frame)["coordinates"][0])
    if not np.array_equal(coords, jcoords):
        print("make_batch coordinates differ between JAX and the port", file=sys.stderr)
        return 1
    grid = tuple(sparse_shape_from_voxel_cfg(cfg["voxel_generator"]))
    down_budget = cfg["S_model"]["backbone"]["stage_budgets"][0]
    defaults = dict(tile_budgets=JaxFHD.tile_budgets, plane_budgets=JaxFHD.plane_budgets)
    ok = True
    for label, budgets in (("reference defaults", defaults), ("FRAME_BUDGETS", FRAME_BUDGETS)):
        sets = {name: chain(be(), coords, grid, down_budget, **budgets)
                for name, be in (("jax", _Jax), ("port", _Torch))}
        same = sets["jax"] == sets["port"]
        ok &= same
        print(json.dumps(dict(budgets=label, voxels=int((coords[:, 0] >= 0).sum()),
                              equal=same, **budgets,
                              sets={k: [list(r) for r in v] for k, v in sets.items()})),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
