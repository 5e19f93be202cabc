"""Python-file configs: a plain ``.py`` file whose module-level names become
the config (mirrors ``sparse2dense_tpu/utils/config.py``, without its det3d
import shim: the port's configs import nothing)."""
from __future__ import annotations

import os
import runpy
import types


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def fromfile(cls, filename: str) -> "ConfigDict":
        """Execute ``filename`` and keep its public, non-module,
        non-callable top-level names."""
        filename = os.path.abspath(os.path.expanduser(filename))
        if not filename.endswith(".py"):
            raise ValueError(f"only .py configs are supported, got {filename}")
        names = runpy.run_path(filename)
        return cls({k: v for k, v in names.items()
                    if not k.startswith("__")
                    and not isinstance(v, types.ModuleType)
                    and not callable(v)})


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
# the flagship recipe's two stages: the dense teacher, then the distillation
# that loads its checkpoint
DENSE_TEACHER = os.path.join(CONFIGS, "waymo_centerpoint_voxelnet_3x_dense_interval_5.py")
FLAGSHIP = os.path.join(CONFIGS, "waymo_centerpoint_voxelnet_3x_distill_interval_5.py")


# plane-engine budgets for the 150k-voxel synthetic frame of the chip runs
# (``make_batch(cfg, 1, max_voxels=150000, n_points=170000, n_obj=32)``,
# the reference bench's frame). Its occupied sets, counted on an H100:
# conv2 81,470 planes; chunk tiles 39,637 (tz 4) -> 33,009 after conv3_down;
# conv3 33,760 planes; chunk tiles 21,031 (tz 2) -> 1,887 after conv4_down;
# conv4 7,866 planes; 1,862 chunk tiles (tz 6) at extra_conv. The
# reference's defaults (80,000 / 26,000 / 6,400 planes, 36,000 / 14,000
# tiles) drop part of it, in the reference as in the port (PERF.md,
# tests/test_torch_plane_sets.py); these cover it with ~10% to spare.
FRAME_BUDGETS = dict(plane_budgets=(90000, 37000, 8700),
                     tile_budgets=(72000, 44000, 36000, 2400))

# tile-engine budgets and plan window for the same frame. Its occupied chunk
# tiles: conv1 66,334 (tz 8); conv2_down output 81,523 (tz 4, the
# two-candidate output tiles); conv3_down output 38,759 (tz 2); conv4_down
# output 1,902 (tz 6). The reference's defaults (72,000 / 36,000 / 14,000 /
# 2,400 tiles) drop part of it: conv2_down loses 14,989 active cells, in the
# reference as in the port (PERF.md, ``python tests/test_torch_tile_kernel.py``);
# these cover it with ~10% to spare. The reference's default plan window of
# 256 tiles misses neighbour targets on this frame (``tilek_miss`` 34,238 at
# conv1): the TPU kernel DMAs a window of that many tiles per cluster, so it
# must be narrow there, but the CUDA kernel reads each neighbour straight
# from the state by its rank, so a window as wide as the state (clipped to
# T1p by the plan) costs it nothing and leaves out no tap.
TILE_FRAME_BUDGETS = dict(tile_budgets=(73000, 90000, 43000, 2400), tilek_window=10 ** 6)


def flagship(engine: str = "window", budgets=None) -> ConfigDict:
    """The flagship config; ``engine="plane"`` or ``"tile"`` applies the
    reference bench's override (``backbone.engine`` set, for the tile engine
    with ``tile_backend = "pallas"``; ``dense_from_stage`` dropped), and
    ``budgets`` (such as ``FRAME_BUDGETS`` or ``TILE_FRAME_BUDGETS``), if
    given, replaces the engine's default budgets; every other knob keeps its
    default."""
    cfg = ConfigDict.fromfile(FLAGSHIP)
    if engine != "window":
        backbone = cfg["S_model"]["backbone"]
        backbone["engine"] = engine
        if engine == "tile":
            backbone["tile_backend"] = "pallas"
        backbone.pop("dense_from_stage", None)
        backbone.update(budgets or {})
    return cfg
