"""Python-file configs: a plain ``.py`` file whose module-level names become
the config (mirrors ``sparse2dense_tpu/utils/config.py``). The port's own
configs import nothing; reference-schema files (such as
``configs/tests/*_tiny.py``) import two det3d names, which the loader binds
to the port's own while the file runs (:func:`_det3d_names`)."""
from __future__ import annotations

import contextlib
import os
import runpy
import sys
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
        with _det3d_names():
            names = runpy.run_path(filename)
        return cls({k: v for k, v in names.items()
                    if not k.startswith("__")
                    and not isinstance(v, types.ModuleType)
                    and not callable(v)})


def get_downsample_factor(model_config) -> int:
    """A detector config's BEV downsampling: the product of the neck's
    strides over its last upsampling stride, times the backbone's
    ``ds_factor`` (det3d's config_tool)."""
    cfg = model_config if "neck" in model_config else model_config["first_stage_cfg"]
    neck = cfg["neck"]
    factor = 1.0
    for s in neck.get("ds_layer_strides", [1]):
        factor *= s
    us = neck.get("us_layer_strides", [])
    if len(us) > 0:
        factor /= us[-1]
    factor = int(factor * cfg["backbone"]["ds_factor"])
    if factor <= 0:
        raise ValueError(f"invalid downsample factor {factor}")
    return factor


@contextlib.contextmanager
def _det3d_names():
    """``det3d.builder.build_box_coder`` and
    ``det3d.utils.config_tool.get_downsample_factor`` (all that reference
    config files import) as the port's own while the block runs; the module
    names' earlier entries in ``sys.modules`` are put back after."""
    from ..core.box_coder import build_box_coder

    mods = {name: types.ModuleType(name) for name in
            ("det3d", "det3d.builder", "det3d.utils", "det3d.utils.config_tool")}
    mods["det3d.builder"].build_box_coder = build_box_coder
    mods["det3d.utils.config_tool"].get_downsample_factor = get_downsample_factor
    mods["det3d"].builder, mods["det3d"].utils = mods["det3d.builder"], mods["det3d.utils"]
    mods["det3d.utils"].config_tool = mods["det3d.utils.config_tool"]
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
# the flagship recipe's two stages: the dense teacher, then the distillation
# that loads its checkpoint
DENSE_TEACHER = os.path.join(CONFIGS, "waymo_centerpoint_voxelnet_3x_dense_interval_5.py")
FLAGSHIP = os.path.join(CONFIGS, "waymo_centerpoint_voxelnet_3x_distill_interval_5.py")
# the SECOND recipe's two stages, likewise
SECOND_DENSE = os.path.join(CONFIGS, "waymo_second_3x_dense_interval_5.py")
SECOND = os.path.join(CONFIGS, "waymo_second_3x_distill_interval_5.py")
# the pillar (CenterPoint-Pillar) recipe's two stages, likewise
PP_DENSE = os.path.join(CONFIGS, "waymo_centerpoint_pp_two_pfn_stride1_3x_dense_interval_5.py")
PP = os.path.join(CONFIGS, "waymo_centerpoint_pp_two_pfn_stride1_3x_distill_interval_5.py")
# the two-stage recipes: the flagship's and the pillar recipe's students as
# frozen first stages under the RoI head
TWO_STAGE = os.path.join(CONFIGS, "waymo_centerpoint_voxelnet_two_stage_distill_interval_5.py")
PP_TWO_STAGE = os.path.join(
    CONFIGS, "waymo_centerpoint_pp_two_pfn_stride1_two_stage_bev_distill_interval_5.py")
# the nuScenes recipes (one detector each, under ``model``): CenterPoint-VoxelNet
# at 0.1 m, at 0.075 m with translation noise, with DCN heads (the one that
# trains) and with DCN heads and double-flip test-time augmentation (the one
# that serves); CenterPoint-Pillar with rotated NMS, with circle NMS, and on
# the demo's records
NUSC_VOXELNET = {v: os.path.join(CONFIGS, f"nusc_centerpoint_voxelnet_{v}.py")
                 for v in ("01voxel", "0075voxel_fix_bn_z", "0075voxel_dcn",
                           "0075voxel_dcn_flip")}
NUSC_PP = {v: os.path.join(CONFIGS, "nusc_centerpoint_pp_02voxel_two_pfn_10sweep"
                           + ("" if v == "base" else f"_{v}") + ".py")
           for v in ("base", "circular_nms", "demo")}


def detector_cfg(cfg):
    """The model config a recipe trains and serves: ``S_model`` (a plain
    detector, or the student of a distillation), else ``model`` (the
    nuScenes recipes name their one detector so)."""
    return cfg["S_model"] if "S_model" in cfg else cfg["model"]


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

# window-engine knobs at dense_from_stage=2 for the same frame (teacher and
# student alike). Its conv3_down output holds 218,369 active cells: the
# recipe's stage budget of 210,000 drops 8,369 of them (in the reference as
# in the port), so stage 3's is 240,000 here. Its strided plan leaves 39,552
# rows to the residual pass at a window of 384 and 30,208 at 512, past the
# recipe's residual budget of 16,384: conv3_down takes a window of 512 (the
# widest the window kernel holds at 32->64) and the residual budget is
# 32,768. The conv2 blocks' subm plans leave no row at 384. Counted from the
# frame's coordinates on the CPU (``ops/window_conv.py``).
DFS2_FRAME_SETTINGS = dict(win_window=(384, 384, 512, 384), win_resid_budget=32768,
                           stage_budgets=(320000, 240000, 90000, 48000))


# window-engine knobs at dense_from_stage=3 and 99 for the same frame: those
# of dense_from_stage 2, with stage 4's plan window (conv4_down, the conv4
# blocks and extra_conv) at 512, the widest the window kernel holds at
# 128->128. The frame's conv4_down output holds 73,792 active cells and
# extra_conv's 42,568, within the recipe's stage budgets of 90,000 and
# 48,000. conv4_down's strided plan leaves 21,120 rows to the residual pass
# at a window of 512 (24,576 at 384), past the recipe's residual budget of
# 16,384 and within 32,768; the conv3 and conv4 blocks' subm plans and
# extra_conv's leave none. Counted on an H100 by ``tools/window_budgets.py``.
DFS3_FRAME_SETTINGS = DFS99_FRAME_SETTINGS = dict(
    win_window=(384, 384, 512, 512), win_resid_budget=32768,
    stage_budgets=(320000, 240000, 90000, 48000))


def frame_voxels(cfg, train: bool) -> int:
    """Voxel budget of the chip runs' synthetic frame (170k points, the
    reference bench's cloud) for ``cfg``: 150,000 voxels on the voxel
    models' grids, as the reference bench; the recipe's own
    ``max_voxel_num`` (train, test) for the pillar models."""
    model = detector_cfg(cfg)
    model = model.get("first_stage_cfg", model)   # a two-stage detector's
    if model["reader"]["type"] != "PillarFeatureNet":
        return 150000
    budget = cfg["voxel_generator"]["max_voxel_num"]
    return budget[0 if train else 1] if isinstance(budget, (list, tuple)) else budget


def flagship(engine: str = "window", budgets=None, path: str = FLAGSHIP) -> ConfigDict:
    """The flagship config (or the recipe config at ``path``, such as
    ``SECOND``); ``engine="plane"`` or ``"tile"`` applies the reference
    bench's override (``backbone.engine`` set, for the tile engine with
    ``tile_backend = "pallas"``; ``dense_from_stage`` dropped), ``"gather"``
    sets the engine alone, and ``budgets`` (such as ``FRAME_BUDGETS`` or
    ``TILE_FRAME_BUDGETS``), if given, replaces the engine's default
    budgets; every other knob keeps its default."""
    cfg = ConfigDict.fromfile(path)
    if engine != "window":
        backbone = cfg["S_model"]["backbone"]
        backbone["engine"] = engine
        if engine == "tile":
            backbone["tile_backend"] = "pallas"
        if engine != "gather":
            backbone.pop("dense_from_stage", None)
        backbone.update(budgets or {})
    return cfg
