"""The PyTorch port stands alone: none of its modules imports JAX or the
reference package, and its entry points do not fall back to the CPU."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import sparse2dense_tpu_torch
from sparse2dense_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        sparse2dense_tpu_torch.__path__, "sparse2dense_tpu_torch."))
    assert "sparse2dense_tpu_torch.ops.window_kernel" in mods
    assert "sparse2dense_tpu_torch.ops.plane_kernel" in mods
    assert "sparse2dense_tpu_torch.ops.tile_block_kernel" in mods
    assert "sparse2dense_tpu_torch.ops.gather_probes" in mods
    assert "sparse2dense_tpu_torch.tools.microbench" in mods
    for name in ("training.trainer", "training.distill", "training.train_state",
                 "solver.optim", "solver.schedules", "models.detectors.voxelnet",
                 "models.losses.centernet", "data.pipelines.assign_label", "core.center_utils",
                 "training.checkpoint", "training.hooks", "tools.train", "models.remat",
                 "core.box_np_ops", "core.box_coder", "core.anchors",
                 "data.pipelines.assign_target", "models.losses.second_losses",
                 "models.heads.mg_head"):
        assert f"sparse2dense_tpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'sparse2dense_tpu' or m.startswith('sparse2dense_tpu.'))\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    # chip_smoke.py imports inside its phases: none of them names JAX or the reference
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        imports = [line.split() for line in f if line.lstrip().startswith(("import ", "from "))]
    assert not [i for i in imports if i[1].split(".")[0] in ("jax", "sparse2dense_tpu")]


def test_entry_points_need_cuda_or_an_explicit_device():
    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.training.synthetic import make_batch
    from sparse2dense_tpu_torch.utils.config import FLAGSHIP, ConfigDict

    cfg = ConfigDict.fromfile(FLAGSHIP)
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.S_model, test_cfg=cfg.test_cfg, voxel_generator=cfg.voxel_generator)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, 1, max_voxels=16, n_points=64)


def test_other_engines_raise():
    from sparse2dense_tpu_torch.models.backbones.scn import (
        PlaneKBlock, SpMiddleFHD, SpMiddleResNetFHD, TileKBlock)

    kw = dict(num_input_features=5, sparse_shape=(41, 32, 32))
    plane = SpMiddleResNetFHD(engine="plane", **kw)
    assert isinstance(plane.conv4_1, PlaneKBlock)
    tile = SpMiddleResNetFHD(engine="tile", tile_backend="pallas", **kw)
    assert isinstance(tile.conv2_1, TileKBlock) and not isinstance(tile.conv3_1, TileKBlock)
    xla = SpMiddleResNetFHD(engine="tile", **kw)   # the reference's default backend
    assert xla.tile_backend == "xla" and isinstance(xla.conv2_1, TileKBlock)
    dense_conv1 = SpMiddleResNetFHD(engine="tile", tile_backend="pallas", dense_from_stage=0,
                                    **kw)
    assert not isinstance(dense_conv1.conv1_0, TileKBlock)
    assert dense_conv1.conv_input.conv_0_weight.shape == (16, 5, 3, 3, 3)
    assert SpMiddleResNetFHD(engine="gather", **kw).engine == "gather"
    with pytest.raises(NotImplementedError, match="column"):
        SpMiddleResNetFHD(engine="column", **kw)
    with pytest.raises(NotImplementedError, match="dense_from_stage"):
        SpMiddleResNetFHD(engine="window", dense_from_stage=3, **kw)
    for engine in ("plane", "tile", "column"):
        with pytest.raises(NotImplementedError, match=engine):
            SpMiddleFHD(engine=engine, **kw)
    with pytest.raises(NotImplementedError, match="dense_from_stage"):
        SpMiddleFHD(engine="window", dense_from_stage=3, **kw)
