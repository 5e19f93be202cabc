"""Tile inference reads the plans' windows only on the "pallas" backend
(moved from ``tests/test_torch_tile_train.py``)."""
import numpy as np
import torch

from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD

from tests.test_torch_tile_train import ENGINES, GRID, SETTINGS, _coords


def test_tile_inference_reads_the_plan_windows_only_on_pallas():
    """In inference ``"xla"`` reads every tap and ``"pallas"`` keeps the
    plan windows, whose dropped targets it counts (``tilek_miss``)."""
    feats = torch.from_numpy(np.random.RandomState(9).randn(2, 200, 5).astype(np.float32))
    coords = torch.from_numpy(np.stack([_coords(s, GRID, 200, 20) for s in (7, 8)]))
    misses = {}
    for name in ("xla", "pallas"):
        mod = SpMiddleResNetFHD(dense_from_stage=1, **SETTINGS, **ENGINES[name]).eval()
        with torch.no_grad():
            _, _, tele = mod(feats, coords)
        misses[name] = int(tele["tilek_miss"][0].sum())
    assert misses["xla"] == 0 < misses["pallas"], misses
