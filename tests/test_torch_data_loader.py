"""The loader against JAX's ``InputPipeline`` (0 and 2 workers, two epochs,
GT-AUG on), ``rotated_iou_matrix`` within 1e-6 of JAX's, and the evaluation
within 1e-6 of JAX's (moved from ``tests/test_torch_data.py``, whose records
they read)."""
import pickle

import numpy as np
import pytest
import torch

from sparse2dense_tpu.core import eval as jeval
from sparse2dense_tpu.data import loader as jloader
from sparse2dense_tpu.ops.rotated_iou import rotated_iou_matrix as jax_iou
from sparse2dense_tpu_torch.core import eval as teval
from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.ops.rotated_iou import rotated_iou_matrix as torch_iou

from tests.test_data_pipeline import CLASSES
from tests.test_torch_data import (  # noqa: F401 (fixtures)
    _close, _datasets, _degenerate_pairs, _detections, assert_same, records)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_the_reference_pipeline(records, workers):
    """Two epochs of batches of 2 (GT-AUG and distillation on), in order."""
    port, jax_side = _datasets(records, "gtaug")
    loader = tloader.InputPipeline(port, 2, 256, seed=0, num_workers=workers, device="cpu")
    ref = jloader.InputPipeline(jax_side, batch_size=2, max_voxels=256, seed=0, prefetch=0,
                                to_device=False)
    assert len(loader) == len(ref) == 2
    for epoch in range(2):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        jax_side.epoch = epoch
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"epoch {epoch} batch {b}")
            assert g["voxels"].device == torch.device("cpu")


def test_rotated_iou_within_1e6_of_jax():
    rng = np.random.RandomState(11)
    a = np.concatenate([rng.uniform(-3, 3, (40, 2)), rng.uniform(0.3, 4, (40, 2)),
                        rng.uniform(-np.pi, np.pi, (40, 1))], 1).astype(np.float32)
    b = np.concatenate([rng.uniform(-3, 3, (30, 2)), rng.uniform(0.3, 4, (30, 2)),
                        rng.uniform(-np.pi, np.pi, (30, 1))], 1).astype(np.float32)
    da, db = _degenerate_pairs()
    for x, y in ((a, b), (da, db)):
        got = torch_iou(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(jax_iou(x, y))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    diag = np.diag(torch_iou(torch.from_numpy(da), torch.from_numpy(db)).numpy())
    np.testing.assert_allclose(diag[[0, 1, 2, 3, 5]], [1, 1 / 16, 0, 0, 0], atol=1e-6)
    assert (got > 0).any()


def test_evaluation_within_1e6_of_jax(records, tmp_path):
    port, jax_side = _datasets(records, "val")
    infos = port.infos
    dets = _detections(infos)
    gts = {i["token"]: {"gt_boxes": i["gt_boxes"],
                        "gt_classes": np.array([CLASSES.index(n) + 1 for n in i["gt_names"]])}
           for i in infos}
    got = teval.evaluate_detections(gts, dets, CLASSES)
    _close(got, jeval.evaluate_detections(gts, dets, CLASSES), "evaluate_detections")
    assert got["mAP"] > 0
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    out_t.mkdir()
    out_j.mkdir()
    res_t, _ = port.evaluation(dets, output_dir=str(out_t))
    res_j, _ = jax_side.ds.evaluation(dets, output_dir=str(out_j))
    _close(res_t, res_j, "evaluation")
    with open(out_t / "detection_pred.pkl", "rb") as f:
        assert_same(pickle.load(f), dets, "written detections")
    assert port.evaluation(dets, output_dir=str(out_t), testset=True) == (None, None)
    assert teval.heading_weight(0.1, 0.1 + 2 * np.pi) == pytest.approx(1.0)
