"""The port's host data layer against the JAX package's, on the CPU, at the
sizes of ``tests/test_data_pipeline.py``: Waymo-layout records written by
its ``_write_synthetic_waymo`` (4 frames of 800 points, 3 objects), the
dense object sets and the GT-AUG database of
``tests/test_gtaug_distill_pipeline.py``.

Bit-equal: the rest of ``box_np_ops``; the voxelizer (native and NumPy
against JAX's ``points_to_voxel``) with points out of range, the per-voxel
cap and the ``max_voxels`` overflow; the augmentations, the dense object
sets (vehicles mirrored) and GT-AUG's ``sample_all`` for a generator in the
same state; every example of ``WaymoDataset[i]`` (train with distillation
off and on, with GT-AUG, val), their ``collate``; ``ShardedSampler``'s
indices; the loader's batches with 0 and 2 workers against JAX's
``InputPipeline``. Within 1e-6: ``rotated_iou_matrix`` (random and
degenerate pairs), ``evaluate_detections`` and ``WaymoDataset.evaluation``.

A sample's draws come from ``np.random.RandomState([seed, epoch,
index])`` in the port; the reference draws from NumPy's global generator,
so it is seeded with the same key before each of its calls (and, with
GT-AUG, its db sampler is built anew just then: the port's starts every
sample from a fresh shuffle).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the loader,
``rotated_iou_matrix`` and the evaluation,
``tests/test_torch_data_loader.py``; the voxelizer,
``tests/test_torch_data_voxelizer.py``; ``box_np_ops``, the augmentations, the
dense sets and the wrappers, ``tests/test_torch_data_augment.py``; the
sampler, ``tests/test_torch_data_sampler.py``."""
import os

import numpy as np
import pytest
import torch

from sparse2dense_tpu.core import sampler as jsampler
from sparse2dense_tpu.data import loader as jloader
from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.data.datasets.waymo import sample_rng
from tests.test_data_pipeline import _data_cfg, _write_synthetic_waymo
from tests.test_gtaug_distill_pipeline import _write_db, _write_gt_objects

N_FRAMES, N_OBJ = 4, 3


def assert_same(got, want, where="example"):
    """Equal structure, keys, dtypes and values (arrays bit for bit)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


# ------------------------------------------------------------------ records

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The frames, their objects' dense sets and a GT-AUG database."""
    root = str(tmp_path_factory.mktemp("waymo"))
    info_path = _write_synthetic_waymo(root, n_frames=N_FRAMES, n_obj=N_OBJ)
    rng = np.random.RandomState(1)
    ids = [f"obj_{i}_{j}" for i in range(N_FRAMES) for j in range(N_OBJ - 1)]
    _write_gt_objects(os.path.join(root, "gt"), ids + [f"dbobj_{i}" for i in range(6)], rng)
    return dict(root=root, info_path=info_path, db_info_path=_write_db(root, rng))


def _gtaug(db_info_path):
    return dict(type="GT-AUG", enable=True, db_info_path=db_info_path,
                sample_groups=[dict(VEHICLE=4), dict(PEDESTRIAN=3), dict(CYCLIST=3)],
                db_prep_steps=[dict(filter_by_min_num_points=dict(VEHICLE=5, PEDESTRIAN=5,
                                                                  CYCLIST=5)),
                               dict(filter_by_difficulty=[-1])],
                global_random_rotation_range_per_object=[0, 0], rate=1.0)


def _cfg(records, split):
    """The data config of ``split``: "train", "distill", "gtaug" (distill
    and GT-AUG) or "val" (distill, the test pipeline's stages)."""
    cfg = _data_cfg(records["info_path"], records["root"], split != "train")
    pre = cfg["pipeline"][2]["cfg"]
    if split == "gtaug":
        pre["db_sampler"] = _gtaug(records["db_info_path"])
    if split == "val":
        cfg["pipeline"][2]["cfg"] = dict(mode="val", shuffle_points=False, distillation=True,
                                         gt_dir=pre["gt_dir"])
        cfg["pipeline"][-1] = dict(type="Reformat")
        cfg["test_mode"] = True
    return cfg


class SeededJaxDataset:
    """The reference's dataset with NumPy's global generator seeded by the
    port's key before each frame (and, with GT-AUG, its db sampler built
    anew then)."""

    def __init__(self, ds, db_cfg=None, seed=0):
        self.ds, self.db_cfg, self.seed, self.epoch = ds, db_cfg, seed, 0
        self.pre = ds.pipeline.transforms[2]

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        np.random.seed([self.seed, self.epoch, i])
        if self.db_cfg is not None:
            self.pre.db_sampler = jsampler.build_dbsampler(self.db_cfg, gt_dir=self.pre.gt_dir)
        return self.ds[i]


def _datasets(records, split):
    cfg = _cfg(records, split)
    db_cfg = cfg["pipeline"][2]["cfg"]["db_sampler"] if split == "gtaug" else None
    return tloader.build_dataset(cfg), SeededJaxDataset(jloader.build_dataset(cfg), db_cfg)


# ------------------------------------------------------------------ box ops


# ---------------------------------------------------------------- voxelizer


# ------------------------------------------------------------ augmentations


# -------------------------------------------------------- the whole pipeline

@pytest.mark.parametrize("split", ["train", "distill", "gtaug", "val"])
def test_waymo_dataset_examples_and_collate_bit_equal(records, split):
    port, jax_side = _datasets(records, split)
    assert len(port) == len(jax_side) == N_FRAMES
    examples = [port[i] for i in range(N_FRAMES)]
    want = [jax_side[i] for i in range(N_FRAMES)]
    for i, (got, ref) in enumerate(zip(examples, want)):
        assert_same(got, ref, f"{split} frame {i}")
    assert ("dense_voxels" in examples[0]) == (split in ("distill", "gtaug"))
    assert ("hm" in examples[0]) == (split != "val")
    assert_same(tloader.collate(examples, 256), jloader.collate(want, 256), "collate")
    assert_same(port[0, 1, 2], port.get(2, sample_rng(0, 1, 2)), "key")
    assert_same(port[2], port[0, 0, 2], "index")


# ------------------------------------------------------------------ eval

def _degenerate_pairs():
    """Identical, contained, edge-touching, corner-touching, 90-degree,
    disjoint and zero-size rect pairs (cx, cy, dx, dy, heading)."""
    a = [[0, 0, 2, 4, 0.3], [0, 0, 4, 4, 0], [0, 0, 2, 2, 0], [0, 0, 2, 2, 0],
         [1, 1, 2, 4, 0], [0, 0, 2, 2, 0], [0, 0, 0, 0, 0]]
    b = [[0, 0, 2, 4, 0.3], [0.5, 0.5, 1, 1, 0.4], [2, 0, 2, 2, 0], [2, 2, 2, 2, 0],
         [1, 1, 2, 4, np.pi / 2], [10, 10, 1, 1, 0], [0, 0, 1, 1, 0]]
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def _detections(infos, seed=0):
    """Jittered ground truth plus random boxes, a mix of matches and misses."""
    rng = np.random.RandomState(seed)
    dets = {}
    for info in infos:
        gt = info["gt_boxes"]
        noisy = gt + rng.normal(0, 0.15, gt.shape).astype(np.float32)
        extra = gt[rng.permutation(len(gt))] + rng.uniform(-3, 3, gt.shape).astype(np.float32)
        boxes = np.concatenate([noisy, extra])[:, [0, 1, 2, 3, 4, 5, 6, 7, 8]]
        dets[info["token"]] = {"box3d_lidar": boxes,
                               "scores": rng.uniform(0.1, 1, len(boxes)).astype(np.float32),
                               "label_preds": rng.randint(0, 3, len(boxes))}
    return dets


def _close(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}[{k}]")
    elif isinstance(want, str):
        assert got == want, where
    else:
        assert abs(got - want) <= 1e-6, (where, got, want)


