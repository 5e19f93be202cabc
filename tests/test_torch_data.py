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
sample from a fresh shuffle)."""
import os
import pickle

import numpy as np
import pytest
import torch

from sparse2dense_tpu.core import augment as jaug
from sparse2dense_tpu.core import box_np_ops as jbox
from sparse2dense_tpu.core import eval as jeval
from sparse2dense_tpu.core import sampler as jsampler
from sparse2dense_tpu.data import loader as jloader
from sparse2dense_tpu.ops import voxelize as jvox
from sparse2dense_tpu.ops.rotated_iou import rotated_iou_matrix as jax_iou
from sparse2dense_tpu_torch.core import augment as taug
from sparse2dense_tpu_torch.core import box_np_ops as tbox
from sparse2dense_tpu_torch.core import eval as teval
from sparse2dense_tpu_torch.core import sampler as tsampler
from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.data.datasets.waymo import sample_rng
from sparse2dense_tpu_torch.ops import voxelize as tvox
from sparse2dense_tpu_torch.ops.rotated_iou import rotated_iou_matrix as torch_iou
from tests.test_data_pipeline import CLASSES, _data_cfg, _write_synthetic_waymo
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

def test_box_np_ops_bit_equal():
    rng = np.random.RandomState(0)
    pts2, ang = rng.randn(6, 4, 2).astype(np.float32), rng.randn(6).astype(np.float32)
    dims3, cen3 = rng.uniform(0.5, 4, (6, 3)).astype(np.float32), rng.randn(6, 3).astype(np.float32)
    pts3 = rng.randn(6, 8, 3).astype(np.float32)
    boxes = np.concatenate([cen3, dims3, ang[:, None]], 1)
    cloud = rng.uniform(-3, 3, (500, 5)).astype(np.float32)
    pairs = [
        (tbox.rotation_2d(pts2, ang), jbox.rotation_2d(pts2, ang)),
        (tbox.corners_nd(dims3[:, :2]), jbox.corners_nd(dims3[:, :2])),
        (tbox.corners_nd(dims3, origin=(0.5, 0.5, 0.0)),
         jbox.corners_nd(dims3, origin=(0.5, 0.5, 0.0))),
        (tbox.center_to_corner_box2d(cen3[:, :2], dims3[:, :2], ang),
         jbox.center_to_corner_box2d(cen3[:, :2], dims3[:, :2], ang)),
        (tbox.center_to_corner_box3d(cen3, dims3, ang), jbox.center_to_corner_box3d(cen3, dims3,
                                                                                    ang)),
        (tbox.points_in_rbbox(cloud, boxes), jbox.points_in_rbbox(cloud, boxes)),
        (tbox.points_in_rbbox(cloud[:0], boxes), jbox.points_in_rbbox(cloud[:0], boxes)),
    ] + [(tbox.rotation_3d_in_axis(pts3, ang, axis=a), jbox.rotation_3d_in_axis(pts3, ang, axis=a))
         for a in (0, 1, 2)]
    for i, (got, want) in enumerate(pairs):
        assert_same(got, want, f"case {i}")
    assert tbox.points_in_rbbox(cloud, boxes).any()


# ---------------------------------------------------------------- voxelizer

@pytest.mark.parametrize("case", ["out_of_range", "point_cap", "voxel_overflow", "empty"])
def test_voxelizer_native_numpy_and_jax_bit_equal(case):
    """The native voxelizer, its NumPy version and JAX's points_to_voxel on
    points past the range on every side, voxels of more points than the cap
    and more voxels than the budget."""
    rng = np.random.RandomState(3)
    size, rng_box, cap, budget = [0.5, 0.5, 0.25], [-8.0, -8.0, -2.0, 8.0, 8.0, 4.0], 5, 20000
    if case == "out_of_range":
        pts = rng.uniform(-10, 10, (3000, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(-3, 5, 3000)
    elif case == "point_cap":
        pts = rng.uniform(-1, 1, (3000, 5)).astype(np.float32)   # ~7 points a voxel
    elif case == "voxel_overflow":
        pts, budget = rng.uniform(-8, 8, (3000, 5)).astype(np.float32), 700
    else:
        pts = np.zeros((0, 5), np.float32)
    native = tvox.points_to_voxel_native(pts, size, rng_box, cap, budget)
    plain = tvox.points_to_voxel(pts, size, rng_box, cap, budget)
    jax_side = jvox.points_to_voxel(pts, size, rng_box, cap, True, budget)
    assert_same(native, plain, "native vs numpy")
    assert_same(plain, jax_side, "numpy vs jax")
    nv = len(native[0])
    if case == "point_cap":
        assert native[2].max() == cap and nv < budget
    if case == "voxel_overflow":
        assert nv == budget
    gen = tvox.VoxelGenerator(size, rng_box, cap, max_voxels=budget)
    assert_same(gen.generate(pts, max_voxels=budget // 2),
                tvox.points_to_voxel(pts, size, rng_box, cap, budget // 2), "generate")


# ------------------------------------------------------------ augmentations

def test_augmentations_equal_for_the_same_generator_state():
    rng = np.random.RandomState(5)
    boxes = np.concatenate([rng.randn(6, 6), rng.randn(6, 2), rng.randn(6, 1)], 1).astype(
        np.float32)
    streams = [rng.randn(40, 5).astype(np.float32) for _ in range(3)]
    calls = [
        ("random_flip_both", {}), ("global_rotation", dict(rotation=[-0.78, 0.78])),
        ("global_rotation", dict(rotation=0.3)), ("global_translate", {}),
        ("global_translate", dict(noise_translate_std=[0.2, 0.3, 0.1])),
    ]
    for seed in range(4):   # the flips' four outcomes over these seeds
        for name, kw in calls:
            out_t = getattr(taug, name)(boxes.copy(), [s.copy() for s in streams],
                                        rng=np.random.RandomState(seed), **kw)
            out_j = getattr(jaug, name)(boxes.copy(), [s.copy() for s in streams],
                                        rng=np.random.RandomState(seed), **kw)
            assert_same(out_t, out_j, f"{name} seed {seed}")
        assert_same(taug.global_scaling(boxes.copy(), [streams[0].copy()], 0.9, 1.1,
                                        rng=np.random.RandomState(seed)),
                    jaug.global_scaling(boxes.copy(), [streams[0].copy()], 0.9, 1.1,
                                        rng=np.random.RandomState(seed)), "global_scaling")
    assert_same(taug.rotation_points_single_angle(streams[0][:, :3], 0.7, axis=1),
                jaug.rotation_points_single_angle(streams[0][:, :3], 0.7, axis=1), "rotation")
    bev = np.concatenate([rng.uniform(-4, 4, (12, 2)), rng.uniform(0.5, 3, (12, 2)),
                          rng.uniform(-3, 3, (12, 1))], 1).astype(np.float32)
    coll = taug.box_collision_test(bev, bev)
    assert_same(coll, jaug.box_collision_test(bev, bev), "collision")
    assert coll[~np.eye(12, dtype=bool)].any()


def test_dense_object_sets_and_gtaug_equal(records):
    gt_dir = os.path.join(records["root"], "gt")
    box = np.array([3.0, -2.0, 0.5, 2.0, 4.5, 1.7, 0.3], np.float32)
    for name in ("VEHICLE", "PEDESTRIAN"):
        got = tsampler.dense_points_for_box(gt_dir, "obj_0_0", name, box)
        assert_same(got, jsampler.dense_points_for_box(gt_dir, "obj_0_0", name, box), name)
    assert tsampler.dense_points_for_box(gt_dir, "missing", "VEHICLE", box) is None
    scene = np.array([[2.0, 2.0, 0.5, 1.9, 4.4, 1.6, 0.0, 0.0, 0.2],
                      [-3.0, -1.0, 0.4, 0.8, 0.9, 1.7, 0.0, 0.0, -0.5]], np.float32)
    names = np.array(["VEHICLE", "PEDESTRIAN"])
    cfg = _gtaug(records["db_info_path"])
    for seed in range(3):
        port = tsampler.build_dbsampler(cfg, gt_dir=gt_dir)
        got = port.sample_all(records["root"], scene, names, 5, distillation=True,
                              rng=np.random.RandomState(seed))
        np.random.seed(seed)
        want = jsampler.build_dbsampler(cfg, gt_dir=gt_dir).sample_all(
            records["root"], scene, names, 5, distillation=True)
        assert_same(got, want, f"sample_all seed {seed}")
        assert len(got["gt_boxes"]) > 0
    assert tsampler.build_dbsampler(dict(cfg, enable=False)) is None


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


def test_sharded_sampler_indices_equal():
    for drop_last in (True, False):
        for shard in range(3):
            kw = dict(shuffle=True, seed=7, num_shards=3, shard_id=shard, drop_last=drop_last)
            got, want = tloader.ShardedSampler(10, **kw), jloader.ShardedSampler(10, **kw)
            for epoch in range(2):
                assert_same(got.epoch_indices(epoch), want.epoch_indices(epoch),
                            f"shard {shard} epoch {epoch}")
    assert_same(tloader.ShardedSampler(5, shuffle=False).epoch_indices(3), np.arange(5))


def test_wrappers_map_keys_to_their_frames(records):
    from sparse2dense_tpu_torch.data.datasets.wrappers import ConcatDataset, RepeatDataset

    port = _datasets(records, "distill")[0]
    both, twice = ConcatDataset([port, port]), RepeatDataset(port, 2)
    assert len(both) == len(twice) == 2 * N_FRAMES
    for key, frame in (((0, 1, 6), 2), ((3, 0, 1), 1)):
        want = port.get(frame, sample_rng(*key))
        assert_same(both[key], want, f"concat {key}")
        assert_same(twice[key], want, f"repeat {key}")


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


# ------------------------------------------------------------------ eval

def _degenerate_pairs():
    """Identical, contained, edge-touching, corner-touching, 90-degree,
    disjoint and zero-size rect pairs (cx, cy, dx, dy, heading)."""
    a = [[0, 0, 2, 4, 0.3], [0, 0, 4, 4, 0], [0, 0, 2, 2, 0], [0, 0, 2, 2, 0],
         [1, 1, 2, 4, 0], [0, 0, 2, 2, 0], [0, 0, 0, 0, 0]]
    b = [[0, 0, 2, 4, 0.3], [0.5, 0.5, 1, 1, 0.4], [2, 0, 2, 2, 0], [2, 2, 2, 2, 0],
         [1, 1, 2, 4, np.pi / 2], [10, 10, 1, 1, 0], [0, 0, 1, 1, 0]]
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


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
