"""``core/box_np_ops``, the augmentations, the dense object sets with GT-AUG
and the dataset wrappers bit-equal to the reference's for the same generator
state (``tests/test_torch_data.py``'s records)."""
import os

import numpy as np

from sparse2dense_tpu.core import augment as jaug
from sparse2dense_tpu.core import box_np_ops as jbox
from sparse2dense_tpu.core import sampler as jsampler
from sparse2dense_tpu_torch.core import augment as taug
from sparse2dense_tpu_torch.core import box_np_ops as tbox
from sparse2dense_tpu_torch.core import sampler as tsampler
from sparse2dense_tpu_torch.data.datasets.waymo import sample_rng

from tests.test_torch_data import (  # noqa: F401 (fixtures)
    N_FRAMES, _datasets, _gtaug, assert_same, records)


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


def test_wrappers_map_keys_to_their_frames(records):
    from sparse2dense_tpu_torch.data.datasets.wrappers import ConcatDataset, RepeatDataset

    port = _datasets(records, "distill")[0]
    both, twice = ConcatDataset([port, port]), RepeatDataset(port, 2)
    assert len(both) == len(twice) == 2 * N_FRAMES
    for key, frame in (((0, 1, 6), 2), ((3, 0, 1), 1)):
        want = port.get(frame, sample_rng(*key))
        assert_same(both[key], want, f"concat {key}")
        assert_same(twice[key], want, f"repeat {key}")
