"""The native voxelizer (``csrc/voxelizer.cpp``) bit-equal to its NumPy plain
version and the reference's ``points_to_voxel``: points out of range, the
per-voxel cap, the voxel budget's overflow, an empty cloud."""
import numpy as np
import pytest

from sparse2dense_tpu.ops import voxelize as jvox
from sparse2dense_tpu_torch.ops import voxelize as tvox

from tests.test_torch_data import assert_same


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
