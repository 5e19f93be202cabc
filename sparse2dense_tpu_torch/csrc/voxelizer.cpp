// Host-side hard voxelizer (native): the port's copy of the reference's
// sparse2dense_tpu/csrc/voxelizer.cpp.
//
// First-come-first-serve semantics of det3d's numba kernel
// (det3d/ops/point_cloud/point_cloud_ops.py:7-109): voxels indexed in order
// of first appearance along the point order, per-voxel points capped at
// max_points in arrival order, voxel count capped at max_voxels (points of
// new voxels beyond the cap are dropped). Coordinates returned zyx. It runs
// in the input pipeline, built with the host C++ compiler at first use into
// sparse2dense_tpu_torch/_build/ (ops/cuda_build.py build_host) and bound
// through ctypes (ops/voxelize.py); the vectorized NumPy points_to_voxel is
// its plain version.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of voxels written (<= max_voxels).
// points:      (n_points, n_feat) float32, xyz in the first 3 features
// voxel_size:  (3,) float32; coors_range: (6,) float32
// voxels:      out (max_voxels, max_points, n_feat) float32, zero-initialized
// coords:      out (max_voxels, 3) int32 (zyx)
// num_points:  out (max_voxels,) int32, zero-initialized
int64_t points_to_voxel_fcfs(
    const float* points, int64_t n_points, int64_t n_feat,
    const float* voxel_size, const float* coors_range,
    int64_t max_points, int64_t max_voxels,
    float* voxels, int32_t* coords, int32_t* num_points) {
  int64_t grid[3];
  for (int i = 0; i < 3; ++i) {
    // round() matches the reference's grid-size computation
    grid[i] = (int64_t)((coors_range[3 + i] - coors_range[i]) / voxel_size[i] + 0.5f);
  }
  const int64_t gx = grid[0], gy = grid[1], gz = grid[2];
  const int64_t n_cells = gx * gy * gz;

  // Dense cell -> voxel row map, persistent across calls per thread and
  // epoch-tagged: a cell's entry is valid only when its epoch matches the
  // current call, so the 90M-cell Waymo map (1504*1504*40) is never re-zeroed
  // — allocation and clearing would otherwise dominate the whole kernel.
  static thread_local std::vector<int32_t> cell_voxel;
  static thread_local std::vector<uint32_t> cell_epoch;
  static thread_local uint32_t epoch = 0;
  if ((int64_t)cell_voxel.size() < n_cells) {
    cell_voxel.assign((size_t)n_cells, -1);
    cell_epoch.assign((size_t)n_cells, 0);
    epoch = 0;
  }
  ++epoch;
  if (epoch == 0) {  // wrapped: re-zero once every 2^32 calls
    std::memset(cell_epoch.data(), 0, cell_epoch.size() * sizeof(uint32_t));
    epoch = 1;
  }

  int64_t n_voxels = 0;
  for (int64_t p = 0; p < n_points; ++p) {
    const float* pt = points + p * n_feat;
    int64_t c[3];
    bool ok = true;
    for (int i = 0; i < 3; ++i) {
      float f = (pt[i] - coors_range[i]) / voxel_size[i];
      int64_t ci = (int64_t)f;
      if (f < 0) ci -= 1;  // floor for negatives
      if (ci < 0 || ci >= grid[i]) { ok = false; break; }
      c[i] = ci;
    }
    if (!ok) continue;
    const int64_t key = (c[0] * gy + c[1]) * gz + c[2];  // x-major like reference
    int32_t v = (cell_epoch[(size_t)key] == epoch) ? cell_voxel[(size_t)key] : -1;
    if (v == -1) {
      if (n_voxels >= max_voxels) continue;  // drop points of new voxels
      v = (int32_t)n_voxels++;
      cell_voxel[(size_t)key] = v;
      cell_epoch[(size_t)key] = epoch;
      coords[v * 3 + 0] = (int32_t)c[2];  // zyx
      coords[v * 3 + 1] = (int32_t)c[1];
      coords[v * 3 + 2] = (int32_t)c[0];
    }
    int32_t np = num_points[v];
    if (np < max_points) {
      std::memcpy(voxels + ((int64_t)v * max_points + np) * n_feat, pt,
                  sizeof(float) * (size_t)n_feat);
      num_points[v] = np + 1;
    }
  }
  return n_voxels;
}

}  // extern "C"
