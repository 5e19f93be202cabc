// Gather probes for Hopper (sm_90a): three kernels that measure the card's
// gather mechanisms, as the probes of sparse2dense_tpu/tools/microbench.py
// measure the TPU's. feat is (V, C) float32 with C a multiple of 4, so a row
// is a whole number of 16-byte vectors (64 B at C = 16).
//
//   take         replaces k_tala2d (microbench.py:203, bench_pallas_take):
//                  out[i] = feat[idx[i]]
//   window_take  replaces the one-hot window kernel (microbench.py:285,
//                bench_pallas_onehot): for output block b of blk rows,
//                  out[b*blk + r] = feat[s_b + local[b*blk + r]],
//                  s_b = min(b*blk, V - W), local in [0, W)
//   run_gather   replaces the DMA gather kernel (microbench.py:358,
//                bench_pallas_dma): R rows per copy,
//                  out[i*R : (i+1)*R] = feat[idx[i] : idx[i] + R],
//                  idx[i] a multiple of R and idx[i] + R <= V
//
// Bound on an H100 (3.35 TB/s): bytes. Each probe must read the rows it
// gathers and its indices once and write its output once: at V = 2^17,
// C = 16, 8.39 + 0.52 + 8.39 MB, ~5.2 us. The table (8.4 MB) fits the 50 MB
// L2, so a probe run back to back reads it from L2 and can beat that bound.
//
// Each kernel uses the Hopper counterpart of the mechanism its TPU probe
// measures:
// - take: a plain global gather, four threads a 64 B row, one 16 B vector
//   load and store each, grid-stride. The TPU probe's table resident in VMEM
//   has no counterpart: shared memory cannot hold 8 MB; the L2 does.
// - window_take: one block per output block stages its W-row window in
//   shared memory with one cp.async.bulk copy completed on an mbarrier, then
//   every thread selects rows from it. This is the "window in shared memory"
//   primitive of a windowed sparse conv; the TPU's one-hot MXU matmul has no
//   place here, a GPU indexes.
// - run_gather: the asynchronous bulk copy, the counterpart of the TPU's
//   DMA: a cp.async.bulk global -> shared copy of the R rows of a run,
//   completed on an mbarrier, then a bulk shared -> global store of the
//   landed run. Every lane of a one-warp block issues, waits on and
//   stores its own runs through a slot of its own; it waits for a store to
//   have read the slot only when the slot comes round again (its next run),
//   so no store is waited for on the way. Runs are dealt block-first (run r
//   to block r % grid, lane (r / grid) % 32), and the grid is as many
//   blocks as fit the SMs at once (at most one a run): R = 64's 2,048 runs
//   of 4 KB give each of the 132 SMs one block with 15-16 runs, all in
//   flight at once; R = 8 (512 B) and R = 1 (64 B) fit 12 and 32 blocks an
//   SM, so every run has a lane of its own there too. Variants tried on the
//   H100 on copies of this source chose one slot a lane: more slots a lane
//   mean fewer blocks and were slower at every R, as were runs split into
//   smaller copies; a lane's first index load is issued before it sets up
//   its barrier, which shortens the chain a lane waits through. What bounds
//   it: at R >= 8 HBM bytes cold; warm, the copy engine of each SM, which
//   takes every load and store of its runs (with loads or stores alone a
//   copy kept most of the time); at R = 1 (131,072 copies of 64 B) the rate
//   at which the SMs take copies.
// An index out of range stops the kernel with a trap, as PyTorch's own
// indexing kernels stop with a device-side assert.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kBarBytes = 256;       // run_gather: a block's 32 mbarriers
constexpr int kThreads = 256;        // take and window_take block size

// Bulk copy shared -> global, tracked in bulk-async groups.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N of this thread's bulk groups still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads)
take_kernel(const float4* __restrict__ feat, const int* __restrict__ idx,
            float4* __restrict__ out, long n_quads, int quads_per_row, int v) {
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long q = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; q < n_quads;
       q += stride) {
    const long row = q / quads_per_row;
    const int src = __ldg(idx + row);
    if (static_cast<unsigned>(src) >= static_cast<unsigned>(v)) __trap();
    out[q] = __ldg(feat + static_cast<long>(src) * quads_per_row + (q - row * quads_per_row));
  }
}

__global__ void __launch_bounds__(kThreads)
window_take_kernel(const float* __restrict__ feat, const int* __restrict__ local,
                   float4* __restrict__ out, int v, int quads_per_row, int blk, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const float4* win = reinterpret_cast<const float4*>(smem);
  const long b = blockIdx.x;
  const long start = b * blk < v - w ? b * blk : v - w;  // clamped at the tail
  const uint32_t bar_a = smem_addr(&bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_a, 1);
    fence_barrier_init();
    const uint32_t bytes = static_cast<uint32_t>(w) * quads_per_row * 16;
    mbar_expect_tx(bar_a, bytes);
    bulk_load(smem_addr(smem), feat + start * quads_per_row * 4, bytes, bar_a);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  const int* loc = local + b * blk;
  float4* o = out + b * blk * quads_per_row;
  mbar_wait(bar_a, 0);
  for (int q = threadIdx.x; q < blk * quads_per_row; q += kThreads) {
    const int r = q / quads_per_row;
    const int l = __ldg(loc + r);
    if (static_cast<unsigned>(l) >= static_cast<unsigned>(w)) __trap();
    o[q] = win[l * quads_per_row + (q - r * quads_per_row)];
  }
}

// Every lane issues its own runs, first + k * issuers for k = 0, 1, ...,
// through one slot of the lane's own (barriers first in shared memory, then
// the slots).
__global__ void __launch_bounds__(32)
run_gather_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                  float* __restrict__ out, int n, int v, int run_len, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const uint32_t bytes = static_cast<uint32_t>(run_len) * c * 4;
  const uint32_t bar = smem_addr(smem) + lane * 8;
  const uint32_t slot = smem_addr(smem) + kBarBytes + lane * bytes;
  const long issuers = static_cast<long>(gridDim.x) * 32;
  const long first = static_cast<long>(lane) * gridDim.x + blockIdx.x;
  if (first >= n) return;
  int src = __ldg(idx + first);  // in flight while the barrier is set up
  mbar_init(bar, 1);
  fence_barrier_init();
  uint32_t parity = 0;
  for (long run = first; run < n; run += issuers, parity ^= 1) {
    if (run != first) src = __ldg(idx + run);
    if (src < 0 || src > v - run_len || src % run_len) __trap();
    bulk_wait_read<0>();  // the slot's last store has read it
    mbar_expect_tx(bar, bytes);
    bulk_load(slot, feat + static_cast<long>(src) * c, bytes, bar);
    mbar_wait(bar, parity);
    bulk_store(out + run * run_len * c, slot, bytes);
  }
  bulk_wait_read<0>();  // the last store has read the slot before the lane exits
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

// Each launches on `stream` and returns the cudaGetLastError() code
// (0 = launched); a launch refused (too much shared memory) never runs.
extern "C" int s2d_take(const void* feat, const void* idx, void* out, int v, int n, int c,
                        void* stream) {
  const int qpr = c / 4;
  const long n_quads = static_cast<long>(n) * qpr;
  const long want = (n_quads + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 8L * sm_count() ? want : 8L * sm_count());
  if (grid > 0)
    take_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(feat), static_cast<const int*>(idx),
        static_cast<float4*>(out), n_quads, qpr, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2d_window_take(const void* feat, const void* local, void* out, int v, int n,
                               int c, int blk, int w, void* stream) {
  const size_t smem = static_cast<size_t>(w) * c * 4;
  const int e = opt_in_smem(window_take_kernel, smem);
  if (e) return e;
  if (n > 0)
    window_take_kernel<<<n / blk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const int*>(local),
        static_cast<float4*>(out), v, c / 4, blk, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2d_run_gather(const void* feat, const void* idx, void* out, int v, int n,
                              int c, int run_len, void* stream) {
  const size_t smem = kBarBytes + static_cast<size_t>(32) * run_len * c * 4;
  int e = opt_in_smem(run_gather_kernel, smem);
  if (e) return e;
  int per_sm = 0;
  e = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, run_gather_kernel, 32, smem));
  if (e) return e;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long blocks = static_cast<long>(per_sm) * sm_count();
  const int grid = static_cast<int>(n < blocks ? n : blocks);
  if (grid > 0)
    run_gather_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const int*>(idx),
        static_cast<float*>(out), n, v, run_len, c);
  return static_cast<int>(cudaGetLastError());
}
