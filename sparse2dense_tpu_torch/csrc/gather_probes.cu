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
// measures. At these sizes (8.4 MB in and out, ~5 us of bytes) a call is
// mostly latency: each design shortens the chain a lane waits through and
// keeps as many loads in flight as the bytes allow.
// - take: a gather of rows by warp batches through shared memory. The TPU
//   probe's table resident in VMEM has no counterpart (shared memory cannot
//   hold 8 MB; the L2 does). A warp takes a batch of 32 consecutive output
//   rows: each lane loads one row's index in one coalesced load, one ballot
//   tests the batch (one trap test a batch, not a thread), and the row
//   starts reach the lanes that copy them by __shfl_sync. The batch's rows
//   land in the warp's tile of shared memory by cp.async (16 B, .cg, dealt
//   to the lanes in order, so every lane is busy at any C that is a
//   multiple of 4), all issued before any is waited for, and lane 0 writes
//   the tile, the batch's contiguous output, by one bulk copy; the next
//   batch's indices load while this batch's rows are in flight. The grid is
//   one wave (as many blocks as fit the SMs at once), so at V = 2^17 every
//   warp has one batch and the whole table is requested at once. Measured
//   and left out (PERF.md): the rows in registers with streaming stores
//   (~1 us slower cold), and batches of 64 rows.
// - window_take: the "window in shared memory" primitive of a windowed
//   sparse conv; the TPU's one-hot MXU matmul has no place here, a GPU
//   indexes. A block bulk-copies its output block's window and, on an
//   mbarrier of its own, the block's local indices, so both are in flight
//   together; it tests them before it waits on the window, then selects into
//   streaming stores. Every output block has a block of its own. Measured
//   and left out (PERF.md): persistent blocks sliding their windows through
//   a ring of shared memory, which stage each row once a block (10.5 MB
//   instead of 16.8 at (blk, w) = (256, 512)) but were slower at every
//   shape: the L2 takes the second read of a row, and a block's steps
//   wait on each other.
//   What bounds take and window_take on an H100 (PERF.md, ablation copies):
//   L2-cold, the fixed cost of a cold call (~4.5-5 us for an empty kernel
//   after the timer's flush) plus the bytes: both read within ~8% of a copy
//   of the same bytes. L2-warm, take's stores (~4.1 of its ~5.6 us without
//   them) and window_take's window copies and stores alike.
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
#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBarBytes = 256;       // run_gather: a block's 32 mbarriers
constexpr int kThreads = 256;        // take and window_take block size
constexpr int kWarps = kThreads / 32;
constexpr int kTakeRows = 32;        // take: rows a warp batch, at most (an index a lane)
constexpr int kTakeLoads = 4;        // take: 16 B copies a lane issues, unrolled
constexpr size_t kTakeSmem = 64 * 1024;  // take: a block's tiles, at most

// Bulk copy shared -> global, tracked in bulk-async groups.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's reads (a bulk store of what it wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// At most N of this thread's bulk groups still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Batch k of a warp is output rows [R k, R k + R), R = rows <= 32 (32, or
// fewer where 8 warps' tiles of 32 rows would not fit kTakeSmem); lane l
// holds the index of row l (0 past n or R). Vector f of the batch's output
// (16 B, f < R * qpr) is quad f % qpr of row f / qpr; lane l copies f = l,
// l + 32, ... by cp.async into the warp's tile, which lane 0 then stores by
// one bulk copy.
__global__ void __launch_bounds__(kThreads)
take_kernel(const float4* __restrict__ feat, const int* __restrict__ idx,
            float4* __restrict__ out, int n, int qpr, int v, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const uint32_t tile = smem_addr(smem) + (threadIdx.x >> 5) * rows * qpr * 16;
  const long warps = static_cast<long>(gridDim.x) * kWarps;
  const long batches = (static_cast<long>(n) + rows - 1) / rows;
  long batch = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  auto load_idx = [&](long b) {
    const long r = b * rows + lane;
    return lane < rows && r < n ? __ldg(idx + r) : 0;
  };
  int ix = batch < batches ? load_idx(batch) : 0;
  for (; batch < batches; batch += warps) {  // warp-uniform
    if (__any_sync(kFull, static_cast<unsigned>(ix) >= static_cast<unsigned>(v)))
      __trap();  // one test a batch
    const long first = batch * rows;
    const int quads = static_cast<int>(n - first < rows ? n - first : rows) * qpr;
    const long next = batch + warps;
    if (lane == 0) bulk_wait_read<0>();  // the last batch's store has read the tile
    __syncwarp();
    for (int k0 = 0; k0 * 32 < quads; k0 += kTakeLoads) {
#pragma unroll
      for (int u = 0; u < kTakeLoads; ++u) {
        const int f = (k0 + u) * 32 + lane;
        const int r = f / qpr;
        const int src = __shfl_sync(kFull, ix, r & 31);
        if (f < quads)
          cp_async16(tile + f * 16, feat + static_cast<long>(src) * qpr + (f - r * qpr), 16);
      }
    }
    cp_async_commit();
    ix = next < batches ? load_idx(next) : 0;  // in flight with the rows
    cp_async_wait_all();
    fence_proxy_async();  // the tile's writes are visible to the bulk store
    __syncwarp();
    if (lane == 0) bulk_store(out + first * qpr, tile, quads * 16);
  }
  if (lane == 0) bulk_wait_read<0>();  // the tile outlives its last store's read
}

// Block b is output block b: the rows of its window, [s_b, s_b + w) with
// s_b = min(b blk, v - w), and its blk local indices are bulk-copied into
// shared memory, each on an mbarrier of its own, so both are in flight
// together; the threads test the indices before they wait on the window,
// then select into streaming stores. (Rows and output rows fit an int.)
__global__ void __launch_bounds__(kThreads)
window_take_kernel(const float4* __restrict__ feat, const int* __restrict__ local,
                   float4* __restrict__ out, int v, int qpr, int blk, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];  // the indices, the window
  const float4* win = reinterpret_cast<const float4*>(smem);
  const int* loc = reinterpret_cast<const int*>(smem + static_cast<size_t>(w) * qpr * 16);
  const int b = blockIdx.x;
  const int start = b * blk < v - w ? b * blk : v - w;  // clamped at the tail
  const uint32_t ibar = smem_addr(&bars[0]), wbar = smem_addr(&bars[1]);
  if (threadIdx.x == 0) {
    mbar_init(ibar, 1);
    mbar_init(wbar, 1);
    fence_barrier_init();
    mbar_expect_tx(ibar, blk * 4);
    bulk_load(smem_addr(loc), local + static_cast<long>(b) * blk, blk * 4, ibar);
    const uint32_t bytes = static_cast<uint32_t>(w) * qpr * 16;
    mbar_expect_tx(wbar, bytes);
    bulk_load(smem_addr(win), feat + static_cast<long>(start) * qpr, bytes, wbar);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  const int quads = blk * qpr;
  mbar_wait(ibar, 0);
  for (int f = threadIdx.x; f < quads; f += kThreads)
    if (static_cast<unsigned>(loc[f / qpr]) >= static_cast<unsigned>(w)) __trap();
  mbar_wait(wbar, 0);
  float4* o = out + static_cast<long>(b) * quads;
  for (int f = threadIdx.x; f < quads; f += kThreads) {
    const int r = f / qpr;
    __stcs(o + f, win[loc[r] * qpr + (f - r * qpr)]);
  }
}

__global__ void empty_kernel() {}

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
  int rows = kTakeRows;  // a warp's tile of rows, as many as fit shared memory
  while (rows > 1 && static_cast<size_t>(kWarps) * rows * c * 4 > kTakeSmem) rows /= 2;
  const size_t smem = static_cast<size_t>(kWarps) * rows * c * 4;
  int e = opt_in_smem(take_kernel, smem);
  if (e) return e;
  int per_sm = 0;
  e = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, take_kernel, kThreads, smem));
  if (e) return e;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long batches = (static_cast<long>(n) + rows - 1) / rows;
  const long want = (batches + kWarps - 1) / kWarps;
  const long wave = static_cast<long>(per_sm) * sm_count();
  const int grid = static_cast<int>(want < wave ? want : wave);
  if (grid > 0)
    take_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(feat), static_cast<const int*>(idx),
        static_cast<float4*>(out), n, c / 4, v, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2d_window_take(const void* feat, const void* local, void* out, int v, int n,
                               int c, int blk, int w, void* stream) {
  const size_t smem = static_cast<size_t>(w) * c * 4 + static_cast<size_t>(blk) * 4;
  const int e = opt_in_smem(window_take_kernel, smem);
  if (e) return e;
  if (n > 0)
    window_take_kernel<<<n / blk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(feat), static_cast<const int*>(local),
        static_cast<float4*>(out), v, c / 4, blk, w);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: the fixed cost of one timed call (the timers' floor).
extern "C" int s2d_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
