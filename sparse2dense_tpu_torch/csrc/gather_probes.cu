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
// - run_gather: persistent blocks, each with one thread that issues every
//   copy: a cp.async.bulk global -> shared copy of R rows per run on a ring
//   of 16 slots (16 copies in flight, the TPU kernel's NSLOT), each slot
//   tracked by its mbarrier, and a bulk shared -> global store of each run
//   once it has landed. The TPU kernel is one grid step on one core; here
//   the runs are spread over every SM.
// An index out of range stops the kernel with a trap, as PyTorch's own
// indexing kernels stop with a device-side assert.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 16;           // run_gather: copies in flight per block
constexpr int kThreads = 256;        // take and window_take block size

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the bulk
// copies' completion) and to the other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of transactions for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk copy global -> shared (16 B-aligned, a multiple of 16 B), completed
// on `bar` as `bytes` transactions. A CTA launched without a cluster is its
// own cluster, so the ::cluster destination is this block's shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

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

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

__global__ void __launch_bounds__(32)
run_gather_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                  float* __restrict__ out, int n, int v, int run_len, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kSlots];
  if (threadIdx.x != 0) return;  // one thread issues every copy of the block
  const uint32_t bytes = static_cast<uint32_t>(run_len) * c * 4;
  const uint32_t slot0 = smem_addr(smem);
  const uint32_t bar0 = smem_addr(bars);
  const int first = blockIdx.x, step = gridDim.x;
  const int k_runs = first < n ? (n - first + step - 1) / step : 0;
  for (int s = 0; s < kSlots; ++s) mbar_init(bar0 + 8 * s, 1);
  fence_barrier_init();

  auto issue = [&](int k) {  // run k of this block into slot k % kSlots
    const int src = __ldg(idx + first + static_cast<long>(k) * step);
    if (src < 0 || src > v - run_len || src % run_len) __trap();
    const int s = k % kSlots;
    mbar_expect_tx(bar0 + 8 * s, bytes);
    bulk_load(slot0 + s * bytes, feat + static_cast<long>(src) * c, bytes, bar0 + 8 * s);
  };

  for (int k = 0; k < min(kSlots, k_runs); ++k) issue(k);
  for (int k = 0; k < k_runs; ++k) {
    const int s = k % kSlots;
    mbar_wait(bar0 + 8 * s, (k / kSlots) & 1);
    const long run = first + static_cast<long>(k) * step;
    bulk_store(out + run * run_len * c, slot0 + s * bytes, bytes);
    // refill the previous run's slot once its store has read it, leaving
    // this run's store in flight
    if (k >= 1 && k - 1 + kSlots < k_runs) {
      bulk_wait_read<1>();
      issue(k - 1 + kSlots);
    }
  }
  bulk_wait_all();  // every store has landed before the block exits
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
  const size_t smem = static_cast<size_t>(kSlots) * run_len * c * 4;
  int e = opt_in_smem(run_gather_kernel, smem);
  if (e) return e;
  int per_sm = 0;
  e = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, run_gather_kernel, 32, smem));
  if (e) return e;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long slots = static_cast<long>(per_sm) * sm_count();
  const int grid = static_cast<int>(n < slots ? n : slots);
  if (grid > 0)
    run_gather_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const int*>(idx),
        static_cast<float*>(out), n, v, run_len, c);
  return static_cast<int>(cudaGetLastError());
}
