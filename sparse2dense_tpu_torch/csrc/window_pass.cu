// Window pass of the windowed sparse 3D convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernels sparse2dense_tpu/ops/pallas/window_kernel.py:69
// (_dy_kernel, features resident in VMEM) and :116 (_dy_kernel_hbm, features
// in HBM, windows fetched by DMA): one function, which residency does not
// change on this card.
//
// Contract (ops/window_conv.py ConvPlan). Input rows are sorted by their
// guard-banded (y, x, z) key `lin`; valid keys are unique, padding is MISS.
// For output row r (block b = r / 128) and live dy group g, the tap j hits
// input row i of the rank window [s, s + window) when
//     lin[i] == kbase[r, g] + offsets[g, j],
// where s = min(ws[b, g] / 128, (v_in - window) / 128) * 128 (the start clip
// of window_kernel.py:81). kbase == GATE marks a dy group owned by the
// residual pass: it contributes nothing here, or those taps would be counted
// twice. dy_mask / j_mask prune the taps outside the kernel extent (ksize).
//     out[r] = sum over hits of bf16(feat[i]) @ bf16(W[g * 9 + j])
// with f32 products and f32 sums. Rows of a block with no hit are zeros.
//
// Design. The TPU kernel finds a tap's source row with a one-hot compare of
// the whole window contracted on the MXU (and transposes the target keys on
// the MXU). Here the source rows are found by search and the hits are
// contracted on the tensor cores. Blocks of 8 warps are persistent, as many
// as fit the SMs, and walk the plan's 128-row blocks; a unit of work is one
// (block, live dy group). A block is read first: a dy group whose 128 rows
// are all GATE (the padded tail of a strided plan's budget, or groups left
// to the residual pass) is no unit, and a block with none only writes its
// zeros.
// - Staging: the weights are laid out on the host as (27, Cout, Cin_pad + 8)
//   (window_kernel.window_weights: K-contiguous rows for ldmatrix, 16 B of
//   padding to spread them over the banks). At the resident widths (Cin <= 32,
//   Cout <= 64) all 27 taps come once a block by one bulk copy. A unit's
//   window is one contiguous range of `lin` and of `feat`, so it comes by one
//   bulk copy each, with the block's kbase rows, on an mbarrier; two buffers,
//   so the next unit's window lands while this one is contracted.
// - Streamed widths (64 -> 64, 64 -> 128, 128 -> 128). The resident layout
//   needs 27 x Cout x (Cin_pad + 8) x 2 B: 248,832 B at 64 -> 64, 497,664 at
//   64 -> 128 and 940,032 at 128 -> 128, past the 232,448 B a block may use.
//   Staging a dy group's 9 taps a unit (82,944 B at 64 -> 64, 313,344 at
//   128 -> 128) fits only the narrowest, and a 64-column slice of Cout at
//   128 -> 128 (156,672 B) leaves no room for a 384-row window of 128
//   channels (101,376 B with its kbase rows) beside the 4,864 B head. So the
//   window stays and the taps stream: each unit sends its live taps (by
//   j_mask: 9, or 3 on a z-only plan) one by one through a ring of kRing = 2
//   tap slots, each a bulk copy of Cout x (Cin_pad + 8) x 2 B (9,216,
//   18,432 and 34,816 B) on an mbarrier of its own. The unit's first two taps
//   are issued with the unit, so they land during its searches; tap k + 2 is
//   issued into tap k's slot when the block has finished with it (every
//   thread waits on each tap's barrier, then one __syncthreads frees the
//   slot). The taps are read from L2 once a unit: 313 KB a unit at
//   128 -> 128, against the window's 100 KB. The window buffers are two
//   where they fit and one else (window_kernel.window_buffers): two up to a
//   window of 640 rows at Cin 64 and of 256 at Cin 128; one up to 1,536 /
//   1,280 rows at 64 -> 64 / 64 -> 128 and 512 at 128 -> 128. With one
//   buffer a unit's window is fetched when the unit starts and is not
//   overlapped. Feature rows of 128 or 256 B put the 8 rows of an ldmatrix
//   on the same banks (the window comes by one bulk copy, unpadded): a
//   conflict this simple design accepts.
// - Search: within a dy group's run of three dz taps (j = 3 dx + dz) the
//   targets are consecutive keys (offsets[g, 3 dx + dz] = offsets[g, 3 dx] +
//   dz, checked per group: a run that breaks it is searched tap by tap), and
//   the window keys are sorted and unique, so one binary search per (row, dx)
//   finds the first tap's position and each next tap moves it by 0 or 1:
//   3 searches a row and group, not 9. The output rows' targets also rise
//   with the row inside a block (GATE rows aside; tests/
//   test_torch_window_layout.py holds this on subm, strided and z-only
//   plans), but the searches of a block run in parallel, one thread a
//   (row, dx), so that order is not used to shorten them. Measured and left
//   out: a merge along the rows. A copy with no searches at all, the most a
//   merge could save, was at most 11% faster (tools/bench_window_pass.py,
//   PERF.md).
// - Contraction: warp w owns rows 16 w .. 16 w + 15 of the block. Per live
//   tap with a hit among its rows it loads A (the 16 hit rows of the window,
//   a zero row on a miss) by ldmatrix from the staged window (Cin < 16: by
//   16-bit loads, zero past Cin), B by ldmatrix from the staged weights, and
//   runs mma.sync m16n8k16 into f32 accumulators, Cin / 16 steps a tap.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the pass is bytes-bound.
// At conv1 (150k rows, 16 -> 16 channels, window 384) it must read about
// 150k x 16 x 2 B of features plus the keys and write 150k x 16 x 4 B: about
// 17 MB, 5 us; its products are ~2 GFLOP at most (~2 us). This design reads
// each feature row once per unit whose window holds it (the windows of
// neighbouring blocks overlap, so several times the bytes, mostly from L2)
// and waits for each unit's searches before its products. At the streamed
// widths the bound moves towards the products: the conv4 blocks of the
// bench's frame (90,000 rows, 128 -> 128, ~1.2M hits) must move ~70 MB
// (21 us) and do ~39 GFLOP (40 us); this design also brings each unit's
// 9 taps (313 KB at 128 -> 128) from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBlock = 128;          // output rows per plan block
constexpr int kThreads = 256;        // 8 warps, 16 rows each
constexpr int kGate = -(1 << 29);    // ops/window_conv.py GATE
constexpr int kTaps = 9;             // (dx, dz) taps of a dy group
constexpr int kRing = 2;             // tap slots of the streamed widths
// shared memory head: mbarriers [0, 64) (weights 0, window buffers 8 and 16,
// tap slots 24 and 32), offsets [64, 192), a zero row [192, 256), hit table
// [256, 256 + 128 * 9 * 4)
constexpr int kHead = 256 + kBlock * kTaps * 4;
constexpr int kKbBytes = kBlock * 3 * 4;   // a block's kbase rows

// CINP: the input width the tensor cores see (16, 32, 64 or 128); SMALL:
// Cin < 16, feature rows of Cin values read by 16-bit loads; STREAM: the
// taps stream through kRing slots (else all 27 are resident)
template <int CINP, int COUT, bool SMALL, bool STREAM>
struct Shape {
  static constexpr int kWRow = CINP + 8;                       // weight row (co), bf16
  static constexpr uint32_t kTapBytes = COUT * kWRow * 2;
  // the resident taps, or the ring and a zero row of CINP values (the
  // head's holds 32)
  static constexpr uint32_t kWBytes = STREAM ? kRing * kTapBytes + CINP * 2 : 27 * kTapBytes;
  static_assert(!SMALL || CINP == 16, "shape");
  static_assert(COUT % 16 == 0 && kTapBytes % 16 == 0, "shape");
};

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the live tap j (a bit of j_mask) of rank n
__device__ __forceinline__ int nth_tap(int j_mask, int n) {
  for (int j = 0; j < kTaps; ++j)
    if (((j_mask >> j) & 1) && n-- == 0) return j;
  return 0;
}

// first position in keys[0, n) whose key is >= target (n if none)
__device__ __forceinline__ int lower_bound(const int* keys, int n, int target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// two 16-bit features of a row (0 at or past cin), as one A register
__device__ __forceinline__ uint32_t feat_pair(const unsigned short* f, int idx, int k, int cin) {
  if (idx < 0) return 0u;
  const uint32_t lo = k < cin ? f[idx * cin + k] : 0u;
  const uint32_t hi = k + 1 < cin ? f[idx * cin + k + 1] : 0u;
  return lo | (hi << 16);
}

// feat (v_in, cin) bf16; wl: weights (27, COUT, CINP + 8) bf16 (window_kernel.
// window_weights); out (nb * 128, COUT) f32. NBUF window buffers (1 or 2).
template <int CINP, int COUT, bool SMALL, bool STREAM, int NBUF>
__global__ void __launch_bounds__(kThreads)
window_pass_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ lin,
                   const int* __restrict__ kbase, const int* __restrict__ ws,
                   const int* __restrict__ offsets, const __nv_bfloat16* __restrict__ wl,
                   float* __restrict__ out, int v_in, int nb, int cin, int window,
                   int dy_mask, int j_mask) {
  using S = Shape<CINP, COUT, SMALL, STREAM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // barriers: the resident weights; the window buffers; the tap slots
  const uint32_t wbar = smem_addr(smem), full0 = wbar + 8, ring0 = wbar + 24;
  int* offs = reinterpret_cast<int*>(smem + 64);
  int* hidx = reinterpret_cast<int*>(smem + 256);            // (128 rows, 9 taps)
  unsigned char* wsm = smem + kHead;                         // 27 taps, or the ring
  unsigned char* zrow = STREAM ? wsm + kRing * S::kTapBytes : smem + 192;
  const uint32_t zero_row = smem_addr(zrow);
  const int row_bytes = cin * 2;
  const int buf_bytes = window * 4 + kKbBytes + window * row_bytes;
  unsigned char* buf0 = wsm + S::kWBytes;
  unsigned char* live = buf0 + NBUF * buf_bytes;             // live dy groups of my blocks
  const int mine = (nb - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int smax = (v_in - window) / 128;
  const int nl = __popc(j_mask & 0x1ff);   // live taps of a dy group

  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < NBUF; ++s) mbar_init(full0 + 8 * s, 1);
    for (int s = 0; s < kRing; ++s) mbar_init(ring0 + 8 * s, 1);
    fence_barrier_init();
    if constexpr (!STREAM) {
      mbar_expect_tx(wbar, S::kWBytes);
      bulk_load(smem_addr(wsm), wl, S::kWBytes, wbar);
    }
  }
  if (tid < 27) offs[tid] = offsets[tid];
  if (tid < (CINP > 32 ? CINP / 2 : 16)) reinterpret_cast<int*>(zrow)[tid] = 0;
  // a dy group of a block is live when one of its rows is not GATE
  for (int i = warp; i < mine; i += kThreads / 32) {
    const int* kb = kbase + static_cast<size_t>(blockIdx.x + i * gridDim.x) * kBlock * 3;
    int bits = 0;
    for (int r = lane; r < kBlock; r += 32)
#pragma unroll
      for (int g = 0; g < 3; ++g) bits |= (kb[r * 3 + g] != kGate) << g;
    bits = __reduce_or_sync(0xffffffffu, bits) & dy_mask;
    if (lane == 0) live[i] = static_cast<unsigned char>(bits);
  }
  __syncthreads();

  // the units (i, g) in order: my i-th block, its live dy groups
  int ni = 0, ng = -1;   // thread 0: the last unit issued (ni == mine: none left)
  auto advance = [&]() {
    if (ni >= mine) return false;
    for (;;) {
      if (++ng == 3) {
        ng = 0;
        if (++ni >= mine) return false;
      }
      if ((live[ni] >> ng) & 1) return true;
    }
  };
  auto issue = [&](int slot) {   // thread 0: unit (ni, ng) into buffer slot
    const int b = blockIdx.x + ni * gridDim.x;
    const long s = static_cast<long>(min(ws[b * 3 + ng] / 128, smax)) * 128;
    unsigned char* bp = buf0 + slot * buf_bytes;
    const uint32_t bar = full0 + 8 * slot;
    mbar_expect_tx(bar, buf_bytes);
    bulk_load(smem_addr(bp), lin + s, window * 4, bar);
    bulk_load(smem_addr(bp + window * 4), kbase + static_cast<size_t>(b) * kBlock * 3,
              kKbBytes, bar);
    bulk_load(smem_addr(bp + window * 4 + kKbBytes), feat + s * cin, window * row_bytes, bar);
  };
  // thread 0, streamed widths: the k-th live tap of dy group g, the block's
  // t-th tap, into ring slot t % kRing
  auto issue_tap = [&](int g, int k, uint32_t t) {
    const uint32_t slot = t % kRing, bar = ring0 + 8 * slot;
    mbar_expect_tx(bar, S::kTapBytes);
    bulk_load(smem_addr(wsm + slot * S::kTapBytes),
              wl + static_cast<size_t>(g * kTaps + nth_tap(j_mask, k)) * COUT * S::kWRow,
              S::kTapBytes, bar);
  };
  for (int s = 0; s + 1 < NBUF; ++s)
    if (tid == 0 && advance()) issue(s);

  const int gq = lane / 4, tig = lane % 4;   // mma row group, thread in group
  float acc[COUT / 8][4];
  if constexpr (!STREAM) mbar_wait(wbar, 0);
  uint32_t u = 0;   // units done
  uint32_t taps = 0;   // streamed taps done
  for (int i = 0; i < mine; ++i) {
#pragma unroll
    for (int n = 0; n < COUT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int g = 0; g < 3; ++g) {
      if (!((live[i] >> g) & 1)) continue;
      // the next units' windows land while this one is contracted: the
      // buffer of the last was freed by the barrier that ended the unit before
      // (one buffer: this unit's own window, issued now)
      if (tid == 0 && advance()) issue((u + NBUF - 1) % NBUF);
      if constexpr (STREAM) {
        if (tid == 0)   // the slots were freed by the last tap's barrier
          for (int k = 0; k < kRing && k < nl; ++k) issue_tap(g, k, taps + k);
      }
      unsigned char* bp = buf0 + (u % NBUF) * buf_bytes;
      const int* keys = reinterpret_cast<const int*>(bp);
      const int* kb = reinterpret_cast<const int*>(bp + window * 4);
      const unsigned char* fw = bp + window * 4 + kKbBytes;
      mbar_wait(full0 + 8 * (u % NBUF), (u / NBUF) & 1);

      // hits: a thread a (row, dx) run of three dz taps, -1 for none
      for (int task = tid; task < kBlock * 3; task += kThreads) {
        const int row = task % kBlock, dx = task / kBlock;
        if (!((j_mask >> (3 * dx)) & 7)) continue;
        const int base = kb[row * 3 + g];
        int p = -1, prev = 0;
        for (int dz = 0; dz < 3; ++dz) {
          const int j = 3 * dx + dz;
          const int target = base + offs[g * kTaps + j];
          int hit = -1;
          if (base != kGate) {
            if (p >= 0 && target == prev + 1)
              p += p < window && keys[p] == prev;   // the next key: at p or p + 1
            else
              p = lower_bound(keys, window, target);
            prev = target;
            if (p < window && keys[p] == target) hit = p;
          }
          hidx[row * kTaps + j] = hit;
        }
      }
      __syncthreads();   // the hit table is complete

      // products: warp w's 16 rows, a live tap at a time
      const int* hrow = hidx + (16 * warp) * kTaps;
      for (int j = 0, k = 0; j < kTaps; ++j) {
        if (!((j_mask >> j) & 1)) continue;
        uint32_t wj;
        if constexpr (STREAM) {
          const uint32_t t = taps + k;
          mbar_wait(ring0 + 8 * (t % kRing), (t / kRing) & 1);
          wj = smem_addr(wsm + (t % kRing) * S::kTapBytes);
        } else {
          wj = smem_addr(wsm + static_cast<size_t>(g * kTaps + j) * S::kTapBytes);
        }
        const int idx = hrow[(lane % 16) * kTaps + j];
        if (__any_sync(0xffffffffu, idx >= 0)) {
#pragma unroll
          for (int ks = 0; ks < CINP / 16; ++ks) {
            uint32_t a[4];
            if constexpr (SMALL) {
              const unsigned short* f = reinterpret_cast<const unsigned short*>(fw);
              const int i0 = __shfl_sync(0xffffffffu, idx, gq);
              const int i1 = __shfl_sync(0xffffffffu, idx, gq + 8);
              a[0] = feat_pair(f, i0, 2 * tig, cin);
              a[1] = feat_pair(f, i1, 2 * tig, cin);
              a[2] = feat_pair(f, i0, 2 * tig + 8, cin);
              a[3] = feat_pair(f, i1, 2 * tig + 8, cin);
            } else {
              const uint32_t koff = 32 * ks + 16 * (lane / 16);
              ldmatrix_x4(a, (idx >= 0 ? smem_addr(fw + idx * row_bytes) : zero_row) + koff);
            }
#pragma unroll
            for (int np = 0; np < COUT / 16; ++np) {
              // b[0], b[1]: n-tile 2 np; b[2], b[3]: n-tile 2 np + 1
              const int mi = lane / 8;
              const int n = np * 16 + (mi / 2) * 8 + lane % 8;
              uint32_t b[4];
              ldmatrix_x4(b, wj + n * S::kWRow * 2 + 32 * ks + 16 * (mi % 2));
              mma_bf16(acc[2 * np], a, b[0], b[1]);
              mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
            }
          }
        }
        if constexpr (STREAM) {
          __syncthreads();   // the tap's slot is free: its next tap comes into it
          if (tid == 0 && k + kRing < nl) issue_tap(g, k + kRing, taps + k + kRing);
        }
        ++k;
      }
      if constexpr (STREAM) taps += nl;
      __syncthreads();   // the buffer and the hit table are free
      ++u;
    }
    // rows gq and gq + 8 of the warp, columns 8 n + 2 tig
    float* o = out + (static_cast<size_t>(blockIdx.x + i * gridDim.x) * kBlock + 16 * warp + gq) *
                         COUT + 2 * tig;
#pragma unroll
    for (int n = 0; n < COUT / 8; ++n) {
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(o + 8 * COUT + 8 * n) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

template <int CINP, int COUT, bool SMALL, bool STREAM, int NBUF>
int launch(const void* feat, const void* lin, const void* kbase, const void* ws,
           const void* offsets, const void* w, void* out, int v_in, int nb, int cin,
           int window, int dy_mask, int j_mask, cudaStream_t stream) {
  using S = Shape<CINP, COUT, SMALL, STREAM>;
  auto kernel = window_pass_kernel<CINP, COUT, SMALL, STREAM, NBUF>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent blocks: as many as fit the SMs at once, at most one a plan
  // block; the live-group table holds a byte a plan block the CTA takes
  // (sized for the fewest CTAs the grid can have)
  const int least = nb < sms ? nb : sms;
  const size_t smem = kHead + S::kWBytes +
                      NBUF * (static_cast<size_t>(window) * (4 + 2 * cin) + kKbBytes) +
                      (nb + least - 1) / least;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = nb < sms * per_sm ? nb : sms * per_sm;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const int*>(lin),
      static_cast<const int*>(kbase), static_cast<const int*>(ws),
      static_cast<const int*>(offsets), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), v_in, nb, cin, window, dy_mask, j_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaGetLastError() code (0 = launched).
// Returns -1 for widths the kernel is not built for (resident: Cin <= 16 or
// 32 to Cout 16 or 32, Cin 32 to Cout 64, with 2 window buffers; streamed:
// Cin 64 to Cout 64 or 128, Cin 128 to Cout 128, with `nbuf` 1 or 2
// (window_kernel.window_buffers)). w: (27, cout, cin_pad + 8) bf16,
// window_kernel.window_weights.
extern "C" int s2d_window_pass(const void* feat, const void* lin,
                               const void* kbase, const void* ws,
                               const void* offsets, const void* w, void* out,
                               int v_in, int nb, int cin, int cout, int window,
                               int dy_mask, int j_mask, int nbuf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S2D_WINDOW_CASE(CINP, COUT, SMALL, STREAM, NBUF)                                  \
  return launch<CINP, COUT, SMALL, STREAM, NBUF>(feat, lin, kbase, ws, offsets, w, out,   \
                                                 v_in, nb, cin, window, dy_mask, j_mask, s)
#define S2D_STREAMED_CASE(CINP, COUT)             \
  do {                                            \
    if (nbuf == 2) S2D_WINDOW_CASE(CINP, COUT, false, true, 2); \
    if (nbuf == 1) S2D_WINDOW_CASE(CINP, COUT, false, true, 1); \
  } while (0)
  if (nbuf == 2 && cin < 16 && cin > 0) {
    if (cout == 16) S2D_WINDOW_CASE(16, 16, true, false, 2);
    if (cout == 32) S2D_WINDOW_CASE(16, 32, true, false, 2);
  } else if (nbuf == 2 && cin == 16) {
    if (cout == 16) S2D_WINDOW_CASE(16, 16, false, false, 2);
    if (cout == 32) S2D_WINDOW_CASE(16, 32, false, false, 2);
  } else if (nbuf == 2 && cin == 32) {
    if (cout == 16) S2D_WINDOW_CASE(32, 16, false, false, 2);
    if (cout == 32) S2D_WINDOW_CASE(32, 32, false, false, 2);
    if (cout == 64) S2D_WINDOW_CASE(32, 64, false, false, 2);
  } else if (cin == 64) {
    if (cout == 64) S2D_STREAMED_CASE(64, 64);
    if (cout == 128) S2D_STREAMED_CASE(64, 128);
  } else if (cin == 128) {
    if (cout == 128) S2D_STREAMED_CASE(128, 128);
  }
#undef S2D_STREAMED_CASE
#undef S2D_WINDOW_CASE
  return -1;
}
