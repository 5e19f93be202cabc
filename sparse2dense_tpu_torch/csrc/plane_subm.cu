// Fused active-plane submanifold 3x3x3 conv, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse2dense_tpu/ops/pallas/plane_block_kernel.py
// _plane_kernel (:131), called by plane_subm_pallas (:306).
//
// Contract (ops/plane_conv.py plane_subm_plain). State rows are occupied
// z-planes of 4x4 BEV tiles, (16 cells x C) each, cell = y4 * 4 + x4. For
// plane row p and cell (y4, x4):
//     acc[co] = sum over taps k = (kz, ky, kx) and ci of
//               src(p, kz, y4 + ky - 1, x4 + kx - 1)[ci] * w[k][ci][co]
//     y = acc * scale16 + shift16 (+ residual); ReLU if relu; * mask16
// stored in the state's type. src of a halo cell (yy, xx) in -1..4 is the
// plane's own cell when kz = 1 and the cell lies inside the tile; otherwise
// it is cell ((yy + 4) % 4, (xx + 4) % 4) of the neighbour plane
//     tgt[p / 128][dir_row(kz - 1, dyb, dxb)][p % 128]
// with (dyb, dxb) the tile offset the cell falls in. A target outside
// [0, T1p) (SENTINEL: absent, or dropped by the plan's windows) reads zero,
// so every tap the plan dropped stays dropped, as in the TPU kernel. Weights
// come in the state's type (the TPU kernel rounds them to it); products and
// sums are float32.
//
// Design. The TPU kernel fetches two rank windows per dy cluster by DMA,
// selects neighbour cells with one-hot MXU matmuls and emits export arrays
// for the next conv: layout workarounds for a chip without a fast gather.
// Here a thread block owns P consecutive planes: it gathers the 6x6x3 halo
// of each plane (108 cells) straight from the state rows by tgt into shared
// memory, then runs the 27 taps over it, and fuses the epilogue. No atomics;
// blocks are independent. Two kernels share that frame:
// - bfloat16 state (the flagship): tensor cores. A warp owns one plane (its
//   16 cells are the 16 rows of an mma.sync m16n8k16 tile) and 64 output
//   channels at most; per tap it multiplies the 16 gathered halo rows by the
//   tap's (C, Co) weight slice, staged in shared memory as (Co, C) for the
//   B fragments, 27, 9 or 3 taps at a time as room allows. A warp skips a
//   tap whose 16 source cells all lie in absent planes, and a plane whose 16
//   cells are all masked out (its output is zero).
// - float32 state (the tiny agreement runs): CUDA-core FMAs, a thread per
//   (plane, cell) row and 16 output channels.
// Halo rows are padded so a warp's reads spread over the banks.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes. At conv2 of the
// flagship frame (90,112 plane rows, C = Co = 32) a conv reads and writes
// ~0.38 GB (state, mask, residual, output) in ~0.11 ms, and its active
// (cell, tap) pairs need ~6 GFLOP, ~6 us. This design re-reads each plane's
// halo from L2 for its neighbours, computes the mma tiles of every present
// plane in full (absent cells of a present plane are zeros), and gives each
// block one warp per plane with no overlap of the gather and the mmas;
// reaching the bound means a pipelined gather (cp.async / TMA) feeding
// wgmma: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 128;       // plane rows per plan block
constexpr int kHalo = 108;      // 3 z sources x 6 x 6 halo cells
constexpr int kSmemMax = 232448;

// halo cell h of plane p -> source (row * 16 + cell) in the state, -1 = zero
__device__ __forceinline__ int halo_source(const int* __restrict__ tgt, int p, int h,
                                           int t1p) {
  const int kz = h / 36, yy = (h / 6) % 6 - 1, xx = h % 6 - 1;
  const int dyb = yy < 0 ? -1 : (yy > 3 ? 1 : 0);
  const int dxb = xx < 0 ? -1 : (xx > 3 ? 1 : 0);
  const int cell = ((yy + 4) & 3) * 4 + ((xx + 4) & 3);
  int r = p;
  if (kz != 1 || dyb != 0 || dxb != 0) {
    const int dir = (kz * 3 + dyb + 1) * 3 + dxb + 1;
    r = tgt[((p / kBlk) * 32 + dir) * kBlk + p % kBlk];
  }
  return (r >= 0 && r < t1p) ? r * 16 + cell : -1;
}

// halo index of output cell `cell` under tap (kz, ky, kx)
__device__ __forceinline__ int halo_of(int cell, int kz, int ky, int kx) {
  return kz * 36 + (cell / 4 + ky) * 6 + cell % 4 + kx;
}

// ---------------------------------------------------------------------------
// bfloat16 state: mma.sync m16n8k16, one plane per warp
// ---------------------------------------------------------------------------

template <int C, int CO>
struct MmaShape {
  static constexpr int kCoW = CO < 64 ? CO : 64;         // output channels a warp
  static constexpr int kWpp = CO / kCoW;                 // warps per plane
  static constexpr int kPlanes = kWarps / kWpp;          // planes per block
  static constexpr int kStride = C + 8;                  // halo / weight row, bf16
  static constexpr int kTaps = C <= 32 ? 27 : (C == 64 ? 9 : 3);  // staged at a time
  static constexpr size_t kSmem = sizeof(int) * kPlanes * kHalo +
                                  2 * (size_t(kPlanes) * kHalo + kTaps * CO) * kStride;
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kBlk % kPlanes == 0 && C % 16 == 0 && kCoW % 8 == 0, "shape");
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// wt: weights (27, CO, C) bf16, transposed by the wrapper for the B fragments
template <int C, int CO>
__global__ void __launch_bounds__(kThreads)
plane_subm_mma(const __nv_bfloat16* __restrict__ state, const int* __restrict__ tgt,
               const __nv_bfloat16* __restrict__ wt, const float* __restrict__ scale,
               const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
               const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
               int t1p, int relu) {
  using S = MmaShape<C, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = halo + S::kPlanes * kHalo * S::kStride;
  int* src = reinterpret_cast<int*>(wsm + S::kTaps * CO * S::kStride);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;       // mma row group, thread in group
  const int p0 = blockIdx.x * S::kPlanes;
  const int pl = warp / S::kWpp, co0 = (warp % S::kWpp) * S::kCoW;
  const int p = p0 + pl;

  for (int i = tid; i < S::kPlanes * kHalo; i += kThreads)
    src[i] = halo_source(tgt, p0 + i / kHalo, i % kHalo, t1p);
  __syncthreads();
  constexpr int kVec = C / 8;                   // 16-byte pieces of a halo row
  for (int i = tid; i < S::kPlanes * kHalo * kVec; i += kThreads) {
    const int row = i / kVec, v = i % kVec, s = src[row];
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s >= 0) val = reinterpret_cast<const uint4*>(state + static_cast<size_t>(s) * C)[v];
    reinterpret_cast<uint4*>(halo + row * S::kStride)[v] = val;
  }

  // a plane whose 16 cells are all masked out has a zero output
  const bool live = __any_sync(0xffffffffu,
                               __bfloat162float(mask[(static_cast<size_t>(p) * 16 + lane % 16) * CO]) != 0.f);
  const int* psrc = src + pl * kHalo;
  const __nv_bfloat16* ph = halo + pl * kHalo * S::kStride;

  float acc[S::kCoW / 8][4];
#pragma unroll
  for (int j = 0; j < S::kCoW / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int k0 = 0; k0 < 27; k0 += S::kTaps) {
    __syncthreads();  // halo staged / the previous taps' readers are done
    const __nv_bfloat16* wk = wt + static_cast<size_t>(k0) * CO * C;
    for (int i = tid; i < S::kTaps * CO * kVec; i += kThreads) {
      const int row = i / kVec, v = i % kVec;
      reinterpret_cast<uint4*>(wsm + row * S::kStride)[v] =
          reinterpret_cast<const uint4*>(wk + static_cast<size_t>(row) * C)[v];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < S::kTaps; ++t) {
      const int k = k0 + t, kz = k / 9, ky = (k / 3) % 3, kx = k % 3;
      const int h0 = halo_of(g, kz, ky, kx), h1 = halo_of(g + 8, kz, ky, kx);
      if (!__any_sync(0xffffffffu, psrc[h0] >= 0 || psrc[h1] >= 0)) continue;
      const __nv_bfloat16* r0 = ph + h0 * S::kStride + tig * 2;
      const __nv_bfloat16* r1 = ph + h1 * S::kStride + tig * 2;
      const __nv_bfloat16* wb = wsm + (t * CO + co0 + g) * S::kStride + tig * 2;
#pragma unroll
      for (int kk = 0; kk < C; kk += 16) {
        const uint32_t a0 = ld32(r0 + kk), a1 = ld32(r1 + kk);
        const uint32_t a2 = ld32(r0 + kk + 8), a3 = ld32(r1 + kk + 8);
#pragma unroll
        for (int j = 0; j < S::kCoW / 8; ++j) {
          const __nv_bfloat16* b = wb + j * 8 * S::kStride + kk;
          mma_bf16(acc[j], a0, a1, a2, a3, ld32(b), ld32(b + 8));
        }
      }
    }
  }

  // ---- fused epilogue: rows g and g + 8 (cells), columns co0 + 8j + 2tig ---
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int cell = g + 8 * half;
#pragma unroll
    for (int j = 0; j < S::kCoW / 8; ++j) {
      const int col = cell * CO + co0 + j * 8 + tig * 2;
      const size_t at = static_cast<size_t>(p) * 16 * CO + col;
      const float2 m = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mask + at));
      float v0 = acc[j][2 * half] * scale[col] + shift[col];
      float v1 = acc[j][2 * half + 1] * scale[col + 1] + shift[col + 1];
      if (resid != nullptr) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + at));
        v0 += r.x;
        v1 += r.y;
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0 * m.x, v1 * m.y);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 state: CUDA-core FMAs, a thread per (plane, cell) and 16 channels
// ---------------------------------------------------------------------------

template <int C, int CO>
struct FmaShape {
  static constexpr int kTpg = kThreads / (CO / 16);      // threads per channel group
  static constexpr int kPlanes = kTpg / 16;              // planes per block
  static constexpr int kStride = C + 1;                  // odd word stride
  static constexpr size_t kSmem =
      sizeof(float) * (C * CO + size_t(kPlanes) * kHalo * kStride) +
      sizeof(int) * kPlanes * kHalo;
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kBlk % kPlanes == 0 && C % 16 == 0 && CO % 16 == 0, "shape");
};

__device__ __forceinline__ void fma16(float x, const float* w, float* acc) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = w4[q];
    acc[4 * q + 0] = fmaf(x, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
  }
}

// w: weights (27, C, CO) float
template <int C, int CO>
__global__ void __launch_bounds__(kThreads)
plane_subm_fma(const float* __restrict__ state, const int* __restrict__ tgt,
               const float* __restrict__ w, const float* __restrict__ scale,
               const float* __restrict__ shift, const float* __restrict__ mask,
               const float* __restrict__ resid, float* __restrict__ out, int t1p, int relu) {
  using S = FmaShape<C, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  float* halo = wsm + C * CO;
  int* src = reinterpret_cast<int*>(halo + S::kPlanes * kHalo * S::kStride);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * S::kPlanes;
  for (int i = tid; i < S::kPlanes * kHalo; i += kThreads)
    src[i] = halo_source(tgt, p0 + i / kHalo, i % kHalo, t1p);
  __syncthreads();
  for (int i = tid; i < S::kPlanes * kHalo * C; i += kThreads) {
    const int row = i / C, ci = i % C, s = src[row];
    halo[row * S::kStride + ci] = s >= 0 ? state[static_cast<size_t>(s) * C + ci] : 0.f;
  }

  const int g = tid / S::kTpg, row = tid % S::kTpg;   // channel group, (plane, cell)
  const int cell = row % 16;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int k = 0; k < 27; ++k) {
    __syncthreads();  // halo staged / the previous tap's readers are done
    for (int i = tid * 4; i < C * CO; i += kThreads * 4)
      *reinterpret_cast<float4*>(wsm + i) =
          *reinterpret_cast<const float4*>(w + static_cast<size_t>(k) * C * CO + i);
    __syncthreads();
    const float* hrow = halo + ((row / 16) * kHalo +
                                halo_of(cell, k / 9, (k / 3) % 3, k % 3)) * S::kStride;
    const float* wg = wsm + g * 16;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) fma16(hrow[ci], wg + ci * CO, acc);
  }

  const int p = p0 + row / 16, col = cell * CO + g * 16;
  const size_t at = static_cast<size_t>(p) * 16 * CO + col;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v = acc[j] * scale[col + j] + shift[col + j];
    if (resid != nullptr) v += resid[at + j];
    if (relu) v = fmaxf(v, 0.f);
    out[at + j] = v * mask[at + j];
  }
}

template <typename T, typename S, typename K>
int launch(K kernel, const void* state, const void* tgt, const void* w, const void* scale,
           const void* shift, const void* mask, const void* resid, void* out, int t1p,
           int relu, cudaStream_t stream) {
  if (t1p % S::kPlanes != 0) return -2;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(S::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<t1p / S::kPlanes, kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(state), static_cast<const int*>(tgt), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const T*>(mask), static_cast<const T*>(resid), static_cast<T*>(out), t1p,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaGetLastError() code (0 = launched),
// -1 for a (C, Co) pair the kernel is not built for, -2 for a T1p that is
// not a whole number of blocks. dtype 0 = float32 state with w (27, C, Co);
// dtype 1 = bfloat16 state with w transposed, (27, Co, C). resid may be null.
extern "C" int s2d_plane_subm(const void* state, const void* tgt, const void* w,
                              const void* scale, const void* shift, const void* mask,
                              const void* resid, void* out, int t1p, int c, int co,
                              int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S2D_PLANE_CASE(CI, CO_)                                                          \
  if (c == CI && co == CO_) {                                                            \
    if (dtype == 1)                                                                      \
      return launch<__nv_bfloat16, MmaShape<CI, CO_>>(plane_subm_mma<CI, CO_>, state,   \
                                                      tgt, w, scale, shift, mask, resid, \
                                                      out, t1p, relu, s);                \
    return launch<float, FmaShape<CI, CO_>>(plane_subm_fma<CI, CO_>, state, tgt, w,      \
                                            scale, shift, mask, resid, out, t1p, relu,  \
                                            s);                                          \
  }
  S2D_PLANE_CASE(16, 16)
  S2D_PLANE_CASE(32, 32)
  S2D_PLANE_CASE(64, 64)
  S2D_PLANE_CASE(128, 128)
#undef S2D_PLANE_CASE
  return -1;
}
