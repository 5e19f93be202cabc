// Fused tile submanifold 3x3x3 conv over z-chunked 4x4 BEV tiles, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sparse2dense_tpu/ops/pallas/tile_block_kernel.py
// _tile_kernel (:156), called by tile_subm_pallas (:343), without its nine
// export arrays.
//
// Contract (ops/tile_kernel.py tile_subm_plain). State is z-major, (tz, T1p,
// 16 C): one row per (z, tile) plane of a (tz, 4, 4) chunk tile, cell =
// y4 * 4 + x4. For tile t, plane z and cell (y4, x4):
//     acc[co] = sum over taps k = (kz, ky, kx) and ci of
//               src(t; z + kz - 1, y4 + ky - 1, x4 + kx - 1)[ci] * w[k][ci][co]
//     y = acc * scale16 + shift16 (+ residual); ReLU if relu; * mask16
// stored in the state's type. A halo cell (z', y', x') with z' in -1..tz and
// y', x' in -1..4 lies in tile offset (dz, dy, dx) (-1 below the chunk or
// tile, +1 above it, else 0); at (0, 0, 0) it is tile t's own cell, else cell
// (z' mod tz, y' mod 4, x' mod 4) of tile tgt[t / 128][dir_row(dz, dy, dx)]
// [t % 128]. A target outside [0, T1p) (SENTINEL: absent, or dropped by the
// plan's windows) reads zero, so every tap the plan dropped stays dropped, as
// in the TPU kernel. Weights come in the state's type (the TPU kernel rounds
// them to it); products and sums are float32. mask16 is a cell mask repeated
// over the output channels (tile_kernel.expand_mask).
//
// Design. The TPU kernel fetches nine rank windows by DMA, selects neighbour
// cells with one-hot MXU matmuls, convolves a 36-cell halo plane with a
// (36 C, 48 Co) matrix and emits export arrays for the next conv: layout
// workarounds for a chip without a fast gather. Here the unit of work is one
// live (z, tile) plane, one with an unmasked cell: at conv1 of the flagship
// frame ~1 (z, tile) row in 5 is live, at conv2 ~1 in 4. Two kernels, one
// launch of the wrapper:
// - tile_live compacts: each block reads the mask of 256 planes, reserves
//   room for its live ones in a list with one atomicAdd (the list's block
//   order varies from run to run, a block's planes stay in order; no
//   result depends on it) and writes zeros to the output rows of the others
//   (their every cell is masked out);
// - the conv: a block owns P consecutive entries of the list, gathers the
//   3x6x6 halo of each plane (108 cells) straight from the state by tgt into
//   shared memory, runs the 27 taps over it and fuses the epilogue, as
//   csrc/plane_subm.cu does for its planes. It is launched for every plane
//   and its blocks past the list's end return at once.
// No result depends on the order of blocks; no atomics touch the output.
// - bfloat16 state (the flagship): tensor cores. A warp owns one plane (its
//   16 cells are the 16 rows of an mma.sync m16n8k16 tile) and 64 output
//   channels at most; per tap it multiplies the 16 gathered halo rows by the
//   tap's (C, Co) weight slice, staged in shared memory as (Co, C) for the
//   B fragments, 27, 9 or 3 taps at a time as room allows. A warp skips a
//   tap whose 16 source cells all lie in absent tiles.
// - float32 state (the agreement runs): CUDA-core FMAs, a thread per
//   (plane, cell) row and 16 output channels.
// Halo rows are padded so a warp's reads spread over the banks.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes. The contract
// writes every (z, tile) row of the output, 0.30 GB at conv1 and 0.37 GB at
// conv2 of the flagship frame (~0.1 ms), while the live planes' active
// (cell, tap) pairs need a few GFLOP (a few us). This design reads the mask
// a second time, re-reads a plane's halo from L2 for each of its
// neighbours, computes the mma tiles of every live plane in full, and does
// not overlap the gather with the mmas; reaching the bound means one halo
// per tile shared by its tz planes and a pipelined gather (cp.async / TMA)
// feeding wgmma: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 128;       // tiles per plan block
constexpr int kHalo = 108;      // 3 z planes x 6 x 6 halo cells
constexpr int kSmemMax = 232448;

// halo cell h of plane q = z * t1p + t -> source (plane row * 16 + cell) in
// the state, -1 = zero
__device__ __forceinline__ int halo_source(const int* __restrict__ tgt, int q, int h,
                                           int t1p, int tz) {
  const int z = q / t1p, t = q % t1p;
  const int zz = z + h / 36 - 1, yy = (h / 6) % 6 - 1, xx = h % 6 - 1;
  const int dzb = zz < 0 ? -1 : (zz >= tz ? 1 : 0);
  const int dyb = yy < 0 ? -1 : (yy > 3 ? 1 : 0);
  const int dxb = xx < 0 ? -1 : (xx > 3 ? 1 : 0);
  const int cell = ((yy + 4) & 3) * 4 + ((xx + 4) & 3);
  int r = t;
  if (dzb != 0 || dyb != 0 || dxb != 0) {
    const int dir = ((dzb + 1) * 3 + dyb + 1) * 3 + dxb + 1;
    r = tgt[((t / kBlk) * 32 + dir) * kBlk + t % kBlk];
  }
  return (r >= 0 && r < t1p) ? ((zz - dzb * tz) * t1p + r) * 16 + cell : -1;
}

// halo index of output cell `cell` under tap (kz, ky, kx)
__device__ __forceinline__ int halo_of(int cell, int kz, int ky, int kx) {
  return kz * 36 + (cell / 4 + ky) * 6 + cell % 4 + kx;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Compaction: list[count++] = q for every live plane q of the n = tz * T1p
// planes (one thread a plane); the output rows of the other planes are set to
// zero here.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
tile_live(const T* __restrict__ mask, T* __restrict__ out, int n, int* __restrict__ count,
          int* __restrict__ list) {
  __shared__ int warp_base[kWarps];
  __shared__ int block_base;
  __shared__ bool dead[kThreads];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = blockIdx.x * kThreads + tid;
  bool on = false;
  if (q < n) {
    const T* m = mask + static_cast<size_t>(q) * 16 * CO;
#pragma unroll
    for (int c = 0; c < 16; ++c) on |= to_float(m[c * CO]) != 0.f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, on);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  dead[tid] = q < n && !on;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (on) list[block_base + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = q;
  constexpr int kVec = 16 * CO * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a row
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(blockIdx.x) * kThreads * 16 * CO);
  for (int i = tid; i < kThreads * kVec; i += kThreads)
    if (dead[i / kVec]) o[i] = make_uint4(0, 0, 0, 0);
}

// qs[i] = list[i0 + i] for the P planes of the block's next turn, or -1 past
// the list's end (a block-wide barrier before and after)
template <int P>
__device__ __forceinline__ void next_planes(const int* __restrict__ list, int i0, int n,
                                            int* qs) {
  __syncthreads();  // the previous turn's readers are done
  if (threadIdx.x < P) qs[threadIdx.x] = i0 + threadIdx.x < n ? list[i0 + threadIdx.x] : -1;
  __syncthreads();
}

// src[i] for the P planes of the block: halo sources, -1 past the list's end
template <int P>
__device__ __forceinline__ void halo_sources(const int* __restrict__ tgt, int t1p, int tz,
                                             const int* qs, int* src) {
  for (int i = threadIdx.x; i < P * kHalo; i += kThreads) {
    const int q = qs[i / kHalo];
    src[i] = q >= 0 ? halo_source(tgt, q, i % kHalo, t1p, tz) : -1;
  }
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
  static constexpr size_t kSmem = sizeof(int) * kPlanes * (kHalo + 1) +
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
tile_subm_mma(const __nv_bfloat16* __restrict__ state, const int* __restrict__ tgt,
              const __nv_bfloat16* __restrict__ wt, const float* __restrict__ scale,
              const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
              const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
              const int* __restrict__ list, const int* __restrict__ count, int t1p, int tz,
              int relu) {
  using S = MmaShape<C, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = halo + S::kPlanes * kHalo * S::kStride;
  int* src = reinterpret_cast<int*>(wsm + S::kTaps * CO * S::kStride);
  int* qs = src + S::kPlanes * kHalo;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;       // mma row group, thread in group
  const int pl = warp / S::kWpp, co0 = (warp % S::kWpp) * S::kCoW;
  const int* psrc = src + pl * kHalo;
  const __nv_bfloat16* ph = halo + pl * kHalo * S::kStride;
  constexpr int kVec = C / 8;                   // 16-byte pieces of a halo or weight row
  auto stage_taps = [&](int k0) {               // taps k0 .. k0 + kTaps - 1 as (Co, C)
    const __nv_bfloat16* wk = wt + static_cast<size_t>(k0) * CO * C;
    for (int i = tid; i < S::kTaps * CO * kVec; i += kThreads) {
      const int row = i / kVec, v = i % kVec;
      reinterpret_cast<uint4*>(wsm + row * S::kStride)[v] =
          reinterpret_cast<const uint4*>(wk + static_cast<size_t>(row) * C)[v];
    }
  };
  if (S::kTaps == 27) stage_taps(0);            // all taps fit: staged once per block

  // persistent blocks: turn i0 takes list entries i0 .. i0 + P - 1
  const int n = *count;
  for (int i0 = blockIdx.x * S::kPlanes; i0 < n; i0 += gridDim.x * S::kPlanes) {
    next_planes<S::kPlanes>(list, i0, n, qs);
    const int q = qs[pl];
    halo_sources<S::kPlanes>(tgt, t1p, tz, qs, src);
    __syncthreads();
    for (int i = tid; i < S::kPlanes * kHalo * kVec; i += kThreads) {
      const int row = i / kVec, v = i % kVec, s = src[row];
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s >= 0) val = reinterpret_cast<const uint4*>(state + static_cast<size_t>(s) * C)[v];
      reinterpret_cast<uint4*>(halo + row * S::kStride)[v] = val;
    }

    float acc[S::kCoW / 8][4];
#pragma unroll
    for (int j = 0; j < S::kCoW / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    for (int k0 = 0; k0 < 27; k0 += S::kTaps) {
      if (S::kTaps < 27) {
        __syncthreads();  // the previous taps' readers are done
        stage_taps(k0);
      }
      __syncthreads();    // halo and taps staged
      if (q < 0) continue;
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
    if (q < 0) continue;

    // ---- fused epilogue: rows g and g + 8 (cells), columns co0 + 8j + 2tig -
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cell = g + 8 * half;
#pragma unroll
      for (int j = 0; j < S::kCoW / 8; ++j) {
        const int col = cell * CO + co0 + j * 8 + tig * 2;
        const size_t at = static_cast<size_t>(q) * 16 * CO + col;
        const float2 m =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mask + at));
        float v0 = acc[j][2 * half] * scale[col] + shift[col];
        float v1 = acc[j][2 * half + 1] * scale[col + 1] + shift[col + 1];
        if (resid != nullptr) {
          const float2 r =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + at));
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
      sizeof(int) * kPlanes * (kHalo + 1);
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kBlk % kPlanes == 0 && C % 16 == 0 && CO % 16 == 0, "shape");
};

__device__ __forceinline__ void fma16(float x, const float* w, float* acc) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 v = w4[r];
    acc[4 * r + 0] = fmaf(x, v.x, acc[4 * r + 0]);
    acc[4 * r + 1] = fmaf(x, v.y, acc[4 * r + 1]);
    acc[4 * r + 2] = fmaf(x, v.z, acc[4 * r + 2]);
    acc[4 * r + 3] = fmaf(x, v.w, acc[4 * r + 3]);
  }
}

// w: weights (27, C, CO) float
template <int C, int CO>
__global__ void __launch_bounds__(kThreads)
tile_subm_fma(const float* __restrict__ state, const int* __restrict__ tgt,
              const float* __restrict__ w, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ mask,
              const float* __restrict__ resid, float* __restrict__ out,
              const int* __restrict__ list, const int* __restrict__ count, int t1p, int tz,
              int relu) {
  using S = FmaShape<C, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  float* halo = wsm + C * CO;
  int* src = reinterpret_cast<int*>(halo + S::kPlanes * kHalo * S::kStride);
  int* qs = src + S::kPlanes * kHalo;

  const int tid = threadIdx.x;
  const int g = tid / S::kTpg, row = tid % S::kTpg;   // channel group, (plane, cell)
  const int cell = row % 16, col = cell * CO + g * 16;
  const int n = *count;
  for (int i0 = blockIdx.x * S::kPlanes; i0 < n; i0 += gridDim.x * S::kPlanes) {
    next_planes<S::kPlanes>(list, i0, n, qs);
    halo_sources<S::kPlanes>(tgt, t1p, tz, qs, src);
    __syncthreads();
    for (int i = tid; i < S::kPlanes * kHalo * C; i += kThreads) {
      const int r = i / C, ci = i % C, s = src[r];
      halo[r * S::kStride + ci] = s >= 0 ? state[static_cast<size_t>(s) * C + ci] : 0.f;
    }
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

    const int q = qs[row / 16];
    if (q < 0) continue;
    const size_t at = static_cast<size_t>(q) * 16 * CO + col;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[j] * scale[col + j] + shift[col + j];
      if (resid != nullptr) v += resid[at + j];
      if (relu) v = fmaxf(v, 0.f);
      out[at + j] = v * mask[at + j];
    }
  }
}

template <typename T, int CO, typename S, typename K>
int launch(K kernel, const void* state, const void* tgt, const void* w, const void* scale,
           const void* shift, const void* mask, const void* resid, void* out, int* list,
           int* count, int t1p, int tz, int relu, cudaStream_t stream) {
  if (t1p % kBlk != 0 || tz < 1) return -2;
  const int n = tz * t1p;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(S::kSmem));
  if (e == cudaSuccess) e = cudaMemsetAsync(count, 0, sizeof(int), stream);
  // persistent conv blocks: as many as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, S::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = n / S::kPlanes < sms * per_sm ? n / S::kPlanes : sms * per_sm;
  tile_live<T, CO><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const T*>(mask), static_cast<T*>(out), n, count, list);
  kernel<<<blocks, kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(state), static_cast<const int*>(tgt), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const T*>(mask), static_cast<const T*>(resid), static_cast<T*>(out), list,
      count, t1p, tz, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the compaction and the conv on `stream`; returns the
// cudaGetLastError() code (0 = launched), -1 for a (C, Co) pair the kernel is
// not built for, -2 for a T1p that is not a whole number of plan blocks.
// dtype 0 = float32 state with w (27, C, Co); dtype 1 = bfloat16 state with w
// transposed, (27, Co, C). resid may be null. list (tz * T1p int32) and count
// (one int32) are scratch.
extern "C" int s2d_tile_subm(const void* state, const void* tgt, const void* w,
                             const void* scale, const void* shift, const void* mask,
                             const void* resid, void* out, void* list, void* count, int tz,
                             int t1p, int c, int co, int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* l = static_cast<int*>(list);
  int* n = static_cast<int*>(count);
#define S2D_TILE_CASE(CI, CO_)                                                           \
  if (c == CI && co == CO_) {                                                            \
    if (dtype == 1)                                                                      \
      return launch<__nv_bfloat16, CO_, MmaShape<CI, CO_>>(                              \
          tile_subm_mma<CI, CO_>, state, tgt, w, scale, shift, mask, resid, out, l, n,   \
          t1p, tz, relu, s);                                                             \
    return launch<float, CO_, FmaShape<CI, CO_>>(tile_subm_fma<CI, CO_>, state, tgt, w,  \
                                                 scale, shift, mask, resid, out, l, n,  \
                                                 t1p, tz, relu, s);                      \
  }
  S2D_TILE_CASE(16, 16)
  S2D_TILE_CASE(32, 32)
  S2D_TILE_CASE(64, 64)
  S2D_TILE_CASE(128, 128)
#undef S2D_TILE_CASE
  return -1;
}
