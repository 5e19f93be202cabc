// Hopper (sm_90a) warpgroup matrix multiply (wgmma) and the helpers around
// it, shared by the port's tensor-core convs (plane_subm.cu, tile_subm.cu):
// 16-byte asynchronous copies, named barriers, ldmatrix, wgmma descriptors
// and instructions, one tap's issue, and the fused epilogue of a warp's 16
// rows. Bulk copies and mbarriers: async_copy.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// 16 bytes global -> shared; src_bytes 0 writes zeros (an absent source).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// barrier of the 128 threads of warpgroup `wg` < 4 (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  switch (wg) {
    case 0: asm volatile("bar.sync 1, 128;\n" ::: "memory"); break;
    case 1: asm volatile("bar.sync 2, 128;\n" ::: "memory"); break;
    case 2: asm volatile("bar.sync 3, 128;\n" ::: "memory"); break;
    default: asm volatile("bar.sync 4, 128;\n" ::: "memory"); break;
  }
}

// barrier of a team: one warpgroup, or the block's two (barrier 5)
template <int kSplit>
__device__ __forceinline__ void team_sync(int wg) {
  if (kSplit == 2)
    asm volatile("bar.sync 5, 256;\n" ::: "memory");
  else
    wg_sync(wg);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N of this warpgroup's wgmma groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching an accumulator while a wgmma owns it
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// Shared-memory matrix descriptor of a B operand in the no-swizzle K-major
// layout: 8 x 8 core matrices of 128 contiguous bytes, `lbo` bytes apart
// along K and `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x N, f32, registers) += A (64 x 16 bf16, registers: the mma.sync A
// fragment of each warp's 16 rows) * B (16 x N bf16, shared memory)
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0,%1,%2,%3,%4,%5,%6,%7"
        "}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
        "}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// acc += A * B over one tap, issued and committed, not waited for: A is
// the 16 halo rows of this warp's plane, loaded into a by ldmatrix (arow:
// this lane's row), B the tap's (C, N) slice of weights at w0 in the
// layout of plane_kernel.wgmma_weights (CO / 8 core matrices along N for
// each 8 input channels). The registers of a stay the wgmma's until it has
// completed.
template <int C, int CO, int N>
__device__ __forceinline__ void tap_issue(float (&acc)[N / 2], uint32_t (&a)[C / 16][4],
                                          uint32_t arow, uint32_t w0) {
#pragma unroll
  for (int s = 0; s < C / 16; ++s) ldmatrix_x4(a[s], arow + 32 * s);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < C / 16; ++s)
    Wgmma<N>::run(acc, a[s], b_desc(w0 + s * 2 * (CO / 8) * 128, (CO / 8) * 128, 128));
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void acc_done(float (&acc)[N / 2]) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
}

// The fused epilogue of plane p (a warp's 16 rows) over columns n0 .. n0 + N,
// in two steps so that its loads can be issued early: a thread owns rows
// lane / 4 and lane / 4 + 8 (cells) and columns n0 + 8j + 2 (lane % 4) +
// {0, 1}; m and r hold their mask and residual pairs.
template <int CO, int N>
__device__ __forceinline__ void epi_load(int p, int n0, int lane,
                                         const __nv_bfloat16* __restrict__ mask,
                                         const __nv_bfloat16* __restrict__ resid,
                                         uint32_t (&m)[2][N / 8], uint32_t (&r)[2][N / 8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const size_t at = (static_cast<size_t>(p) * 16 + lane / 4 + 8 * half) * CO + n0 + j * 8 +
                        (lane % 4) * 2;
      m[half][j] = *reinterpret_cast<const uint32_t*>(mask + at);
      r[half][j] = resid != nullptr ? *reinterpret_cast<const uint32_t*>(resid + at) : 0u;
    }
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <int CO, int N>
__device__ __forceinline__ void epi_store(const float (&acc)[N / 2], int p, int n0, int lane,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          const uint32_t (&m)[2][N / 8],
                                          const uint32_t (&r)[2][N / 8],
                                          __nv_bfloat16* __restrict__ out, int relu) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int cell = lane / 4 + 8 * half;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = cell * CO + n0 + j * 8 + (lane % 4) * 2;
      const float2 mm = bf2(m[half][j]), rr = bf2(r[half][j]);
      float v0 = acc[4 * j + 2 * half] * scale[col] + shift[col] + rr.x;
      float v1 = acc[4 * j + 2 * half + 1] * scale[col + 1] + shift[col + 1] + rr.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(p) * 16 * CO + col) =
          __floats2bfloat162_rn(v0 * mm.x, v1 * mm.y);
    }
  }
}
