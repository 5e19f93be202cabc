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
// Here the halo of a plane (3 z sources x 6 x 6 cells = 108 rows) is
// gathered straight from the state rows by tgt into shared memory, the 27
// taps run over it and the epilogue is fused. No atomics. Two kernels:
// - bfloat16 state (the flagship): wgmma. The unit of work is a group of 4
//   consecutive planes, the 64 rows of a warpgroup's m64nNk16 (a warp's 16
//   rows are its plane's cells). A comes from registers: each warp loads
//   its plane's halo rows of a tap with ldmatrix, one row address a lane,
//   so scattered rows cost nothing extra; B is the tap's (C, N) weight
//   slice in shared memory, laid out on the host for wgmma (no swizzle,
//   K-major, plane_kernel.wgmma_weights). Two taps are in flight: the next
//   one's A loads while the last multiplies. Blocks are persistent, as many
//   as fit the SMs at once, and walk over the groups. A group is read by
//   its cell mask first: if all 64 cells are masked out (the padded tail of
//   T1p, or dead planes) its rows are written as zeros with no gather and
//   no weights. A tap is skipped when none of the group's 64 rows has a
//   source in a present plane (wgmma cannot skip for one warp alone;
//   PERF.md counts the tiles this costs against a skip per plane). The
//   halo's 108 rows a plane come by cp.async, 16 B a thread, zero-filled
//   where the source is absent; the tap masks come with them.
//   Weights, by width (L2 reads a conv on the flagship frame):
//   * C <= 32: all 27 taps stay in shared memory for the block's life (14 /
//     55 KB, one bulk copy): ~7 MB a conv. Four warpgroups a block each walk
//     their own groups with a halo of their own, so one gathers while the
//     others multiply; the targets and mask of a warpgroup's next group and
//     its epilogue operands load while it multiplies.
//   * C = 64 and 128 (221 / 885 KB): taps stream through a ring of shared
//     slots (8 of 8 KB, 3 of 32 KB), filled by a producer warp with bulk
//     copies on mbarriers and released by each consumer warp once its
//     wgmma is done. Two teams share each tap (two groups at C = 64; at
//     C = 128 one group, each warpgroup with half of the output channels),
//     so a conv reads 221 KB per 8 planes at C = 64 (~0.93 GB over the live
//     passes) and 885 KB per 4 planes at C = 128 (~1.74 GB). At C = 64 the
//     two teams, a halo each, drift apart by up to the ring's depth, so one
//     multiplies while the other gathers. At C = 128 the block (one a SM:
//     a 117 KB halo beside the 96 KB ring) has one team and one halo, so it
//     gathers with its tensor cores idle: a second halo does not fit.
//   Variants measured on the H100 on copies of this source
//   (tools/bench_plane_subm.py; times in PERF.md) and left out:
//   * a double-buffered halo: each team gathers the next chunk of half its
//     input channels (all 16 at C = 16) into a second buffer while it
//     multiplies the current one, the ring carrying half-tap slices. It
//     fits every width and was slower at each: every tap becomes two wgmma
//     groups and two ring steps, each waited on, and that costs more than
//     the gather it hides. Two warpgroups with two whole halos each at
//     C = 32 were slower still: independent warpgroups hide the gather
//     better than a second buffer.
//   * an mma.sync core (A and B by ldmatrix, a tap skip per plane) at
//     C <= 32: no faster; halos of 32 input channels with four teams at
//     C >= 64 (half the weight reads): slower; a deeper ring, a fifth
//     warpgroup at C = 32: no faster.
//   The B layout has no swizzle: every 8 x 8 core matrix is 128 contiguous
//   bytes, so the rows a wgmma reads at once span all banks.
// - float32 state (the tiny agreement runs): CUDA-core FMAs, a thread per
//   (plane, cell) row and 16 output channels, blocks of P planes.
// Halo rows are padded by 16 B so the lanes of an ldmatrix spread over the
// banks.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes at conv2 and conv3,
// operations at conv4 (~0.08 / 0.06 / 0.04 ms). What bounds this design: a
// copy of it with the wgmma taken out keeps most of its time (same card),
// so the traffic around the tiles comes first: each state row is gathered
// into 6.75 halos from L2 (~0.6 / 0.5 / 0.2 GB at conv2 / 3 / 4), the
// epilogue reads mask and residual, and at C >= 64 the taps stream; the
// full wgmma tiles add the rest. What is left: the halo re-read (a halo
// shared by the z-neighbours of a tile column would halve it), and the full
// tiles: every live (group, tap) multiplies 64 rows x C x Co however few of
// its cells are active, several times the active (cell, tap) pairs of the
// hits-only bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // float32 kernel
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
// bfloat16 state: wgmma over groups of 4 planes (the shared core: wgmma.cuh)
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;   // planes a group: the 64 rows of a wgmma, a warp's 16 each

template <int C, int CO>
struct WgShape {
  static constexpr bool kResident = C <= 32;       // all 27 taps stay in shared memory
  static constexpr int kWG = kResident ? 4 : 2;    // consumer warpgroups a block
  // streamed weights: one more warp, the producer, keeps the ring full
  static constexpr int kThreads = kWG * 128 + (kResident ? 0 : 32);
  static constexpr int kSplit = C == 128 ? 2 : 1;  // warpgroups sharing a group (CO split)
  static constexpr int kN = CO / kSplit;           // output channels a warpgroup
  static constexpr int kTeams = kWG / kSplit;      // groups a block works on at once
  static constexpr int kNA = 2;                    // A fragments of taps in flight
  static constexpr int kRing = C == 64 ? 8 : 3;    // streamed taps in flight
  static constexpr int kBars = kResident ? 1 : 2 * kRing;   // full, then empty
  static constexpr int kStride = C + 8;            // halo row, bf16 (16 B pad: banks)
  static constexpr int kTapElems = C * CO;
  static constexpr uint32_t kTapBytes = 2 * kTapElems;
  static constexpr int kWElems = (kResident ? 27 : kRing) * kTapElems;
  static constexpr int kHaloElems = kGroup * kHalo * kStride;   // a team's halo
  static constexpr int kTeamThreads = 128 * kSplit;
  static constexpr int kRows = (kGroup * kHalo + kTeamThreads - 1) / kTeamThreads;
  // mbarriers [0, 256), tap masks [256, 320), halo tables [512, 1376)
  static constexpr size_t kHead = 1536;
  static constexpr size_t kSmem = kHead + 2 * (size_t(kWElems) + kTeams * kHaloElems);
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(8 * kBars <= 256 && 4 * 4 * kWG <= 64, "head");
  static_assert(C % 16 == 0 && (kN == 16 || kN == 32 || kN == 64), "shape");
};

// 27-bit mask of the taps that read halo cell h for some cell of its plane
__device__ __forceinline__ int halo_taps(int h) {
  const int kz = h / 36, yy = (h / 6) % 6, xx = h % 6;
  int bits = 0;
  for (int ky = max(0, yy - 3); ky <= min(2, yy); ++ky)
    for (int kx = max(0, xx - 3); kx <= min(2, xx); ++kx) bits |= 1 << (kz * 9 + ky * 3 + kx);
  return bits;
}

// wb: weights in the B layout of wgmma (plane_kernel.wgmma_weights): per tap
// (C / 8, CO / 8, 8 co, 8 ci) bf16, core matrices 128 B apart along CO and
// CO / 8 * 128 B apart along C
template <int C, int CO>
__global__ void __launch_bounds__(WgShape<C, CO>::kThreads)
plane_subm_wgmma(const __nv_bfloat16* __restrict__ state, const int* __restrict__ tgt,
                 const __nv_bfloat16* __restrict__ wb, const float* __restrict__ scale,
                 const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
                 const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
                 int t1p, int relu) {
  using S = WgShape<C, CO>;
  constexpr int N = S::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + S::kHead);
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int team = wg / S::kSplit, n0 = (wg % S::kSplit) * N;   // group slot, columns
  const int ttid = tid % S::kTeamThreads, twarp = ttid / 32;      // in the team
  const int n_groups = t1p / kGroup;
  const uint32_t bar0 = smem_addr(smem);
  __nv_bfloat16* halo = wsm + S::kWElems + team * S::kHaloElems;
  int* tw = reinterpret_cast<int*>(smem + 256) + team * 4 * S::kSplit;  // a word a team warp
  // halo cell h: its direction row in tgt (13: the plane itself) and cell,
  // and the taps that read it
  int* hinfo = reinterpret_cast<int*>(smem + 512);
  int* htaps = hinfo + kHalo;
  for (int h = tid; h < kHalo; h += S::kThreads) {
    const int kz = h / 36, yy = (h / 6) % 6 - 1, xx = h % 6 - 1;
    const int dyb = yy < 0 ? -1 : (yy > 3 ? 1 : 0), dxb = xx < 0 ? -1 : (xx > 3 ? 1 : 0);
    hinfo[h] = ((kz * 3 + dyb + 1) * 3 + dxb + 1) | ((((yy + 4) & 3) * 4 + ((xx + 4) & 3)) << 8);
    htaps[h] = halo_taps(h);
  }

  if (tid == 0) {  // weights: all 27 taps at once, or the ring's barriers
    for (int s = 0; s < S::kBars; ++s)
      mbar_init(bar0 + 8 * s, S::kResident || s < S::kRing ? 1 : 4 * S::kWG);
    fence_barrier_init();
    if (S::kResident) {
      mbar_expect_tx(bar0, 27 * S::kTapBytes);
      bulk_load(smem_addr(wsm), wb, 27 * S::kTapBytes, bar0);
    }
  }
  __syncthreads();

  // A team thread owns halo rows ttid + kTeamThreads j of a group (4 planes
  // x 108 rows). The sources of group g's rows (state row * 16 + cell, -1
  // for none), and the mask of two of its 64 cells:
  auto sources = [&](int g, int (&src)[S::kRows], float& m) {
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      const int r = ttid + S::kTeamThreads * j;
      src[j] = -1;
      if (r < kGroup * kHalo) {
        const int p = g * kGroup + r / kHalo, info = hinfo[r % kHalo], dir = info & 255;
        const int t = dir == 13 ? p : tgt[((p / kBlk) * 32 + dir) * kBlk + p % kBlk];
        if (t >= 0 && t < t1p) src[j] = t * 16 + (info >> 8);
      }
    }
    const size_t q = static_cast<size_t>(g) * 64 + lane;
    m = fabsf(__bfloat162float(mask[q * CO])) + fabsf(__bfloat162float(mask[(q + 32) * CO]));
  };
  // issue the halo copies of a group and note its live taps
  auto gather = [&](const int (&src)[S::kRows]) {
    int bits = 0;
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      const int r = ttid + S::kTeamThreads * j;
      if (r >= kGroup * kHalo) break;
      const __nv_bfloat16* from = state + (src[j] >= 0 ? static_cast<size_t>(src[j]) * C : 0);
      const uint32_t to = smem_addr(halo + r * S::kStride);
#pragma unroll
      for (int v = 0; v < C / 8; ++v) cp_async16(to + 16 * v, from + 8 * v, src[j] >= 0 ? 16 : 0);
      if (src[j] >= 0) bits |= htaps[r % kHalo];
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) tw[twarp] = bits;
  };
  auto tap_mask = [&]() {
    int taps = 0;
#pragma unroll
    for (int i = 0; i < 4 * S::kSplit; ++i) taps |= tw[i];
    return taps;
  };
  // a dead group's output rows are zero
  auto zero_group = [&](int g) {
    uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(g) * 64 * CO);
    for (int i = ttid; i < 8 * CO; i += S::kTeamThreads) o[i] = make_uint4(0, 0, 0, 0);
  };
  const int a_cell = lane % 16, a_koff = (lane / 16) * 8;
  // shared address of this lane's A row of tap k
  auto a_row = [&](int k) {
    const int h = halo_of(a_cell, k / 9, (k / 3) % 3, k % 3);
    return smem_addr(halo + (warp * kHalo + h) * S::kStride + a_koff);
  };
  uint32_t a[S::kNA][C / 16][4];         // A of the taps in flight
  uint32_t em[2][N / 8], er[2][N / 8];   // the epilogue's mask and residual

  if constexpr (S::kResident) {
    // Each warpgroup walks its own groups g0, g0 + stride, ...: it gathers
    // a group's halo, multiplies it and stores the epilogue, while the
    // targets and mask of the next group and the epilogue operands of the
    // group after load; the block's other warpgroups fill the SM meanwhile.
    // A group whose 64 cells are all masked out is neither gathered nor
    // multiplied: its rows are written as zeros.
    const int stride = gridDim.x * S::kWG;
    const int g0 = blockIdx.x * S::kWG + wg;
    int src[S::kRows];
    float m = 0.f;
    if (g0 < n_groups) sources(g0, src, m);
    bool live = g0 < n_groups && __any_sync(0xffffffffu, m != 0.f);
    if (live) epi_load<CO, N>(g0 * kGroup + warp, 0, lane, mask, resid, em, er);
    mbar_wait(bar0, 0);  // the weights have landed
    for (int g = g0; g < n_groups; g += stride) {
      const int g1 = g + stride;
      if (live) {
        gather(src);
        cp_async_commit();
      }
      if (g1 < n_groups) sources(g1, src, m);
      if (live) {
        cp_async_wait_all();  // this thread's copies have landed
        wg_sync(wg);         // ... and everyone's, with their tap masks
        int taps = tap_mask();
        float acc[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
        // two taps in flight: A of the next loads while the last multiplies
        while (taps) {
#pragma unroll
          for (int i = 0; i < S::kNA; ++i) {
            if (taps) {
              const int k = __ffs(taps) - 1;
              taps &= taps - 1;
              tap_issue<C, CO, N>(acc, a[i], a_row(k), smem_addr(wsm + k * S::kTapElems));
              wgmma_wait<S::kNA - 1>();
            }
          }
        }
        acc_done<N>(acc);
        epi_store<CO, N>(acc, g * kGroup + warp, 0, lane, scale, shift, em, er, out, relu);
        wg_sync(wg);  // the halo is free for the next group
      } else {
        zero_group(g);
      }
      live = g1 < n_groups && __any_sync(0xffffffffu, m != 0.f);
      if (live) epi_load<CO, N>(g1 * kGroup + warp, 0, lane, mask, resid, em, er);
    }
  } else {
    // Streamed weights. The block's teams take a group each per pass (at
    // C = 128 the two warpgroups are one team, each with half of the output
    // channels); every pass runs the 27 taps in order through a ring of
    // kRing slots. The producer warp loads tap after tap into the ring
    // (full[s]: the copy has landed); each consumer warp releases a slot
    // once its wgmma on it is done (empty[s]: 4 kWG arrivals). At C = 64
    // the two teams drift apart by up to the ring's depth, so one
    // multiplies while the other gathers or waits; at C = 128 the block's
    // one team gathers with the tensor cores idle. A pass whose groups are
    // all dead is skipped by everyone alike (the same mask test), so it
    // streams no weights.
    const int n_pass = (n_groups + S::kTeams - 1) / S::kTeams;
    const uint32_t full0 = bar0, empty0 = bar0 + 8 * S::kRing;
    auto pass_live = [&](int q) {
      bool any = false;
#pragma unroll
      for (int t = 0; t < S::kTeams; ++t) {
        const int g = q * S::kTeams + t;
        if (g < n_groups) {
          const size_t c0 = static_cast<size_t>(g) * 64 + lane;
          any |= __bfloat162float(mask[c0 * CO]) != 0.f ||
                 __bfloat162float(mask[(c0 + 32) * CO]) != 0.f;
        }
      }
      return __any_sync(0xffffffffu, any);
    };
    if (wg == S::kWG) {  // the producer warp
      uint32_t seq = 0;
      for (int q = blockIdx.x; q < n_pass; q += gridDim.x) {
        if (!pass_live(q)) continue;
        for (int k = 0; k < 27; ++k, ++seq) {
          const int slot = seq % S::kRing;
          if (lane == 0) {
            mbar_wait(empty0 + 8 * slot, ((seq / S::kRing) & 1) ^ 1);
            mbar_expect_tx(full0 + 8 * slot, S::kTapBytes);
            bulk_load(smem_addr(wsm + slot * S::kTapElems), wb + k * S::kTapElems,
                      S::kTapBytes, full0 + 8 * slot);
          }
        }
      }
      return;
    }
    uint32_t seq = 0;  // taps consumed; slot seq % kRing
    for (int q = blockIdx.x; q < n_pass; q += gridDim.x) {
      const int g = q * S::kTeams + team;
      if (!pass_live(q)) {
        if (g < n_groups) zero_group(g);
        continue;
      }
      int src[S::kRows];
      float m = 0.f;
      if (g < n_groups) sources(g, src, m);
      const bool live = g < n_groups && __any_sync(0xffffffffu, m != 0.f);
      if (live) {
        gather(src);
        cp_async_commit();
        epi_load<CO, N>(g * kGroup + warp, n0, lane, mask, resid, em, er);
        cp_async_wait_all();
      } else if (g < n_groups) {
        zero_group(g);
      }
      team_sync<S::kSplit>(wg);  // the halo and the tap masks are in place
      const int taps = live ? tap_mask() : 0;
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      // a tap's wgmma runs while the next slot is awaited and its A loads;
      // the slot before is released once its wgmma is done
      auto step = [&](int k, uint32_t (&ak)[C / 16][4]) {
        const int slot = seq % S::kRing;
        mbar_wait(full0 + 8 * slot, (seq / S::kRing) & 1);
        if ((taps >> k) & 1) {
          tap_issue<C, CO, N>(acc, ak, a_row(k), smem_addr(wsm + slot * S::kTapElems + n0 * 8));
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();  // the other A buffer is free again, as after a tap
        }
        if (k > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((seq - 1) % S::kRing));
        ++seq;
      };
      for (int k = 0; k < 27; k += 2) {
        step(k, a[0]);
        if (k + 1 < 27) step(k + 1, a[1]);
      }
      acc_done<N>(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((seq - 1) % S::kRing));
      if (live) epi_store<CO, N>(acc, g * kGroup + warp, n0, lane, scale, shift, em, er, out, relu);
      team_sync<S::kSplit>(wg);  // every warp of the team is done with the halo
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

// allow `smem` bytes of dynamic shared memory to the kernel
template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// the kernel's shared memory allowed (opt_in_smem) first
template <typename T, typename K>
int launch(K kernel, int grid, int threads, size_t smem, const void* state, const void* tgt,
           const void* w, const void* scale, const void* shift, const void* mask,
           const void* resid, void* out, int t1p, int relu, cudaStream_t stream) {
  if (grid > 0)
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(state), static_cast<const int*>(tgt), static_cast<const T*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<const T*>(mask), static_cast<const T*>(resid), static_cast<T*>(out), t1p,
        relu);
  return static_cast<int>(cudaGetLastError());
}

// persistent blocks: as many as fit the SMs at once, at most one a unit of
// work (the occupancy query needs the kernel's shared memory allowed first)
template <int C, int CO>
int launch_wgmma(const void* state, const void* tgt, const void* w, const void* scale,
                 const void* shift, const void* mask, const void* resid, void* out, int t1p,
                 int relu, cudaStream_t stream) {
  using S = WgShape<C, CO>;
  auto kernel = plane_subm_wgmma<C, CO>;
  if (int e = opt_in_smem(kernel, S::kSmem)) return e;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::kThreads, S::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int units = (t1p / kGroup + S::kTeams - 1) / S::kTeams;
  const int grid = per_sm * sms < units ? per_sm * sms : units;
  return launch<__nv_bfloat16>(kernel, grid, S::kThreads, S::kSmem, state, tgt, w, scale, shift,
                               mask, resid, out, t1p, relu, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaGetLastError() code (0 = launched),
// -1 for a (C, Co) pair the kernel is not built for, -2 for a T1p that is
// not a whole number of plan blocks. dtype 0 = float32 state with w
// (27, C, Co); dtype 1 = bfloat16 state with w in wgmma's B layout
// (plane_kernel.wgmma_weights). resid may be null.
extern "C" int s2d_plane_subm(const void* state, const void* tgt, const void* w,
                              const void* scale, const void* shift, const void* mask,
                              const void* resid, void* out, int t1p, int c, int co,
                              int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t1p % kBlk != 0) return -2;
#define S2D_PLANE_CASE(CI, CO_)                                                            \
  if (c == CI && co == CO_) {                                                              \
    if (dtype == 1)                                                                        \
      return launch_wgmma<CI, CO_>(state, tgt, w, scale, shift, mask, resid, out, t1p,    \
                                   relu, s);                                               \
    using F = FmaShape<CI, CO_>;                                                           \
    if (int e = opt_in_smem(plane_subm_fma<CI, CO_>, F::kSmem)) return e;                  \
    return launch<float>(plane_subm_fma<CI, CO_>, t1p / F::kPlanes, kThreads, F::kSmem,    \
                         state, tgt, w, scale, shift, mask, resid, out, t1p, relu, s);     \
  }
  S2D_PLANE_CASE(16, 16)
  S2D_PLANE_CASE(32, 32)
  S2D_PLANE_CASE(64, 64)
  S2D_PLANE_CASE(128, 128)
#undef S2D_PLANE_CASE
  return -1;
}
